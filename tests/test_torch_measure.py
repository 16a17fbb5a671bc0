"""The measuring helpers of the port's on-card checks, on the CPU: the
distinct-sector count behind B5's second bound (``chip_smoke.py``) and the
package swap with which ``compare_builds`` runs another checkout's Wide &
Deep forward beside this one's in one process.
"""
import importlib.util
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import wide_deep as wd_config
from repro_torch.kernels import compare_builds as cb
from repro_torch.models.recsys import wide_deep as my_wd
from repro_torch.training import data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.torch_port


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("D,dtype", [(1, torch.float32), (3, torch.float32),
                                     (32, torch.float32),
                                     (8, torch.bfloat16),
                                     (5, torch.bfloat16)])
def test_distinct_sectors_counts_each_sector_once(D, dtype):
    """The count equals the set of 32-byte sectors the rows touch, on a
    view whose storage starts off a sector's edge."""
    distinct_sectors = _chip_smoke().distinct_sectors
    t = torch.zeros(2000 * D + 3, dtype=dtype)[3:].view(2000, D)
    rows = torch.unique(torch.from_numpy(
        np.random.RandomState(D).randint(0, 2000, 700)))
    row_bytes = D * t.element_size()
    want = set()
    for r in rows.tolist():
        start = t.data_ptr() + r * row_bytes
        want.update(range(start // 32, (start + row_bytes - 1) // 32 + 1))
    assert distinct_sectors(t, rows) == len(want)


def test_other_checkouts_package_runs_beside_this_one(tmp_path):
    """Another checkout's package imports under the same name without
    displacing this one's, runs only inside ``package``, and gives the same
    logits from the same code."""
    shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                    tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    mine = cb._package()
    other = cb.other_package(str(tmp_path))
    assert cb._package() == mine
    wd = other["repro_torch.models.recsys.wide_deep"]
    assert wd.__file__.startswith(str(tmp_path))
    assert wd is not my_wd

    cfg = wd_config.smoke_config()
    params = wd_config.model.init_params(cfg, seed=0, device="cpu")
    b = data.wide_deep_batch(np.random.RandomState(0), 16, cfg.n_sparse,
                             cfg.rows_per_table, cfg.multi_hot, cfg.n_dense)
    x = tuple(torch.from_numpy(b[k]) for k in
              ("sparse_ids", "sparse_mask", "dense"))
    with cb.package(other):
        assert sys.modules["repro_torch"].__file__.startswith(str(tmp_path))
        got = wd.forward(cfg, params, *x)
    assert cb._package() == mine
    assert cb.same_bits(got, my_wd.forward(cfg, params, *x))
