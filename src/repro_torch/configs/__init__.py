"""Architecture configs the port runs, by name (``get_arch``): the dense
and MoE LMs the serving path decodes, the four recommender archs it scores
and the GNN (EquiformerV2) it trains.  An arch of the reference that the
port lacks would raise, naming the ROADMAP item that ports it
(``NOT_YET_PORTED``; empty now).  Each arch module has ``SHAPES`` and
``build_cell(shape)``, the dry-run cell over meta tensors
(``launch.dryrun``); ``assigned_cells`` lists the reference's 40 assigned
(arch, shape) cells in its order."""
from __future__ import annotations

import importlib
from typing import List, Tuple

ARCHS = {"qwen2-1.5b": "qwen2_1_5b", "antglm-10b": "antglm_10b",
         "phi3-mini-3.8b": "phi3_mini_3_8b",
         "phi3-medium-14b": "phi3_medium_14b",
         "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
         "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
         "wide-deep": "wide_deep",
         "two-tower-retrieval": "two_tower_retrieval", "sasrec": "sasrec",
         "bert4rec": "bert4rec", "equiformer-v2": "equiformer_v2"}
NOT_YET_PORTED: dict = {}
# the reference's registry order (``repro.configs.ARCHS``), module names
SWEEP_ORDER = ["phi3_mini_3_8b", "qwen2_1_5b", "phi3_medium_14b",
               "qwen3_moe_30b_a3b", "moonshot_v1_16b_a3b", "equiformer_v2",
               "wide_deep", "bert4rec", "two_tower_retrieval", "sasrec",
               "antglm_10b"]      # the paper's own model, not an assigned cell


def get_arch(name: str):
    key = name.replace("_", "-")
    mod = ARCHS.get(key) or (name if name in ARCHS.values() else None)
    if mod is None:
        item = NOT_YET_PORTED.get(key)
        raise KeyError(f"arch {name!r} is not yet ported"
                       + (f" (ROADMAP {item})" if item else "")
                       + f"; have {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def assigned_cells() -> List[Tuple[str, str]]:
    """All 40 assigned (arch module, shape) cells, AntGLM-10B's apart."""
    return [(a, s) for a in SWEEP_ORDER if a != "antglm_10b"
            for s in get_arch(a).SHAPES]


__all__ = ["ARCHS", "SWEEP_ORDER", "get_arch", "assigned_cells"]
