"""Hand-written CUDA kernels for Hopper (``sm_90a``), one package per
Pallas kernel of ``repro.kernels`` (the serving path's and the recsys
scoring path's), plus the Gumbel-argmax token choice.  Each package holds
the CUDA source (``csrc/``), the wrapper (``ops.py``) and the plain PyTorch
version (``ref.py``); ``_build.py`` compiles the sources with ``nvcc`` at
first use.

The launch counters.  Each wrapper adds one to a plain integer attribute of
its function where it launches its kernel, so a run can show that a path
went through the kernel.  A replayed CUDA graph runs no Python, so the
session's graph cache takes a ``snapshot`` before and after a capture,
puts the counters back (nothing ran), and ``add``s the captured ``diff`` on
every replay: the counters then read what actually ran on the card.
"""
from __future__ import annotations

import importlib
from typing import Dict, Mapping, Tuple

# counter name -> (module, function, attribute) of the wrapper holding it
COUNTERS: Dict[str, Tuple[str, str, str]] = {
    "tree_attention": ("tree_attention.ops", "tree_attention", "launches"),
    "paged_tree_attention": ("tree_attention.paged", "paged_tree_attention",
                             "launches"),
    "flash_prefill": ("flash_prefill.ops", "flash_prefill", "launches"),
    "flash_prefill_tri": ("flash_prefill.ops", "flash_prefill",
                          "tri_launches"),
    "gumbel_argmax": ("gumbel_argmax.ops", "gumbel_argmax", "launches"),
    "embedding_bag": ("embedding_bag.ops", "embedding_bag_fused", "launches"),
}


def _holder(name: str):
    module, fn, attr = COUNTERS[name]
    return getattr(importlib.import_module(f"{__name__}.{module}"), fn), attr


def snapshot() -> Dict[str, int]:
    """Every kernel's launch count now."""
    out = {}
    for name in COUNTERS:
        fn, attr = _holder(name)
        out[name] = getattr(fn, attr)
    return out


def diff(after: Mapping[str, int], before: Mapping[str, int]
         ) -> Dict[str, int]:
    """The launches between two snapshots, kernels that launched only."""
    return {n: after[n] - before[n] for n in after
            if after[n] != before[n]}


def add(launches: Mapping[str, int], times: int = 1) -> None:
    """Add ``times`` x ``launches`` (a ``diff``) to the counters; a negative
    ``times`` takes them back."""
    for name, n in launches.items():
        fn, attr = _holder(name)
        setattr(fn, attr, getattr(fn, attr) + times * n)


__all__ = ["COUNTERS", "snapshot", "diff", "add"]
