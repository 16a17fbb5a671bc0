"""Roofline terms of a dry-run cell on one H100 (the counterpart of
``repro.launch.roofline``).

  compute    = Σ over dtypes of counted product FLOPs / peak FLOP/s(dtype)
  memory     = bytes_floor / HBM bandwidth where the cell's meta has a
               floor, else the raw (unfused) bytes the trace counted
  collective = 0: one card moves nothing between cards

The count comes from ``launch.dryrun``'s meta trace, which runs every
iteration of the port's Python loops (query chunks, edge chunks, remat's
recompute): the reference's ``flops_correction`` / ``bytes_correction``,
which make up for XLA counting a ``lax.scan`` body once, stay in the meta
for parity and are not added here.  ``parse_collectives`` has nothing to
parse until the multi-GPU slice (ROADMAP A16).
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, peak_flops

_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def roofline(cost: Dict, n_chips: int = 1,
             meta: Optional[Dict] = None) -> Dict:
    """The three terms (seconds), the bottleneck and the model-flops
    ratio, with the reference's fields.  ``cost`` holds ``flops_by_dtype``
    (``{"bfloat16": ..., "float32": ...}``; a bare ``flops`` counts as
    bf16) and ``bytes accessed``, per chip."""
    by_dtype = dict(cost.get("flops_by_dtype")
                    or {"bfloat16": float(cost.get("flops", 0.0))})
    flops = float(sum(by_dtype.values()))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    t_compute = sum(f / peak_flops(dt) for dt, f in by_dtype.items())
    t_memory = bytes_acc / HBM_BW
    floor_bytes = float(meta.get("bytes_floor", 0.0)) / n_chips if meta \
        else 0.0
    t_mem_floor = floor_bytes / HBM_BW if floor_bytes else t_memory
    terms = {"compute_s": t_compute, "memory_s": t_mem_floor,
             "collective_s": 0.0}
    bottleneck = max(terms, key=terms.get)
    out = {
        **terms,
        "memory_raw_s": t_memory,
        "bottleneck": bottleneck.replace("_s", ""),
        "hlo_flops_per_chip": flops,
        "flops_by_dtype": by_dtype,
        "hlo_bytes_per_chip": bytes_acc,
        "floor_bytes_per_chip": floor_bytes,
        "collective_bytes_per_chip": 0.0,
        "collective_by_kind": {k: 0.0 for k in _COLL_KINDS},
        "n_chips": n_chips,
    }
    if meta and meta.get("step_output_bytes"):
        out["step_output_bytes"] = float(meta["step_output_bytes"])
    if meta and meta.get("model_flops"):
        model_flops_per_chip = meta["model_flops"] / n_chips
        out["model_flops_total"] = meta["model_flops"]
        out["useful_flops_ratio"] = model_flops_per_chip / max(flops, 1.0)
        # useful work at the bf16 peak against the dominant term's time
        t_star = max(terms.values())
        out["roofline_fraction"] = (model_flops_per_chip / PEAK_FLOPS_BF16
                                    ) / max(t_star, 1e-12)
    return out


def bound_seconds(rf: Dict) -> float:
    """The least time the card could take for a cell: the compute term,
    or the HBM floor's time where the meta has a floor (a cell without
    one, such as Two-Tower's, is held on its compute alone)."""
    floor = rf["floor_bytes_per_chip"] / HBM_BW
    return max(rf["compute_s"], floor)


__all__ = ["roofline", "bound_seconds"]
