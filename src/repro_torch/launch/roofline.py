"""Roofline terms of a dry-run cell on H100s (the counterpart of
``repro.launch.roofline``), per card.

  compute    = Σ over dtypes of counted product FLOPs / peak FLOP/s(dtype)
  memory     = bytes_floor / HBM bandwidth where the cell's meta has a
               floor, else the raw (unfused) bytes the trace counted
  collective = Σ over the rank's collective groups of its ring traffic
               (``distributed.sharding.ring_traffic``, the reference's
               formulas) / the group's link rate (``launch.mesh.link_rate``:
               NVLink inside a node, the network across nodes); 0 on one
               card, which moves nothing between cards

The count comes from ``launch.dryrun``'s meta trace, which runs every
iteration of the port's Python loops (query chunks, edge chunks, remat's
recompute): the reference's ``flops_correction`` / ``bytes_correction``,
which make up for XLA counting a ``lax.scan`` body once, stay in the meta
for parity and are not added here.  The collectives are not parsed from a
program text, as the reference's are: a traced rank's ``TracedMesh``
records each call it would hand its backend (``collective_records``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.distributed.sharding import ring_bytes, ring_traffic
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16, link_rate,
                                     peak_flops)


def collective_seconds(records: Sequence[Dict]
                       ) -> Tuple[float, Dict[str, float], List[Dict]]:
    """(seconds, bytes by kind, one entry a group) of a rank's collective
    records: each record's ring traffic over its group's link rate."""
    _, per_kind = ring_bytes(records)
    groups: Dict[Tuple[int, ...], Dict] = {}
    for r in records:
        g = groups.setdefault(tuple(r["ranks"]), {
            "group": r["group"], "bytes": 0.0,
            "rate": link_rate(r["ranks"])})
        g["bytes"] += ring_traffic(r["kind"], r["group"], r["bytes"])
    for g in groups.values():
        g["seconds"] = g["bytes"] / g["rate"]
    return (sum((g["seconds"] for g in groups.values()), 0.0), per_kind,
            list(groups.values()))


def roofline(cost: Dict, n_chips: int = 1, meta: Optional[Dict] = None,
             collectives: Sequence[Dict] = ()) -> Dict:
    """The three terms (seconds), the bottleneck and the model-flops
    ratio, with the reference's fields.  ``cost`` holds ``flops_by_dtype``
    (``{"bfloat16": ..., "float32": ...}``; a bare ``flops`` counts as
    bf16) and ``bytes accessed``, per chip; ``collectives`` the traced
    rank's ``collective_records`` (none on one card)."""
    by_dtype = dict(cost.get("flops_by_dtype")
                    or {"bfloat16": float(cost.get("flops", 0.0))})
    flops = float(sum(by_dtype.values()))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    t_compute = sum(f / peak_flops(dt) for dt, f in by_dtype.items())
    t_memory = bytes_acc / HBM_BW
    floor_bytes = float(meta.get("bytes_floor", 0.0)) / n_chips if meta \
        else 0.0
    t_mem_floor = floor_bytes / HBM_BW if floor_bytes else t_memory
    t_coll, per_kind, groups = collective_seconds(collectives)
    terms = {"compute_s": t_compute, "memory_s": t_mem_floor,
             "collective_s": t_coll}
    bottleneck = max(terms, key=terms.get)
    out = {
        **terms,
        "memory_raw_s": t_memory,
        "bottleneck": bottleneck.replace("_s", ""),
        "hlo_flops_per_chip": flops,
        "flops_by_dtype": by_dtype,
        "hlo_bytes_per_chip": bytes_acc,
        "floor_bytes_per_chip": floor_bytes,
        "collective_bytes_per_chip": sum(per_kind.values()),
        "collective_by_kind": per_kind,
        "collective_groups": groups,
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
    """The least time a card could take for a cell: the largest of the
    compute term, the HBM floor's time where the meta has a floor (a cell
    without one, such as Two-Tower's, is held on its compute alone) and
    the collective term (0 on one card)."""
    floor = rf["floor_bytes_per_chip"] / HBM_BW
    return max(rf["compute_s"], floor, rf.get("collective_s", 0.0))


__all__ = ["roofline", "bound_seconds", "collective_seconds"]
