"""Render the dry-run's memory and roofline tables from its results file
(the counterpart of ``repro.launch.report``): the one-card leg's, then
each mesh leg's (per rank, with the collective term; the cells the port
does not place yet listed apart, with the axes they leave whole).

    PYTHONPATH=src python -m repro_torch.launch.report build/dryrun_results.json
"""
from __future__ import annotations

import json
import sys
from typing import Dict

from repro_torch.launch.dryrun import MESH, MESHES
from repro_torch.launch.roofline import bound_seconds


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}µs"
    if x < 1:
        return f"{x*1e3:.2f}ms"
    return f"{x:.2f}s"


def fmt_b(x: float) -> str:
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("kB", 1e3)):
        if x >= div:
            return f"{x/div:.2f}{unit}"
    return f"{x:.0f}B"


def render(results: Dict) -> str:
    cells = {k: v for k, v in results.items() if v.get("mesh") == MESH}
    out = ["### Dry-run summary\n"]
    n_ok = sum(1 for v in cells.values() if v.get("ok"))
    n_fit = sum(1 for v in cells.values() if v.get("ok") and v["fits_80gb"])
    out.append(f"- {MESH} (one card, 80 GB): **{n_ok}/{len(cells)}** cells "
               f"traced OK, **{n_fit}** fit\n")
    fails = [(k, v.get("error", "")) for k, v in cells.items()
             if not v.get("ok")]
    if fails:
        out.append("Failures:")
        for k, e in fails:
            out.append(f"- `{k}`: {e[:160]}")
        out.append("")

    out.append(f"\n#### Per-cell memory ({MESH}; meta trace, live storages)\n")
    out.append("| arch | shape | peak | fits 80GB | args | out |")
    out.append("|---|---|---:|:--:|---:|---:|")
    for v in cells.values():
        if not v.get("ok"):
            continue
        m = v["memory"]
        out.append(
            f"| {v['arch']} | {v['shape']} | "
            f"{fmt_b(m['peak_memory_in_bytes'])} | "
            f"{'✓' if v['fits_80gb'] else '✗'} | "
            f"{fmt_b(m['argument_size_in_bytes'])} | "
            f"{fmt_b(m['output_size_in_bytes'])} |")

    out.append(f"\n### Roofline ({MESH}; per step)\n")
    out.append("| arch | shape | compute | memory(floor) | memory(raw*) | "
               "collective | step-out† | bottleneck | bound | "
               "useful-flops ratio | roofline frac |")
    out.append("|---|---|---:|---:|---:|---:|---:|---|---:|---:|---:|")
    for v in cells.values():
        if not v.get("ok"):
            continue
        r = v["roofline"]
        ufr = r.get("useful_flops_ratio")
        rff = r.get("roofline_fraction")
        sob = r.get("step_output_bytes")
        out.append(
            f"| {v['arch']} | {v['shape']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r.get('memory_raw_s', 0))} | "
            f"{fmt_s(r['collective_s'])} | "
            f"{'' if sob is None else fmt_b(sob)} | "
            f"{r['bottleneck']} | {fmt_s(bound_seconds(r))} | "
            f"{'' if ufr is None else f'{ufr:.3f}'} | "
            f"{'' if rff is None else f'{rff:.4f}'} |")
    out.append("\n* raw: every op's inputs and outputs, unfused.  † bytes "
               "handed back per step: decode cells the fused step's packed "
               "(B,1+2T) accept array.  bound: max(compute, floor) (compute "
               "alone without a floor).")
    for mesh in MESHES:
        legs = {k: v for k, v in results.items() if v.get("mesh") == mesh}
        if legs:
            out.append(render_mesh(mesh, legs))
    return "\n".join(out)


def render_mesh(mesh: str, cells: Dict) -> str:
    """A mesh leg's tables: per rank, the counts of one traced rank."""
    ok = [v for v in cells.values() if v.get("ok")]
    n = ok[0]["n_chips"] if ok else 0
    out = [f"\n### Mesh {mesh} ({n} ranks; one traced rank's counts, not "
           "times)\n",
           f"- **{len(ok)}/{len(cells)}** cells traced OK, all placed: "
           f"{sum(v['fits_80gb'] for v in ok)} of them fit 80 GB a rank"]
    fails = [(k, v.get("error", "")) for k, v in cells.items()
             if not v.get("ok")]
    for k, e in fails:
        out.append(f"- `{k}`: {e[:160]}")
    out.append(f"\n#### Cells ({mesh}, per rank)\n")
    out.append("| arch | shape | rank | peak | fits 80GB | args | "
               "collective | all-reduce | all-gather | all-to-all | "
               "compute | memory(floor) | collective_s | bottleneck | "
               "bound |")
    out.append("|---|---|---:|---:|:--:|---:|---:|---:|---:|---:|---:|---:|"
               "---:|---|---:|")
    for v in ok:
        m, r = v["memory"], v["roofline"]
        kind = r["collective_by_kind"]
        out.append(
            f"| {v['arch']} | {v['shape']} | {v.get('rank', 0)} | "
            f"{fmt_b(m['peak_memory_in_bytes'])} | "
            f"{'✓' if v['fits_80gb'] else '✗'} | "
            f"{fmt_b(m['argument_size_in_bytes'])} | "
            f"{fmt_b(r['collective_bytes_per_chip'])} | "
            f"{fmt_b(kind['all-reduce'])} | {fmt_b(kind['all-gather'])} | "
            f"{fmt_b(kind['all-to-all'])} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | "
            f"{r['bottleneck']} | {fmt_s(bound_seconds(r))} |")
    out.append("\ncollective: the rank's ring traffic (the reference's "
               "formulas), priced at NVLink's rate for a group inside one "
               "node of 8 ranks and at the network's for any other "
               "(launch/mesh.py).  memory(floor): the cell's floor over "
               "the mesh's ranks, as the reference divides it.")
    return "\n".join(out)


if __name__ == "__main__":
    path = sys.argv[1] if len(sys.argv) > 1 else "dryrun_results.json"
    with open(path) as f:
        print(render(json.load(f)))
