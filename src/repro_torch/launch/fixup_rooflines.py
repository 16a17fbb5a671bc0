"""Recompute the roofline terms of existing dry-run records after a change
to the metric model (floors, peaks, link rates) — from the stored counts,
a mesh leg's stored collectives and a fresh meta, with no retrace (the
counterpart of ``repro.launch.fixup_rooflines``).

    PYTHONPATH=src python -m repro_torch.launch.fixup_rooflines build/dryrun_results.json
"""
from __future__ import annotations

import json
import sys
from typing import Dict

from repro_torch import configs as cfgreg
from repro_torch.launch.dryrun import record_roofline


def fixup(results: Dict) -> Dict:
    """Refresh every ``ok`` record's ``meta`` and ``roofline`` in place."""
    metas = {}
    for rec in results.values():
        if not rec.get("ok"):
            continue
        mk = (rec["arch"], rec["shape"])
        if mk not in metas:
            metas[mk] = cfgreg.get_arch(mk[0]).build_cell(mk[1]).meta
        rec["meta"] = metas[mk]
        rec["roofline"] = record_roofline(rec, rec["meta"])
    return results


def main(path: str) -> None:
    with open(path) as f:
        results = json.load(f)
    fixup(results)
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"fixed {len(results)} records")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "dryrun_results.json")
