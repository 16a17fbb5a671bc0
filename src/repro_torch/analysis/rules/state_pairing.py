"""R6 — state_dict/load_state_dict pairing (DESIGN.md §Fleet serving); the
port's copy of the reference's rule, framework-free.

Warm-state persistence (repro_torch.fleet) round-trips every stateful component
through ``state_dict()`` / ``load_state_dict()``.  A class that grows one
half of the pair silently breaks the fleet contract:

* ``state_dict`` without ``load_state_dict`` — the component's warmth can
  be saved but a restarted replica can never take it back: the donor's
  statistics rot in the file.
* ``load_state_dict`` without ``state_dict`` — the component can consume
  foreign state but never donate its own, so gossip and warm restarts
  walk past it and a "fully saved" file quietly omits it.

Both methods must be defined on the SAME class (inheriting one half does
not pair it — the serialized shape is the defining class's business).
Suppress a justified exception with ``# repro-lint: disable=R6``.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.rules import Rule

PAIR = ("state_dict", "load_state_dict")


class StatePairingRule(Rule):
    rule_id = "R6"
    title = ("every state_dict() pairs with a load_state_dict() on the "
             "same class (warm-state round-trip contract)")

    def check(self, tree: ast.AST, path: str) -> List:
        findings: List = []
        for cls in (n for n in ast.walk(tree)
                    if isinstance(n, ast.ClassDef)):
            defs = {m.name: m for m in cls.body
                    if isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))}
            save, load = PAIR
            if save in defs and load not in defs:
                findings.append(self.finding(
                    path, defs[save],
                    f"class {cls.name!r} defines {save}() without "
                    f"{load}(); persisted state could never be restored"))
            elif load in defs and save not in defs:
                findings.append(self.finding(
                    path, defs[load],
                    f"class {cls.name!r} defines {load}() without "
                    f"{save}(); the component consumes warm state but "
                    "never donates its own"))
        return findings


__all__ = ["StatePairingRule"]
