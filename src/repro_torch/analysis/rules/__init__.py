"""Repo-specific lint rules over the serving engine's invariants — the
PyTorch port's registry, with the reference's rule ids
(``repro.analysis.rules``), so one suppression comment serves both
linters.

Each rule is a class with a ``rule_id``, a one-line ``title``, and
``check(tree, path) -> List[Finding]``.  Rules are pure AST walks — no
imports of the linted code, no execution — so the linter runs on a bare
stdlib interpreter.

    R1  sync discipline: inside classes that define a ``_pull`` choke
        point (and modules that define a ``_host`` one), every
        device->host transfer of a step result goes through it, and
        nothing calls ``synchronize()`` (the torch pull forms)
    R3  refcount API pairing: share/cache_ref acquires need a reachable
        free/cache_unref in the same class, and free()/cache_unref()
        results must never be dropped (only refcount-zero ids may be
        scrubbed or re-allocated)
    R4  recapture hazards: no argument whose shape follows a Python value
        (``len(...)``, a variable slice) flows into a captured member
        (a ``_Member``/``member(...)`` name or a ``fns.<StepFns field>``
        call) — pad into a fixed bucket first
    R6  warm-state pairing: every ``state_dict`` has a matching
        ``load_state_dict`` on the same class (and vice versa) — the
        fleet persistence round-trip contract

The reference's R2 (jit argnums) and R5 (donation masks) have no torch
counterpart: the port has no ``jax.jit`` and donates nothing (its step
functions update the cache in place).
"""
from __future__ import annotations

import ast
import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint violation, formatted ``path:line:col: Rn message``."""
    path: str
    line: int
    col: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}"


class Rule:
    """Base class: subclasses set ``rule_id``/``title`` and implement
    ``check``."""

    rule_id: str = ""
    title: str = ""

    def check(self, tree: ast.AST, path: str) -> List[Finding]:
        raise NotImplementedError

    def finding(self, path: str, node: ast.AST, message: str) -> Finding:
        return Finding(path=path, line=getattr(node, "lineno", 0),
                       col=getattr(node, "col_offset", 0),
                       rule=self.rule_id, message=message)


# ------------------------------------------------------------- AST helpers
def dotted_name(node: ast.AST) -> Optional[str]:
    """``np.asarray`` for a Name/Attribute chain, None for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.AST) -> Optional[str]:
    """Dotted callee name of a Call node (None for computed callees)."""
    if isinstance(node, ast.Call):
        return dotted_name(node.func)
    return None


def function_defs(node: ast.AST):
    """Immediate FunctionDef/AsyncFunctionDef children of a body-carrier."""
    for child in getattr(node, "body", []):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield child


def all_rules() -> List[Rule]:
    """Instantiate the full registry in rule-id order."""
    from repro_torch.analysis.rules.refcounts import RefcountPairingRule
    from repro_torch.analysis.rules.retrace import RecaptureHazardRule
    from repro_torch.analysis.rules.state_pairing import StatePairingRule
    from repro_torch.analysis.rules.sync_discipline import \
        SyncDisciplineRule
    return [SyncDisciplineRule(), RefcountPairingRule(),
            RecaptureHazardRule(), StatePairingRule()]


__all__ = ["Finding", "Rule", "all_rules", "dotted_name", "call_name",
           "function_defs"]
