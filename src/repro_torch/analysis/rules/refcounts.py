"""R3 — refcount API pairing (DESIGN.md §Paged KV ownership); the port's
copy of the reference's rule, framework-free.

The ``BlockAllocator`` hands out *shared* ownership: ``share()`` and
``cache_ref()`` bump per-block refcounts, and the matching ``free()`` /
``cache_unref()`` drop them.  Two classes of rot this rule catches:

* **Unpaired acquire** — a class that calls ``share``/``cache_ref`` but
  has no reachable ``free``/``cache_unref`` anywhere in the same class
  leaks blocks by construction (refcounts only ever go up).

* **Dropped release result** — ``free()`` and ``cache_unref()`` return
  the ids whose refcount actually hit zero; only *those* may be scrubbed
  or handed back to the pool.  A bare ``self.alloc.free(ids)`` statement
  throws that list away, which is exactly the shape of the
  cancel-of-pending use-after-free (blocks freed and re-allocated while
  a dispatch was still in flight, because nobody tracked which ids had
  truly quiesced).

Suppress a justified exception with ``# repro-lint: disable=R3``.
"""
from __future__ import annotations

import ast
from typing import Dict, List

from repro_torch.analysis.rules import Rule

ACQUIRE_TO_RELEASE = {"share": "free", "cache_ref": "cache_unref"}
RELEASE_METHODS = frozenset(ACQUIRE_TO_RELEASE.values())


def _attr_calls(node: ast.AST):
    """Yield (method_name, Call) for every attribute call in ``node``."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and \
                isinstance(sub.func, ast.Attribute):
            yield sub.func.attr, sub


class RefcountPairingRule(Rule):
    rule_id = "R3"
    title = ("share/cache_ref acquires pair with free/cache_unref in the "
             "same class; release results are never dropped")

    def check(self, tree: ast.AST, path: str) -> List:
        findings: List = []
        for cls in (n for n in ast.walk(tree)
                    if isinstance(n, ast.ClassDef)):
            # skip the allocator itself: it *defines* these methods
            defined = {m.name for m in cls.body
                       if isinstance(m, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}
            if RELEASE_METHODS & defined:
                continue

            called: Dict[str, ast.Call] = {}
            for name, call in _attr_calls(cls):
                called.setdefault(name, call)

            for acquire, release in ACQUIRE_TO_RELEASE.items():
                if acquire in called and release not in called:
                    findings.append(self.finding(
                        path, called[acquire],
                        f"{acquire}() acquires block refs but class "
                        f"{cls.name!r} has no reachable {release}(); "
                        "refcounts can only ever go up"))

            # dropped release results: a bare-expression statement whose
            # value is free()/cache_unref() discards the refcount-zero ids
            for sub in ast.walk(cls):
                if isinstance(sub, ast.Expr) and \
                        isinstance(sub.value, ast.Call) and \
                        isinstance(sub.value.func, ast.Attribute) and \
                        sub.value.func.attr in RELEASE_METHODS:
                    meth = sub.value.func.attr
                    findings.append(self.finding(
                        path, sub.value,
                        f"result of {meth}() dropped on the floor; it "
                        "returns the refcount-zero ids that must be "
                        "scrubbed before re-allocation"))
        return findings


__all__ = ["RefcountPairingRule"]
