"""R4 — recapture hazards (the port's counterpart of the reference's
retrace rule, ``repro.analysis.rules.retrace``).

On the card every session member is a captured CUDA graph, one per input
signature (the inputs' shapes and dtypes and the cache), and a member
keeps at most ``MAX_GRAPHS`` of them (``serving/session.py::_Member``).  An
input whose shape follows a Python value adds a signature on every new
value: the member captures again (tens of ms a capture) and evicts a graph
it will need.  The defence is the reference's bucket ladder: pad
variable-length host data into one of a fixed set of buckets *before* it
reaches a member, so the set of shapes is closed.

Captured callables are

* names a module binds to a member: ``x = _Member(...)`` or the session's
  ``x = member(...)`` helper, and
* the ``StepFns`` fields that hold members, called through an attribute
  chain ending in ``fns`` (``fns.fused_step(...)``,
  ``self.fns.prefill(...)``): that is how the scheduler and the engine
  reach them.  ``prefill_suffix`` is not one: it is the padding layer that
  rounds a suffix up to its bucket before its member runs, as the
  reference's wrapper of the same name is.

A call to one of them is flagged where an argument is an array
constructor (numpy's, or ``torch.tensor``/``as_tensor``/``from_numpy``/
``zeros``/``ones``/``full``/``empty``) whose payload holds ``len(...)`` or
a variable-bound slice (``toks[n_cached:]``), or is such a slice itself.
Constant slices (``x[:, :4]``) are fine.

A member that pads such an input itself, in its ``stage``, presents a
bucket shape all the same: suppress its call with
``# repro-lint: disable=R4`` and the reason.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from repro_torch.analysis.rules import Rule, call_name, dotted_name

ARRAY_CONSTRUCTORS = frozenset({
    "np.asarray", "np.array", "np.zeros", "np.ones", "np.full",
    "np.empty", "numpy.asarray", "numpy.array", "numpy.zeros",
    "numpy.ones", "numpy.full", "numpy.empty",
    "torch.tensor", "torch.as_tensor", "torch.from_numpy", "torch.zeros",
    "torch.ones", "torch.full", "torch.empty",
})
MEMBER_CONSTRUCTORS = frozenset({"_Member", "member"})
# the StepFns fields that hold captured members (core/request.py)
STEP_MEMBERS = frozenset({
    "prefill", "tree_step", "commit", "fused_step", "init_cache",
    "prefill_into_slot", "reset_slot", "reset_blocks", "copy_block",
})


def _dynamic_slice(node: ast.Slice) -> bool:
    """Slice whose bound is a runtime Python value (not None/constant)."""
    for bound in (node.lower, node.upper):
        if bound is None or isinstance(bound, ast.Constant):
            continue
        if isinstance(bound, ast.UnaryOp) and \
                isinstance(bound.operand, ast.Constant):
            continue               # x[:-1] — static extent
        return True
    return False


def _dynamic_extent(node: ast.AST) -> bool:
    """Expression whose resulting array extent depends on a Python value:
    contains ``len(...)`` or a variable-bound slice."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and call_name(sub) == "len":
            return True
        if isinstance(sub, ast.Slice) and _dynamic_slice(sub):
            return True
    return False


def _collect_member_names(tree: ast.AST) -> Set[str]:
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and \
                call_name(node.value) in MEMBER_CONSTRUCTORS:
            for t in node.targets:
                n = dotted_name(t)
                if n:
                    names.add(n)
    return names


def _captured_callee(node: ast.Call, members: Set[str]) -> Optional[str]:
    """The callee's name when it is a captured member, else None."""
    callee = call_name(node)
    if callee in members:
        return callee
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in STEP_MEMBERS:
        recv = dotted_name(f.value)
        if recv and recv.split(".")[-1] == "fns":
            return callee
    return None


class RecaptureHazardRule(Rule):
    rule_id = "R4"
    title = ("no Python-value-dependent shapes into captured members — "
             "pad into a fixed bucket first")

    def check(self, tree: ast.AST, path: str) -> List:
        members = _collect_member_names(tree)
        findings: List = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            callee = _captured_callee(node, members)
            if callee is None:
                continue
            for arg in list(node.args) + [kw.value for kw in
                                          node.keywords]:
                hazard = False
                for sub in ast.walk(arg):
                    if isinstance(sub, ast.Call) and \
                            call_name(sub) in ARRAY_CONSTRUCTORS and \
                            any(_dynamic_extent(a) for a in sub.args):
                        hazard = True
                        break
                    if isinstance(sub, ast.Subscript) and \
                            isinstance(sub.slice, ast.Slice) and \
                            _dynamic_slice(sub.slice):
                        hazard = True
                        break
                if hazard:
                    findings.append(self.finding(
                        path, arg,
                        f"argument to captured member {callee!r} has a "
                        "Python-value-dependent shape (a new graph per "
                        "distinct length); pad into a fixed bucket "
                        "before the call"))
        return findings


__all__ = ["RecaptureHazardRule", "ARRAY_CONSTRUCTORS", "STEP_MEMBERS"]
