"""R1 — sync discipline on torch (DESIGN.md §Step pipeline): the port's
counterpart of the reference's device-pull rule
(``repro.analysis.rules.device_pulls``), which knows only the JAX pull
forms.

The fused decode path makes exactly ONE device->host transfer per step, and
it goes through the scheduler's ``_pull()`` choke point so tests can count
it.  A raw ``.item()``/``.cpu()``/``int()`` on a step result anywhere else
in the loop silently adds a hidden sync.

The rule activates inside any class that defines a ``_pull`` method, and in
any module that defines a module-level ``_host`` function (the lock-step
loop's choke point in ``repro_torch.core.engine``).  Per function it tracks
which local names hold *device values*: results of calls to the
``StepFns`` members (``prefill``, ``tree_step``, ``fused_step``, ...), and
anything derived from them.  A name laundered through ``_pull(...)`` or
``_host(...)`` becomes a host value again.  Flagged on device values
outside the choke points themselves:

  * ``x.item()`` / ``x.tolist()`` / ``x.cpu()`` / ``x.numpy()`` /
    ``x.to("cpu")``
  * ``np.asarray(x)`` / ``np.array(x)``
  * ``int(x)`` / ``float(x)`` / ``bool(x)``
  * ``torch.cuda.synchronize()`` and ``.synchronize()`` on a stream or an
    event (flagged whatever the receiver — always a sync, as
    ``block_until_ready`` is in the reference's rule)

Suppress a justified exception with ``# repro-lint: disable=R1`` (one
comment serves both packages' linters).
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from repro_torch.analysis.rules import (Rule, call_name, dotted_name,
                                        function_defs)

# the StepFns members whose results live on the device
DEVICE_PRODUCERS = frozenset({
    "prefill", "prefill_into_slot", "prefill_suffix", "tree_step",
    "fused_step", "commit", "copy_block", "reset_blocks", "reset_slot",
    "init_cache",
})
CHOKE_POINTS = frozenset({"_pull", "_host"})
PULL_CALLS = frozenset({"np.asarray", "np.array", "numpy.asarray",
                        "numpy.array"})
SCALAR_CASTS = frozenset({"int", "float", "bool"})
SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})


def _is_device_call(node: ast.AST) -> bool:
    """Call whose callee is a StepFns member (``fns.fused_step(...)``,
    ``self.fns.prefill(...)``)."""
    return isinstance(node, ast.Call) and \
        isinstance(node.func, ast.Attribute) and \
        node.func.attr in DEVICE_PRODUCERS


def _is_pull_call(node: ast.AST) -> bool:
    """A call through a choke point (``_pull`` or ``_host``)."""
    name = call_name(node)
    return bool(name) and name.split(".")[-1] in CHOKE_POINTS


def _root(node: ast.AST) -> Optional[str]:
    """Dotted root a value expression reads from: ``packed[l, 0]`` ->
    ``packed``; ``self.cache["k"]`` -> ``self.cache``."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return dotted_name(node)


def _is_cpu(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return isinstance(node, ast.Call) and \
        call_name(node) in ("torch.device", "device") and \
        bool(node.args) and _is_cpu(node.args[0])


def _to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` / ``x.to(torch.device(
    "cpu"))``."""
    return call.func.attr == "to" and (
        any(_is_cpu(a) for a in call.args[:1])
        or any(k.arg == "device" and _is_cpu(k.value)
               for k in call.keywords))


class _Scanner:
    """Order-sensitive scan of one function body, tracking device names."""

    def __init__(self, rule: "SyncDisciplineRule", path: str):
        self.rule = rule
        self.path = path
        self.device: Set[str] = set()
        self.findings: List = []

    # -------------------------------------------------------------- taint
    def _tainted(self, node: ast.AST) -> bool:
        """Expression reads a device value (or IS a device call)."""
        for sub in ast.walk(node):
            if _is_device_call(sub):
                return True
            name = dotted_name(sub) if isinstance(
                sub, (ast.Name, ast.Attribute)) else None
            if name in self.device:
                return True
        return False

    def _bind(self, targets, value: ast.AST) -> None:
        names = []
        for t in targets:
            if isinstance(t, (ast.Tuple, ast.List)):
                names.extend(n for n in map(dotted_name, t.elts) if n)
            else:
                n = dotted_name(t)
                if n:
                    names.append(n)
        tainted = not _is_pull_call(value) and self._tainted(value)
        for n in names:
            if tainted:
                self.device.add(n)
            else:
                self.device.discard(n)

    # --------------------------------------------------------- violations
    def _flag(self, node: ast.AST, message: str) -> None:
        self.findings.append(self.rule.finding(self.path, node, message))

    def _check_expr(self, node: ast.AST) -> None:
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call) or _is_pull_call(sub):
                continue
            name = call_name(sub)
            attr = sub.func.attr if isinstance(sub.func, ast.Attribute) \
                else None
            if attr == "synchronize":
                self._flag(sub, f"{name or '.synchronize'}() makes the "
                                "host wait for the card; route the "
                                "transfer through the _pull() choke point")
                continue
            on_device = attr is not None and (
                _root(sub.func.value) in self.device
                or _is_device_call(sub.func.value))
            args_tainted = any(_root(a) in self.device or _is_device_call(a)
                               for a in sub.args)
            if name in PULL_CALLS and args_tainted:
                self._flag(sub, f"raw device pull {name}() on a step result "
                                "outside _pull(); route it through the "
                                "choke point (or # repro-lint: disable=R1 "
                                "with a justification)")
            elif name in SCALAR_CASTS and args_tainted:
                self._flag(sub, f"{name}() on a step result forces a hidden "
                                "device sync; pull through _pull() first")
            elif on_device and (attr in SYNC_METHODS or _to_cpu(sub)):
                self._flag(sub, f".{attr}() on a step result is a hidden "
                                "device sync; pull through _pull() first")

    # -------------------------------------------------------------- drive
    def scan(self, body) -> None:
        for st in body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue                       # nested scopes: out of scope
            if isinstance(st, ast.Assign):
                self._check_expr(st.value)
                self._bind(st.targets, st.value)
            elif isinstance(st, (ast.AnnAssign, ast.AugAssign)):
                if st.value is not None:
                    self._check_expr(st.value)
                    self._bind([st.target], st.value)
            elif isinstance(st, ast.For):
                self._check_expr(st.iter)
                if self._tainted(st.iter):
                    self._bind([st.target], st.iter)
                self.scan(st.body)
                self.scan(st.orelse)
            elif isinstance(st, (ast.While, ast.If)):
                self._check_expr(st.test)
                self.scan(st.body)
                self.scan(st.orelse)
            elif isinstance(st, ast.With):
                for item in st.items:
                    self._check_expr(item.context_expr)
                self.scan(st.body)
            elif isinstance(st, ast.Try):
                self.scan(st.body)
                for h in st.handlers:
                    self.scan(h.body)
                self.scan(st.orelse)
                self.scan(st.finalbody)
            else:
                self._check_expr(st)


class SyncDisciplineRule(Rule):
    rule_id = "R1"
    title = ("device->host syncs go through the _pull()/_host() choke "
             "points (one sync per decode step)")

    def check(self, tree: ast.AST, path: str) -> List:
        scanned = []
        if any(f.name == "_host" for f in function_defs(tree)):
            scanned.extend(function_defs(tree))    # every function of the
            for cls in getattr(tree, "body", []):  # module, methods too
                if isinstance(cls, ast.ClassDef):
                    scanned.extend(function_defs(cls))
        for cls in (n for n in ast.walk(tree)
                    if isinstance(n, ast.ClassDef)):
            methods = list(function_defs(cls))
            if any(m.name == "_pull" for m in methods):
                scanned.extend(m for m in methods if m not in scanned)
        findings: List = []
        for fn in scanned:
            if fn.name in CHOKE_POINTS:
                continue                       # the choke point itself
            scanner = _Scanner(self, path)
            scanner.scan(fn.body)
            findings.extend(scanner.findings)
        return findings


__all__ = ["SyncDisciplineRule", "DEVICE_PRODUCERS", "CHOKE_POINTS"]
