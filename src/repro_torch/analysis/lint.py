"""Invariant linter runner of the PyTorch port:
``python -m repro_torch.analysis.lint src/repro_torch``.

Walks every ``.py`` file under the given paths, parses it with ``ast``,
runs the rule registry (``repro_torch.analysis.rules.all_rules``: R1, R3,
R6), and prints
findings as ``path:line:col: Rn message``.  Exit code 0 when clean, 1 when
any finding survives suppression, 2 on usage / syntax errors.

Per-line suppression::

    chosen = int(packed[0])  # repro-lint: disable=R1  (startup, pre-loop)
    # repro-lint: disable   — suppresses every rule on that line

The comment is the reference linter's (``repro.analysis.lint``), so one
comment serves both.

Options::

    --select R1,R3    run only these rules
    --list-rules      print the registry and exit

The linter imports nothing from the linted code — pure stdlib AST walks —
so it runs without torch installed.
"""
from __future__ import annotations

import argparse
import ast
import re
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

from repro_torch.analysis.rules import Finding, Rule, all_rules

_SUPPRESS_RE = re.compile(
    r"#\s*repro-lint:\s*disable(?:=(?P<rules>[A-Za-z0-9,\s]+))?")


def _suppressions(source: str) -> Dict[int, Optional[Set[str]]]:
    """Map line number -> suppressed rule ids (None = all rules)."""
    out: Dict[int, Optional[Set[str]]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = m.group("rules")
        if rules is None:
            out[i] = None
        else:
            out[i] = {r.strip() for r in rules.split(",") if r.strip()}
    return out


def _suppressed(finding: Finding,
                supp: Dict[int, Optional[Set[str]]]) -> bool:
    rules = supp.get(finding.line, "absent")
    if rules == "absent":
        return False
    return rules is None or finding.rule in rules


def lint_source(source: str, path: str = "<string>",
                rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    """Lint one source string; the unit the tests drive directly."""
    tree = ast.parse(source, filename=path)
    supp = _suppressions(source)
    findings: List[Finding] = []
    for rule in (rules if rules is not None else all_rules()):
        findings.extend(f for f in rule.check(tree, path)
                        if not _suppressed(f, supp))
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings


def lint_file(path: Path,
              rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    source = path.read_text(encoding="utf-8")
    return lint_source(source, str(path), rules)


def iter_py_files(targets: Iterable[str]) -> Iterable[Path]:
    for target in targets:
        p = Path(target)
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Invariant linter for the port's serving engine "
                    "(R1, R3, R6).")
    parser.add_argument("paths", nargs="*", default=["src/repro_torch/"],
                        help="files or directories to lint")
    parser.add_argument("--select", default=None,
                        help="comma-separated rule ids to run (e.g. R1,R3)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule registry and exit")
    args = parser.parse_args(argv)

    registry = all_rules()
    if args.list_rules:
        for rule in registry:
            print(f"{rule.rule_id}  {rule.title}")
        return 0

    if args.select:
        wanted = {r.strip() for r in args.select.split(",") if r.strip()}
        unknown = wanted - {r.rule_id for r in registry}
        if unknown:
            print(f"unknown rule id(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        registry = [r for r in registry if r.rule_id in wanted]

    paths = list(iter_py_files(args.paths or ["src/repro_torch/"]))
    if not paths:
        print("no .py files found under: " + " ".join(args.paths),
              file=sys.stderr)
        return 2

    n_findings = 0
    for path in paths:
        try:
            findings = lint_file(path, registry)
        except SyntaxError as exc:
            print(f"{path}:{exc.lineno}:{exc.offset}: syntax error: "
                  f"{exc.msg}", file=sys.stderr)
            return 2
        for f in findings:
            print(f)
        n_findings += len(findings)

    if n_findings:
        print(f"\n{n_findings} finding(s) in {len(paths)} file(s)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
