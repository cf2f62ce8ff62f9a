"""replaylint framework: findings, suppressions, and the analysis driver.

The checkers in :mod:`repro_torch.analysis.rules` encode the repo's determinism
contract (docs/ARCHITECTURE.md, "Determinism contract"): the differential
replay harness asserts that the simulator and the live plane produce
bit-identical decisions and dollars, and that only holds if the code the
spine consumes is free of wall-clock reads, hash-order iteration, unseeded
RNGs, and one-sided cost charges.  This module is the machinery; the rules
are the policy.

Suppression idiom (mirrors pylint/ruff)::

    self._clock = clock or time.time  # replaylint: disable=RS001

A directive on its own line applies to the next line as well, so long
statements can carry a suppression without breaking the line-length budget::

    # replaylint: disable=RS003
    for k in some_set_expression_that_is_actually_fine:
        ...

``# replaylint: disable-file=RS001`` anywhere in a file disables a code for
the whole file.  ``disable=all`` is accepted in both forms.

Exit-code contract (see :mod:`repro_torch.analysis.__main__`):

* 0 -- no unsuppressed findings
* 1 -- at least one finding
* 2 -- usage error (unknown rule code, unreadable/unparseable target, no
  files matched)
"""

from __future__ import annotations

import ast
import io
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set

MAGIC = "replaylint:"


class UsageError(Exception):
    """Bad invocation or unanalyzable input: exit code 2, not a finding."""


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    code: str
    message: str
    path: str
    line: int
    col: int = 0

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} {self.message}"

    def sort_key(self):
        return (self.path, self.line, self.col, self.code)


@dataclass
class Module:
    """A parsed source file plus its suppression tables."""

    path: Path
    source: str
    tree: ast.Module
    #: physical line -> codes disabled on that line
    line_disables: Dict[int, Set[str]] = field(default_factory=dict)
    #: codes disabled for the whole file
    file_disables: Set[str] = field(default_factory=set)

    @property
    def name(self) -> str:
        return self.path.stem

    def is_suppressed(self, finding: Finding) -> bool:
        disabled = self.line_disables.get(finding.line, set())
        return (
            finding.code in disabled
            or "all" in disabled
            or finding.code in self.file_disables
            or "all" in self.file_disables
        )


class Rule:
    """Base checker.  Subclasses set ``code``/``name``/``rationale`` and
    override :meth:`check_module` (per-file) and/or :meth:`finalize`
    (cross-file, runs once after every module has been checked -- the hook
    RS005 uses to diff the two cost planes)."""

    code: str = "RS000"
    name: str = "abstract"
    rationale: str = ""

    def check_module(self, module: Module) -> Iterator[Finding]:
        return iter(())

    def finalize(self, modules: Sequence[Module]) -> Iterator[Finding]:
        return iter(())

    def finding(self, module: Module, node: ast.AST, message: str) -> Finding:
        return Finding(
            code=self.code,
            message=message,
            path=str(module.path),
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
        )


def _parse_directive(comment: str) -> Iterator[tuple]:
    """Yield ("line"|"file", {codes}) for each directive in a comment."""
    text = comment.lstrip("#").strip()
    if not text.startswith(MAGIC):
        return
    body = text[len(MAGIC):].strip()
    for clause in body.split():
        if clause.startswith("disable-file="):
            codes = clause[len("disable-file="):]
            yield "file", {c.strip() for c in codes.split(",") if c.strip()}
        elif clause.startswith("disable="):
            codes = clause[len("disable="):]
            yield "line", {c.strip() for c in codes.split(",") if c.strip()}


def _collect_suppressions(source: str, module: Module) -> None:
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            for scope, codes in _parse_directive(tok.string):
                if scope == "file":
                    module.file_disables |= codes
                    continue
                line = tok.start[0]
                module.line_disables.setdefault(line, set()).update(codes)
                # A directive alone on its line covers the next line too.
                if tok.line.strip() == tok.string.strip():
                    module.line_disables.setdefault(line + 1, set()).update(codes)
    except tokenize.TokenError:
        pass  # the ast parse already succeeded; comments stay best-effort


def load_module(path: Path) -> Module:
    try:
        source = path.read_text(encoding="utf-8")
    except OSError as exc:
        raise UsageError(f"cannot read {path}: {exc}") from exc
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as exc:
        raise UsageError(f"cannot parse {path}: {exc}") from exc
    module = Module(path=path, source=source, tree=tree)
    _collect_suppressions(source, module)
    return module


def collect_files(paths: Iterable[str]) -> List[Path]:
    files: List[Path] = []
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            files.extend(
                f for f in sorted(p.rglob("*.py")) if "__pycache__" not in f.parts
            )
        elif p.is_file():
            files.append(p)
        else:
            raise UsageError(f"no such file or directory: {raw}")
    if not files:
        raise UsageError("no Python files to analyze")
    return files


@dataclass
class AnalysisResult:
    findings: List[Finding]
    suppressed: List[Finding]
    n_files: int


def run_analysis(
    paths: Iterable[str],
    rules: Optional[Sequence[Rule]] = None,
    select: Optional[Iterable[str]] = None,
) -> AnalysisResult:
    """Run every (selected) rule over ``paths`` and partition the findings
    into live vs suppressed.  Fresh rule instances are created per run so
    cross-file state (RS005) never leaks between invocations."""
    from .rules import make_rules

    active = list(rules) if rules is not None else make_rules()
    if select is not None:
        wanted = set(select)
        known = {r.code for r in active}
        unknown = wanted - known
        if unknown:
            raise UsageError(
                f"unknown rule code(s): {', '.join(sorted(unknown))} "
                f"(known: {', '.join(sorted(known))})"
            )
        active = [r for r in active if r.code in wanted]

    modules = [load_module(f) for f in collect_files(paths)]
    by_path = {str(m.path): m for m in modules}

    raw: List[Finding] = []
    for rule in active:
        for module in modules:
            raw.extend(rule.check_module(module))
    for rule in active:
        raw.extend(rule.finalize(modules))

    live, suppressed = [], []
    for f in sorted(raw, key=Finding.sort_key):
        module = by_path.get(f.path)
        (suppressed if module is not None and module.is_suppressed(f) else live).append(f)
    return AnalysisResult(findings=live, suppressed=suppressed, n_files=len(modules))
