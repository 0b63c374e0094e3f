"""Rule engine: module loading, pragma suppression, rule registry.

A rule is a ``Rule`` subclass with a class-level ``id``/``name``/``doc``, the
``languages`` it reads (``"py"``, ``"cu"`` or both) and a ``check(mod) ->
Iterator[(node_or_span, message)]``. The engine owns everything else: walking
paths (``*.py``, and ``*.cu``/``*.cuh`` for the CUDA rules), parsing, matching
``lint: ok(R00x) reason`` pragmas against finding spans, and the R000
meta-findings (unparseable file, reasonless pragma).

Pragma semantics: a pragma suppresses a finding of rule ``R`` when it names
``R`` and sits on any line of the flagged statement or in the contiguous
comment block directly above it. In Python it is a ``#`` comment, in CUDA a
``//`` comment. The reason text is mandatory — it is the audit trail that
records why the site is safe; a pragma without one
suppresses nothing and is itself reported as R000.
"""
from __future__ import annotations

import ast
import dataclasses
import functools
import re
from pathlib import Path
from typing import Iterable, Iterator, Optional, Sequence, Union

from repro_torch.analysis import astutils

_PRAGMA_BODY = (r"lint:\s*ok\(\s*(?P<rules>R\d{3}(?:\s*,\s*R\d{3})*)\s*\)"
                r"\s*(?P<reason>.*)$")
PRAGMA_RE = re.compile(r"#\s*" + _PRAGMA_BODY)
CUDA_PRAGMA_RE = re.compile(r"//\s*" + _PRAGMA_BODY)
CUDA_SUFFIXES = (".cu", ".cuh")

Span = tuple[int, int, int]           # (line, end_line, col)
RawFinding = tuple[Union[ast.AST, Span], str]


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    end_line: int
    col: int
    message: str
    suppressed: bool = False
    reason: str = ""                  # pragma reason when suppressed

    def format(self) -> str:
        flag = " [suppressed: %s]" % self.reason if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col + 1}: {self.rule} " \
               f"{self.message}{flag}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Pragma:
    line: int
    rules: tuple[str, ...]
    reason: str


class _Source:
    """Pragma table and suppression lookup shared by both languages."""

    language = ""
    pragma_re = PRAGMA_RE
    comment = "#"

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source

    @functools.cached_property
    def pragmas(self) -> list[Pragma]:
        out = []
        for i, line in enumerate(self.source.splitlines(), start=1):
            m = self.pragma_re.search(line)
            if m:
                rules = tuple(r.strip() for r in m.group("rules").split(","))
                out.append(Pragma(i, rules, m.group("reason").strip()))
        return out

    @functools.cached_property
    def _comment_only(self) -> set:
        return {i for i, ln in enumerate(self.source.splitlines(), start=1)
                if ln.lstrip().startswith(self.comment)}

    def pragma_for(self, rule: str, line: int, end_line: int
                   ) -> Optional[Pragma]:
        """Pragma naming `rule` on a line of [line, end_line] or in the
        contiguous comment block directly above the flagged statement."""
        lo = line
        while lo - 1 in self._comment_only:
            lo -= 1
        for p in self.pragmas:
            if rule in p.rules and lo - 1 <= p.line <= end_line and p.reason:
                return p
        return None


class ModuleInfo(_Source):
    """One parsed Python file + the lazily computed per-module indexes that
    several rules share (parent links, import aliases, pragma table)."""

    language = "py"

    def __init__(self, path: str, source: str):
        super().__init__(path, source)
        self.tree: ast.Module = ast.parse(source, filename=path)

    @functools.cached_property
    def parents(self) -> dict[ast.AST, ast.AST]:
        return astutils.build_parents(self.tree)

    @functools.cached_property
    def aliases(self) -> dict[str, str]:
        return astutils.import_aliases(self.tree)


class CudaModule(_Source):
    """One CUDA source file, read as text (``rules_cuda`` scans it)."""

    language = "cu"
    pragma_re = CUDA_PRAGMA_RE
    comment = "//"


class Rule:
    """Base class; subclasses register themselves in :func:`all_rules`."""

    id: str = ""
    name: str = ""
    doc: str = ""
    languages: tuple[str, ...] = ("py",)

    def check(self, mod) -> Iterator[RawFinding]:
        raise NotImplementedError

    def _span(self, where: Union[ast.AST, Span]) -> Span:
        if isinstance(where, tuple):
            return where
        return (where.lineno, getattr(where, "end_lineno", None) or
                where.lineno, getattr(where, "col_offset", 0))

    def run(self, mod) -> Iterator[Finding]:
        if mod.language not in self.languages:
            return
        for where, message in self.check(mod):
            line, end_line, col = self._span(where)
            pragma = mod.pragma_for(self.id, line, end_line)
            yield Finding(self.id, mod.path, line, end_line, col, message,
                          suppressed=pragma is not None,
                          reason=pragma.reason if pragma else "")


def all_rules() -> list[Rule]:
    """The catalog, in id order. Imported lazily so `engine` has no import
    cycle with the rule modules."""
    from repro_torch.analysis.rules_concat import ShardedConcatRule
    from repro_torch.analysis.rules_cuda import (AsyncCopyRule,
                                                 SharedMemoryBudgetRule)
    from repro_torch.analysis.rules_jit import HotPathHazardRule
    from repro_torch.analysis.rules_queue import UnboundedQueueRule
    from repro_torch.analysis.rules_vjp import AutogradArityRule
    return [ShardedConcatRule(), AsyncCopyRule(), SharedMemoryBudgetRule(),
            HotPathHazardRule(), AutogradArityRule(), UnboundedQueueRule()]


def _iter_files(paths: Sequence[Union[str, Path]]) -> Iterator[Path]:
    suffixes = (".py",) + CUDA_SUFFIXES
    for p in paths:
        p = Path(p)
        if p.is_dir():
            for f in sorted(f for f in p.rglob("*") if f.suffix in suffixes):
                if "__pycache__" not in f.parts:
                    yield f
        elif p.suffix in suffixes:
            yield p


def _meta_findings(mod: _Source) -> Iterator[Finding]:
    """R000: pragma hygiene — a reasonless pragma is dead weight that looks
    like an audit but records nothing, so it never suppresses and is flagged."""
    for p in mod.pragmas:
        if not p.reason:
            yield Finding("R000", mod.path, p.line, p.line, 0,
                          "pragma must carry a reason: "
                          f"`{mod.comment} lint: ok(R00x) <why this site is "
                          "safe>`")


def analyze_source(source: str, path: str = "<string>",
                   rules: Optional[Iterable[Rule]] = None) -> list[Finding]:
    """Analyze one in-memory module (test fixtures use this directly); a
    path ending in ``.cu``/``.cuh`` is read as CUDA, anything else as
    Python."""
    if path.endswith(CUDA_SUFFIXES):
        mod: _Source = CudaModule(path, source)
    else:
        try:
            mod = ModuleInfo(path, source)
        except SyntaxError as e:
            return [Finding("R000", path, e.lineno or 1, e.lineno or 1, 0,
                            f"could not parse: {e.msg}")]
    findings = list(_meta_findings(mod))
    for rule in (all_rules() if rules is None else rules):
        findings.extend(rule.run(mod))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def run_analysis(paths: Sequence[Union[str, Path]],
                 rules: Optional[Iterable[Rule]] = None) -> list[Finding]:
    """Analyze every .py/.cu/.cuh file under `paths` with the given rules
    (default: the full catalog). Returns all findings, suppressed ones
    included — callers decide what an unsuppressed finding means (CLI:
    exit 1)."""
    rules = list(all_rules() if rules is None else rules)
    findings: list[Finding] = []
    for f in _iter_files(paths):
        findings.extend(
            analyze_source(f.read_text(encoding="utf-8"), str(f), rules))
    return findings


def summarize(findings: Sequence[Finding],
              rules: Optional[Iterable[Rule]] = None) -> str:
    """Per-rule one-liners + a totals line (the CLI's summary block)."""
    rules = list(all_rules() if rules is None else rules)
    by_rule: dict[str, list[Finding]] = {r.id: [] for r in rules}
    names = {r.id: r.name for r in rules}
    for f in findings:
        by_rule.setdefault(f.rule, []).append(f)
    lines = []
    for rid in sorted(by_rule):
        fs = by_rule[rid]
        live = sum(1 for f in fs if not f.suppressed)
        supp = len(fs) - live
        lines.append(f"{rid} {names.get(rid, 'meta'):<18} "
                     f"{live:3d} finding(s), {supp:3d} suppressed")
    total = sum(1 for f in findings if not f.suppressed)
    lines.append(f"repro_torch.analysis: {total} unsuppressed finding(s)")
    return "\n".join(lines)
