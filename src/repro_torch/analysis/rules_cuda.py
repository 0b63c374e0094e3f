"""R002/R003: the async-copy and shared-memory invariants of the CUDA kernels.

These are the counterparts of the reference's Pallas rules (DMA start/wait
pairing, VMEM budget) for the hand-written Hopper kernels of
``src/repro_torch/csrc``. They read the ``.cu`` sources with a text scanner,
not a C++ parser: comments and preprocessor lines are blanked, a function is
a ``{`` whose header ends in a parenthesised parameter list after a
non-keyword name (``__global__`` in the header makes it a kernel,
``__device__`` a device helper, anything else host code), and a device
helper's events (the PTX it issues, the barriers it takes) count at every
call of its name (a helper's own events: calls between helpers are not
followed). Templates, macros that hide these constructs, and control
flow are not modelled: events are taken in text order. A site the scanner
misreads takes the standard audit pragma, a ``//`` comment:
``// lint: ok(R00x) <why this site is safe>``.

R002 async-copy — a resident kernel stages its source slab with ``cp.async``
(every copy in flight at once) and then computes from shared memory. A
missed wait, or a missing barrier after it, reads the slab before other
threads' copies have landed: wrong numbers, silently, and only sometimes.
In each ``__global__`` that issues ``cp.async`` (directly or through a
helper):

  * every issue is followed by a ``cp.async.wait_all``, or by a
    ``cp.async.commit_group`` and then a ``cp.async.wait_group N``;
  * nothing reads the staged shared memory (the ``__shared__`` arrays and
    the pointers made from them) between the first issue and its wait;
  * a ``__syncthreads()`` stands between that wait and the first read;
  * an ``mbarrier`` arrive (or ``expect_tx``) is followed by a wait on an
    mbarrier, and no kernel waits on an mbarrier nothing arrives at.

R003 shared-memory budget — the counterpart of the VMEM budget. An H100
block may hold at most ``SMEM_OPTIN_BYTES`` (232,448 B) of shared memory,
and only 48 KiB unless its kernel opted in; over either, the launch fails at
run time, on the card only. So:

  * every ``__global__`` carries ``__launch_bounds__`` (the block size the
    registers are allotted for, which the resident kernels' one block per SM
    relies on);
  * static ``__shared__`` arrays of constant size sum to at most 48 KiB per
    kernel, and a size the scanner cannot evaluate is a finding;
  * a kernel with ``extern __shared__`` memory is launched only from host
    functions that call ``cudaFuncSetAttribute(…,
    cudaFuncAttributeMaxDynamicSharedMemorySize, …)``, and a constant
    dynamic size is at most ``SMEM_OPTIN_BYTES``;
  * in Python, a ``load_kernel(name, symbol, …)`` of an entry point of
    ``csrc/<name>.cu`` whose parameters size such a slab (they name every field of the launcher's
    dynamic-size expression, e.g. ``M`` and ``bd``) sits in a function that
    derives the size from ``build.slab_cols(…, build.smem_optin(…))``. A
    size bounded by neither is an unbounded resident block.
"""
from __future__ import annotations

import ast
import bisect
import dataclasses
import functools
import re
from pathlib import Path
from typing import Iterator, Optional

from repro_torch.analysis import astutils
from repro_torch.analysis.engine import (CudaModule, ModuleInfo, RawFinding,
                                         Rule)

SMEM_OPTIN_BYTES = 232_448       # H100: opt-in shared memory per block
STATIC_SMEM_BYTES = 48 * 1024    # without the opt-in

_KEYWORDS = {"if", "for", "while", "switch", "catch", "return", "sizeof",
             "constexpr", "decltype", "alignof", "static_assert", "else",
             "do", "defined", "__launch_bounds__", "operator"}
# the element types of csrc/ (a static array of another type is a size the
# scanner cannot evaluate)
_TYPE_BYTES = {"unsigned char": 1, "__nv_bfloat16": 2, "int": 4,
               "int32_t": 4, "unsigned": 4, "float": 4, "double": 8,
               "float4": 16}

# PTX / intrinsics, matched in the code with string literals kept
_EVENTS = {
    "issue": re.compile(r"cp\.async\.c[ag]\."),
    "commit": re.compile(r"cp\.async\.commit_group"),
    "wait_all": re.compile(r"cp\.async\.wait_all"),
    "wait_group": re.compile(r"cp\.async\.wait_group"),
    "sync": re.compile(r"__syncthreads\s*\("),
    "arrive": re.compile(r"mbarrier\.arrive|mbarrier\.expect_tx"),
    "mwait": re.compile(r"mbarrier\.(?:try_wait|test_wait)"),
}


# ------------------------------------------------------------------ scanner
def _blank(source: str) -> tuple[str, str]:
    """(code, skeleton): comments and preprocessor lines blanked to spaces
    (newlines kept, so offsets and lines still match the source); the
    skeleton also blanks the insides of string and char literals, so braces
    and parentheses in asm text do not count."""
    code, skel = list(source), list(source)
    i, n = 0, len(source)
    line_start = True
    while i < n:
        c = source[i]
        if line_start and c == "#":       # preprocessor line (+ continuations)
            while i < n and source[i] != "\n":
                if source[i] == "\\" and i + 1 < n and source[i + 1] == "\n":
                    code[i] = skel[i] = " "
                    i += 2
                    continue
                code[i] = skel[i] = " "
                i += 1
            continue
        if c == "\n":
            line_start = True
            i += 1
            continue
        if not c.isspace():
            line_start = False
        if source.startswith("//", i):
            while i < n and source[i] != "\n":
                code[i] = skel[i] = " "
                i += 1
            continue
        if source.startswith("/*", i):
            end = source.find("*/", i + 2)
            end = n if end < 0 else end + 2
            for j in range(i, end):
                if source[j] != "\n":
                    code[j] = skel[j] = " "
            i = end
            continue
        if c in "\"'":
            j = i + 1
            while j < n and source[j] != c and source[j] != "\n":
                j += 2 if source[j] == "\\" else 1
            for k in range(i + 1, min(j, n)):
                skel[k] = " "
            i = j + 1
            continue
        i += 1
    return "".join(code), "".join(skel)


def _match(skel: str, i: int, open_: str, close: str, step: int = 1) -> int:
    """Offset of the bracket matching the one at ``i`` (scanning forward
    with step 1, backward with -1); -1 when unbalanced."""
    depth = 0
    while 0 <= i < len(skel):
        ch = skel[i]
        if ch == (open_ if step > 0 else close):
            depth += 1
        elif ch == (close if step > 0 else open_):
            depth -= 1
            if depth == 0:
                return i
        i += step
    return -1


def _split_top(text: str, sep: str = ",") -> list[str]:
    """``text`` split at ``sep`` outside (), [], {} and <>."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch in "([{<":
            depth += 1
        elif ch in ")]}>":
            depth -= 1
        if ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


@dataclasses.dataclass
class CudaFunction:
    name: str
    kind: str           # "global" | "device" | "host"
    header: str
    name_pos: int       # offset of the name
    open: int           # offset of the body's "{"
    close: int          # offset of its "}"
    params: list[str]
    extern_c: bool


class CudaSource:
    """The scanned view of one ``.cu`` file."""

    def __init__(self, source: str):
        self.source = source
        self.code, self.skel = _blank(source)
        self._nl = [i for i, ch in enumerate(source) if ch == "\n"]

    def line_col(self, offset: int) -> tuple[int, int]:
        k = bisect.bisect_left(self._nl, offset)
        start = self._nl[k - 1] + 1 if k else 0
        return k + 1, offset - start

    def span(self, offset: int, end: Optional[int] = None):
        line, col = self.line_col(offset)
        return (line, self.line_col(end)[0] if end is not None else line, col)

    @functools.cached_property
    def functions(self) -> list[CudaFunction]:
        skel, out = self.skel, []
        for m in re.finditer(r"\{", skel):
            brace = m.start()
            lo = max(skel.rfind(";", 0, brace), skel.rfind("{", 0, brace),
                     skel.rfind("}", 0, brace)) + 1
            header = skel[lo:brace]
            h = header.rstrip()
            while True:        # trailing qualifiers
                q = re.search(r"\b(const|noexcept|override|mutable)$", h)
                if not q:
                    break
                h = h[:q.start()].rstrip()
            if not h.endswith(")"):
                continue
            p_close = lo + len(h) - 1
            p_open = _match(skel, p_close, "(", ")", step=-1)
            if p_open < lo:
                continue
            nm = re.search(r"([A-Za-z_]\w*)\s*$", skel[lo:p_open])
            if not nm or nm.group(1) in _KEYWORDS:
                continue
            pre = skel[lo:lo + nm.start()]
            close = _match(skel, brace, "{", "}")
            if close < 0:
                continue
            kind = ("global" if "__global__" in pre else
                    "device" if "__device__" in pre and "__host__" not in pre
                    else "host")
            params = []
            for p in _split_top(skel[p_open + 1:p_close]):
                p = re.sub(r"\[[^\]]*\]", "", p.split("=")[0])
                ids = re.findall(r"[A-Za-z_]\w*", p)
                if ids and ids[-1] != "void":
                    params.append(ids[-1])
            out.append(CudaFunction(nm.group(1), kind, skel[lo:brace],
                                    lo + nm.start(), brace, close, params,
                                    bool(re.search(r"\bextern\b", pre))))
        return out

    def body(self, f: CudaFunction) -> str:
        return self.code[f.open + 1:f.close]

    @functools.cached_property
    def _scopes(self) -> list[tuple[int, int]]:
        """(open, close) of every function and struct/class/union body."""
        spans = [(f.open, f.close) for f in self.functions]
        for m in re.finditer(r"\b(?:struct|class|union)\b[^;{}()]*\{",
                             self.skel):
            close = _match(self.skel, m.end() - 1, "{", "}")
            if close > 0:
                spans.append((m.end() - 1, close))
        return spans

    def constants(self, within: Optional[CudaFunction] = None
                  ) -> dict[str, int]:
        """Integer constants (``#define`` and ``constexpr``) at namespace
        scope, plus those of ``within``'s body."""
        env: dict[str, int] = {}
        for m in re.finditer(
                r"^\s*#\s*define\s+(\w+)\s+([^\n]+)$", self.source, re.M):
            v = _c_eval(m.group(2), env)
            if v is not None:
                env[m.group(1)] = v
        for m in re.finditer(
                r"\bconstexpr\s+(?:static\s+)?(?:const\s+)?[\w:\s]*?\b(\w+)"
                r"\s*=\s*([^;{}]+);", self.code):
            own = None if within is None else (within.open, within.close)
            if any(s[0] < m.start() < s[1] and s != own
                   for s in self._scopes):
                continue
            v = _c_eval(m.group(2), env)
            if v is not None:
                env[m.group(1)] = v
        return env

    def calls_of(self, name: str, lo: int, hi: int) -> list[tuple[int, int]]:
        """(start, end) of every call ``name(...)`` / ``name<...>(...)`` in
        the code between offsets ``lo`` and ``hi``."""
        out = []
        for m in re.finditer(rf"(?<![\w.>]){re.escape(name)}\s*"
                             r"(?:<[^;{}()]*>)?\s*\(", self.skel[lo:hi]):
            start = lo + m.start()
            end = _match(self.skel, lo + m.end() - 1, "(", ")")
            out.append((start, end if end >= 0 else lo + m.end()))
        return out


def _c_eval(expr: str, env: dict[str, int]) -> Optional[int]:
    """An integer constant expression of C, or None."""
    e = re.sub(r"static_cast<[^<>]*>", "", expr.strip())
    e = re.sub(r"\b(0[xX][0-9a-fA-F]+|\d+)[uUlL]+\b", r"\1", e)
    try:
        return astutils.const_eval(ast.parse(e, mode="eval").body, env)
    except SyntaxError:
        return None


@functools.lru_cache(maxsize=16)
def _scan(source: str) -> CudaSource:
    """One scan per source, shared by R002 and R003."""
    return CudaSource(source)


# ------------------------------------------------------------------- R002
def _own_events(src: CudaSource, f: CudaFunction) -> list[tuple[int, str]]:
    body_lo, body_hi = f.open + 1, f.close
    return sorted((body_lo + m.start(), kind)
                  for kind, rx in _EVENTS.items()
                  for m in rx.finditer(src.code[body_lo:body_hi]))


def _helper_effects(src: CudaSource) -> dict[str, list[str]]:
    """Device helper name -> the kinds of events one call of it makes, in
    order (its own: a helper's calls of other helpers are not followed)."""
    effects: dict[str, list[str]] = {}
    for f in src.functions:
        kinds = [k for _, k in _own_events(src, f)]
        if f.kind == "device" and kinds:
            effects.setdefault(f.name, kinds)
    return effects


def _kernel_events(src: CudaSource, k: CudaFunction,
                   effects: dict[str, list[str]]):
    """[(offset, kind, (call start, call end) or None)] of a kernel."""
    evs = [(o, kind, None) for o, kind in _own_events(src, k)]
    for name, kinds in effects.items():
        for start, end in src.calls_of(name, k.open + 1, k.close):
            evs += [(start, kind, (start, end)) for kind in kinds]
    return sorted(evs, key=lambda e: e[0])


def _smem_names(body: str) -> set:
    names = set(re.findall(r"__shared__[^;]*?\b(\w+)\s*\[", body))
    while True:   # pointers made from them
        grown = set(names)
        for m in re.finditer(r"[\w:<>]+\s*\*+\s*(?:const\s+)?(\w+)\s*="
                             r"\s*([^;]+);", body):
            if any(re.search(rf"\b{re.escape(n)}\b", m.group(2))
                   for n in names):
                grown.add(m.group(1))
        if grown == names:
            return names
        names = grown


_ASSIGN = re.compile(r"\s*=(?!=)")


def _reads(src: CudaSource, names: set, lo: int, hi: int,
           skip: list) -> Iterator[int]:
    """Offsets in [lo, hi) where a staged shared-memory name is read: not a
    store ``name[...] = ...``, not a declaration, not an argument of an
    async-copy issue."""
    if not names:
        return
    rx = re.compile(r"\b(" + "|".join(map(re.escape, sorted(names))) + r")\b")
    for m in rx.finditer(src.skel, lo, hi):
        o = m.start()
        if any(s <= o <= e for s, e in skip):
            continue
        if (re.search(r"(?:[\w>]\s*\*+|\bauto)\s*(?:const\s+)?$",
                      src.skel[max(lo, o - 80):o])
                and _ASSIGN.match(src.skel, m.end())):
            continue                         # `T* name = ...`: a declaration
        after = re.compile(r"\s*").match(src.skel, m.end()).end()
        if after < hi and src.skel[after] == "[":
            end = _match(src.skel, after, "[", "]")
            if end > 0 and _ASSIGN.match(src.skel, end + 1):
                continue                     # a store into the slab
        yield o


class AsyncCopyRule(Rule):
    id = "R002"
    name = "async-copy"
    doc = __doc__
    languages = ("cu",)

    def check(self, mod: CudaModule) -> Iterator[RawFinding]:
        src = _scan(mod.source)
        effects = _helper_effects(src)
        for k in src.functions:
            if k.kind == "global":
                yield from self._check_kernel(src, k, effects)

    def _check_kernel(self, src, k, effects) -> Iterator[RawFinding]:
        evs = _kernel_events(src, k, effects)
        issues = [e for e in evs if e[1] == "issue"]
        wait = None
        for io, _, _ in issues:
            w = self._wait_after(evs, io)
            if w is None:
                yield src.span(io), (
                    f"cp.async issued in `{k.name}` is never waited for: "
                    "no `cp.async.wait_all` (or `cp.async.commit_group` … "
                    "`cp.async.wait_group N`) follows it, so threads read "
                    "shared memory before the copy lands")
                return
            wait = w if wait is None else wait
        if issues:
            names = _smem_names(src.body(k))
            skip = [s for _, kind, s in evs if kind == "issue" and s]
            for o in _reads(src, names, issues[0][0], wait, skip):
                yield src.span(o), (
                    f"staged shared memory read in `{k.name}` before the "
                    "cp.async wait: the copy may not have landed")
                return
            syncs = [o for o, kind, _ in evs if kind == "sync" and o > wait]
            first = next(_reads(src, names, wait, k.close, skip), None)
            if first is not None and not any(o < first for o in syncs):
                yield src.span(first), (
                    f"staged shared memory read in `{k.name}` with no "
                    "`__syncthreads()` after the cp.async wait: each thread "
                    "waits only for its own copies, so other threads' "
                    "part of the slab may not have landed")
        arrives = [o for o, kind, _ in evs if kind == "arrive"]
        mwaits = [o for o, kind, _ in evs if kind == "mwait"]
        if arrives and not any(o > arrives[0] for o in mwaits):
            yield src.span(arrives[0]), (
                f"mbarrier arrive/expect-tx in `{k.name}` with no mbarrier "
                "wait after it: the transaction is never consumed")
        elif mwaits and not arrives:
            yield src.span(mwaits[0]), (
                f"`{k.name}` waits on an mbarrier that nothing in it "
                "arrives at — this wait deadlocks")

    def _wait_after(self, evs, io: int) -> Optional[int]:
        committed = False
        for o, kind, _ in evs:
            if o <= io:
                continue
            if kind == "commit":
                committed = True
            elif kind == "wait_all" or (kind == "wait_group" and committed):
                return o
        return None


# ------------------------------------------------------------------- R003
def _static_arrays(src: CudaSource, k: CudaFunction):
    """[(offset, name, bytes or None)] of a kernel's static __shared__."""
    out = []
    lo = k.open + 1
    for m in re.finditer(r"__shared__\s+(?:__align__\s*\(\s*\d+\s*\)\s*)?"
                         r"([\w:\s]+?)\s+(\w+)\s*((?:\[[^\]]*\]\s*)+);",
                         src.code[lo:k.close]):
        if src.code[:lo + m.start()].rstrip().endswith("extern"):
            continue
        size = _TYPE_BYTES.get(" ".join(m.group(1).split()))
        for dim in re.findall(r"\[([^\]]*)\]", m.group(3)):
            v = _c_eval(dim, src.constants(k)) if dim.strip() else None
            size = None if size is None or v is None else size * v
        out.append((lo + m.start(2), m.group(2), size))
    return out


def _launches(src: CudaSource, f: CudaFunction):
    """[(offset, kernel expression, launch config args)] in ``f``."""
    out = []
    for m in re.finditer(r"([\w:]+)\s*(?:<[^;{}]*?>)?\s*<<<(.*?)>>>",
                         src.code[f.open + 1:f.close], re.S):
        out.append((f.open + 1 + m.start(), m.group(1),
                    _split_top(m.group(2))))
    return out


def _smem_fields(src: CudaSource) -> set:
    """Struct fields (``a.M``) the dynamic shared-memory sizes of this
    file's launches are computed from."""
    fields: set = set()
    for f in src.functions:
        if f.kind != "host":
            continue
        body = src.body(f)
        for _, _, cfg in _launches(src, f):
            if len(cfg) < 3 or _c_eval(cfg[2], src.constants(f)) is not None:
                continue
            expr = cfg[2]
            d = re.search(rf"\b{re.escape(expr)}\s*=\s*([^;]+);", body) \
                if re.fullmatch(r"\w+", expr) else None
            fields |= set(re.findall(r"\b\w+\s*\.\s*(\w+)",
                                     d.group(1) if d else expr))
    return fields


# where ``build.load_kernel(name, …)`` finds its source
CSRC = Path(__file__).resolve().parents[1] / "csrc"


@functools.lru_cache(maxsize=None)
def _slab_symbols(name: str) -> frozenset:
    """Entry points of ``csrc/<name>.cu`` whose parameters size a slab."""
    cu = CSRC / f"{name}.cu"
    if not cu.is_file():
        return frozenset()
    src = CudaSource(cu.read_text(encoding="utf-8"))
    fields = _smem_fields(src)
    if not fields:
        return frozenset()
    return frozenset(f.name for f in src.functions
                     if f.extern_c and fields <= set(f.params))


class SharedMemoryBudgetRule(Rule):
    id = "R003"
    name = "smem-budget"
    doc = __doc__
    languages = ("cu", "py")

    def check(self, mod) -> Iterator[RawFinding]:
        if isinstance(mod, ModuleInfo):
            yield from self._check_wrappers(mod)
        else:
            yield from self._check_cuda(_scan(mod.source))

    # -- CUDA side ---------------------------------------------------------
    def _check_cuda(self, src: CudaSource) -> Iterator[RawFinding]:
        hosts = [f for f in src.functions if f.kind == "host"]
        for k in src.functions:
            if k.kind != "global":
                continue
            where = src.span(k.name_pos)
            if "__launch_bounds__" not in k.header:
                yield where, (
                    f"kernel `{k.name}` has no `__launch_bounds__`: nvcc "
                    "then allots registers for any block size, and the "
                    "block size the launch uses may not fit (a launch "
                    "failure on the card only)")
            total = 0
            for off, name, size in _static_arrays(src, k):
                if size is None:
                    yield src.span(off), (
                        f"static `__shared__` array `{name}` in `{k.name}` "
                        "has a size this scanner cannot evaluate: bound it "
                        "with constants or annotate with `// lint: "
                        "ok(R003) <static bound argument>`")
                else:
                    total += size
            if total > STATIC_SMEM_BYTES:
                yield where, (
                    f"static `__shared__` arrays of `{k.name}` sum to "
                    f"{total} B, over the {STATIC_SMEM_BYTES} B a block "
                    "gets without the opt-in")
            if re.search(r"\bextern\s+__shared__", src.body(k)):
                yield from self._check_dynamic(src, k, hosts)

    def _check_dynamic(self, src, k, hosts) -> Iterator[RawFinding]:
        launchers = [h for h in hosts
                     if re.search(rf"\b{re.escape(k.name)}\b", src.body(h))]
        if not launchers:
            yield src.span(k.name_pos), (
                f"kernel `{k.name}` stages `extern __shared__` memory but no "
                "host function of this file launches it: nothing shows "
                "that its size was opted in")
        for h in launchers:
            body = src.body(h)
            if not re.search(r"cudaFuncSetAttribute\s*\([^;]*"
                             r"cudaFuncAttributeMaxDynamicSharedMemorySize",
                             body):
                yield src.span(h.name_pos), (
                    f"`{h.name}` launches `{k.name}`, which stages `extern "
                    "__shared__` memory, without `cudaFuncSetAttribute(…, "
                    "cudaFuncAttributeMaxDynamicSharedMemorySize, …)`: any "
                    f"size over {STATIC_SMEM_BYTES} B fails to launch")
            for off, _, cfg in _launches(src, h):
                if len(cfg) >= 3:
                    v = _c_eval(cfg[2], src.constants(h))
                    if v is not None and v > SMEM_OPTIN_BYTES:
                        yield src.span(off), (
                            f"launch with {v} B of dynamic shared memory, "
                            f"over the {SMEM_OPTIN_BYTES} B opt-in per "
                            "block of an H100")

    # -- Python side -------------------------------------------------------
    def _check_wrappers(self, mod: ModuleInfo) -> Iterator[RawFinding]:
        for node in ast.walk(mod.tree):
            qn = astutils.call_qualname(node, mod.aliases)
            if not (qn and qn.split(".")[-1] == "load_kernel"
                    and len(node.args) >= 2):
                continue
            name, symbol = (a.value if isinstance(a, ast.Constant) else None
                            for a in node.args[:2])
            if not (isinstance(name, str) and isinstance(symbol, str)):
                continue
            if symbol not in _slab_symbols(name):
                continue
            encl = astutils.enclosing_functions(node, mod.parents)
            scope = encl[-1] if encl else mod.tree
            if not self._bounded(mod, scope):
                yield node, (
                    f"unbounded resident block: `{symbol}` stages a "
                    "shared-memory slab sized by its arguments, but this "
                    "function derives none from `slab_cols(…, "
                    "smem_optin(…))` — a size bounded by neither fails to "
                    "launch past the card's opt-in, or reads past the slab")

    def _bounded(self, mod: ModuleInfo, scope: ast.AST) -> bool:
        def called(n, fn):
            q = astutils.call_qualname(n, mod.aliases)
            return bool(q) and q.split(".")[-1] == fn
        optin_names = {t.id for n in ast.walk(scope)
                       if isinstance(n, ast.Assign) and called(n.value,
                                                               "smem_optin")
                       for t in n.targets if isinstance(t, ast.Name)}
        for n in ast.walk(scope):
            if called(n, "slab_cols") and any(
                    called(a, "smem_optin")
                    or (isinstance(a, ast.Name) and a.id in optin_names)
                    for a in n.args):
                return True
        return False
