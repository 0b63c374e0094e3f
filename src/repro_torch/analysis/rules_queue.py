"""R006: unbounded queues / unbounded blocking in the threaded tiers.

The data pipeline (repro_torch.data's subgraph prefetch) and the serving
tier (repro_torch.serve) are the two places worker threads hand work across
``queue.Queue``s, and both advertise hard liveness guarantees: bounded
memory under producer/consumer speed mismatch, and no call that can block
forever on a dead peer (a hung worker must surface as a typed timeout, not
a wedged process — the whole point of the serving fault matrix). Two
constructs silently break that:

* an *unbounded* queue — ``queue.Queue()`` with no/zero ``maxsize`` (or a
  ``SimpleQueue``, which cannot be bounded): backpressure becomes unbounded
  RAM growth instead of load shedding;
* a *blocking* ``get()`` / ``put(item)`` / ``join()`` with no ``timeout=``:
  if the peer died, the caller blocks forever and the drain/shutdown
  protocol can never complete.

The call checks are shape heuristics (no type inference): a bare ``.get()``
with no arguments, a ``.put(x)`` with exactly one positional argument, or a
bare ``.join()`` — exactly the blocking queue/thread forms, and shapes that
dict/str/os.path calls never take. ``*_nowait``, ``block=False`` and any
``timeout=`` are compliant. Scope is ``src/repro_torch/{data,serve}`` only; a
deliberate indefinite block takes the standard audit pragma:
``# lint: ok(R006) <why blocking forever here is safe>``.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis import astutils
from repro_torch.analysis.engine import ModuleInfo, RawFinding, Rule

# queue classes whose no-maxsize construction is unbounded
_BOUNDED_CTORS = {"queue.Queue", "queue.LifoQueue", "queue.PriorityQueue"}
# queues that cannot be bounded at all
_UNBOUNDABLE_CTORS = {"queue.SimpleQueue"}

_SCOPED_DIRS = ("repro_torch/data/", "repro_torch/serve/")


def _in_scope(path: str) -> bool:
    p = path.replace("\\", "/")
    return any(d in p for d in _SCOPED_DIRS)


def _const(node: Optional[ast.AST]):
    return node.value if isinstance(node, ast.Constant) else None


class UnboundedQueueRule(Rule):
    id = "R006"
    name = "unbounded-queue"
    doc = __doc__

    def check(self, mod: ModuleInfo) -> Iterator[RawFinding]:
        if not _in_scope(mod.path):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            qn = astutils.call_qualname(node, mod.aliases)
            if qn in _UNBOUNDABLE_CTORS:
                yield node, (
                    f"`{qn}` cannot be bounded — backpressure becomes "
                    "unbounded memory growth. Use queue.Queue(maxsize=...) "
                    "so a full queue sheds/blocks-with-timeout instead")
                continue
            if qn in _BOUNDED_CTORS:
                maxsize = _ctor_maxsize(node)
                if maxsize is _MISSING or (isinstance(maxsize, int)
                                           and maxsize <= 0):
                    yield node, (
                        f"unbounded `{qn}()` — pass maxsize>0 so the "
                        "producer sees backpressure (shed or timeout) "
                        "instead of growing the queue without bound, or "
                        "annotate with `# lint: ok(R006) <why unbounded "
                        "is safe here>`")
                continue
            yield from self._blocking_call(node)

    def _blocking_call(self, node: ast.Call) -> Iterator[RawFinding]:
        func = node.func
        if not isinstance(func, ast.Attribute):
            return
        name = func.attr
        if name not in ("get", "put", "join"):
            return
        kwnames = {k.arg for k in node.keywords}
        if "timeout" in kwnames:
            return
        # block=False (kwarg or leading positional) is non-blocking
        for k in node.keywords:
            if k.arg == "block" and _const(k.value) is False:
                return
        if node.args and _const(node.args[0]) is False:
            return
        # shape heuristics: only the blocking queue/thread forms
        flagged = (
            (name == "get" and not node.args and not node.keywords)
            or (name == "put" and len(node.args) == 1 and not node.keywords)
            or (name == "join" and not node.args and not node.keywords))
        if flagged:
            yield node, (
                f"blocking `.{name}()` without `timeout=` can wedge forever "
                "on a dead peer — pass timeout= (poll loops keep shutdown "
                "responsive), use the *_nowait form, or annotate with "
                "`# lint: ok(R006) <why blocking indefinitely is safe>`")


_MISSING = object()


def _ctor_maxsize(node: ast.Call):
    """maxsize passed to a queue constructor: value, _MISSING, or None when
    it is a runtime expression (assumed bounded — conservative skip)."""
    if node.args:
        v = _const(node.args[0])
        return v if v is not None else None
    for k in node.keywords:
        if k.arg == "maxsize":
            v = _const(k.value)
            return v if v is not None else None
    return _MISSING
