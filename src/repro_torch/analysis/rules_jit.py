"""R004: host syncs and Python control flow on tensors in hot scopes.

The port's steps run eagerly, so nothing raises when a hot scope reads a
tensor on the host — it just stalls. A ``.item()``, ``.tolist()``,
``.cpu()``, ``.numpy()`` or ``torch.cuda.synchronize()`` inside a step makes
the host wait for every queued kernel before it can launch the next one
(killing the asynchronous launches the CUDA kernels rely on to hide their
latency), and a Python ``if``/``while`` on a tensor, or a
``float``/``int``/``bool`` cast of one, is the same sync hidden in a
branch; under ``torch.func`` transforms it also bakes one branch into the
traced function. This rule walks *hot scopes*:

  * ``forward``/``backward``/``setup_context`` of ``torch.autograd.Function``
    subclasses,
  * the step closures that ``make_train_step``, ``make_infer_step``,
    ``make_distributed_train_step`` and ``make_lm_{prefill,decode,train}_
    step`` return,
  * functions handed (by name) to ``torch.func.vjp`` or
    ``torch.utils.checkpoint.checkpoint``,

plus everything nested inside them, and flags the syncs above, the casts of
a parameter, and ``if``/``while`` tests that read a parameter. ``ctx``
(and ``self``) are not tensors; ``x is None``/``is not None`` tests check
structure; ``.shape``/``.ndim``/``.dtype``/``.device``/``.size``, ``len()``
and ``isinstance()`` read metadata the host already holds — all exempt.
Config values a factory closes over are not parameters of the closure, so
branches on them are free, the counterpart of the reference's static
arguments.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis import astutils
from repro_torch.analysis.engine import ModuleInfo, RawFinding, Rule

_FUNCTION = ("torch.autograd.Function", "torch.autograd.function.Function")
_FUNCTION_METHODS = ("forward", "backward", "setup_context")
_STEP_FACTORIES = ("make_train_step", "make_infer_step",
                   "make_distributed_train_step", "make_lm_prefill_step",
                   "make_lm_decode_step", "make_lm_train_step")
_TRANSFORMS = ("torch.func.vjp", "torch.utils.checkpoint.checkpoint")
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_SYNC_CALLS = ("torch.cuda.synchronize",)
_STATIC_ATTRS = ("shape", "ndim", "dtype", "device", "size")
_NOT_TENSORS = ("ctx", "self", "cls")
_CASTS = ("float", "int", "bool")


def _hot_roots(mod: ModuleInfo) -> dict[ast.AST, str]:
    """Hot top-of-scope functions -> what makes them hot."""
    roots: dict[ast.AST, str] = {}
    funcs: dict[str, ast.FunctionDef] = {}
    for f in astutils.walk_functions(mod.tree):
        funcs.setdefault(f.name, f)
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef) and any(
                astutils.qualname(b, mod.aliases) in _FUNCTION
                for b in node.bases):
            for m in node.body:
                if (isinstance(m, astutils.FunctionLike)
                        and m.name in _FUNCTION_METHODS):
                    roots[m] = f"{node.name}.{m.name}"
        elif (isinstance(node, astutils.FunctionLike)
              and node.name in _STEP_FACTORIES):
            nested = {f.name: f for f in node.body
                      if isinstance(f, astutils.FunctionLike)}
            for ret in ast.walk(node):
                if isinstance(ret, ast.Return) and ret.value is not None:
                    for n in ast.walk(ret.value):
                        if isinstance(n, ast.Name) and n.id in nested:
                            roots[nested[n.id]] = \
                                f"the step of {node.name}"
        elif isinstance(node, ast.Call):
            qn = astutils.call_qualname(node, mod.aliases)
            if (qn in _TRANSFORMS and node.args
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id in funcs):
                f = funcs[node.args[0].id]
                roots.setdefault(f, f"`{f.name}` (through {qn})")
    return roots


def _test_hazard_names(test: ast.AST, params: set) -> list[ast.Name]:
    """Parameter Names the branch test actually reads as values (not only
    inside an ``is``/``is not`` compare, a metadata attribute, ``len`` or
    ``isinstance``)."""
    exempt: set = set()
    for n in ast.walk(test):
        if isinstance(n, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops):
            for sub in ast.walk(n):
                exempt.add(id(sub))
        if isinstance(n, ast.Attribute) and n.attr in _STATIC_ATTRS:
            for sub in ast.walk(n.value):
                exempt.add(id(sub))
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id in ("len", "isinstance")):
            for arg in n.args:
                for sub in ast.walk(arg):
                    exempt.add(id(sub))
    return [n for n in ast.walk(test)
            if isinstance(n, ast.Name) and n.id in params
            and id(n) not in exempt]


class HotPathHazardRule(Rule):
    id = "R004"
    name = "hot-path-hazards"
    doc = __doc__

    def check(self, mod: ModuleInfo) -> Iterator[RawFinding]:
        seen: set = set()
        for root, what in _hot_roots(mod).items():
            params = {p for f in [root, *astutils.walk_functions(root)]
                      for p in astutils.param_names(f)
                      if p not in _NOT_TENSORS}
            for where, msg in self._check_scope(mod, root, what, params):
                key = (where.lineno, where.col_offset, msg)
                if key not in seen:   # a scope nested in another root
                    seen.add(key)
                    yield where, msg

    def _check_scope(self, mod: ModuleInfo, root: ast.FunctionDef,
                     what: str, params: set) -> Iterator[RawFinding]:
        for node in ast.walk(root):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SYNC_METHODS and not node.args
                    and not node.keywords):
                yield node, (f"`.{node.func.attr}()` inside {what} makes "
                             "the host wait for the device (a sync per "
                             "call) — keep the value on the device or "
                             "hoist the read out of the step")
                continue
            qn = astutils.call_qualname(node, mod.aliases)
            if qn in _SYNC_CALLS:
                yield node, (f"`{qn}()` inside {what} stalls the host "
                             "until every queued kernel finished")
                continue
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id in _CASTS and len(node.args) == 1
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id in params):
                yield node, (f"`{node.func.id}({node.args[0].id})` on a "
                             f"parameter of {what} reads a tensor on the "
                             "host (a sync per call)")
                continue
            if isinstance(node, (ast.If, ast.While)):
                hazards = _test_hazard_names(node.test, params)
                if hazards:
                    names = ", ".join(sorted({n.id for n in hazards}))
                    kind = "if" if isinstance(node, ast.If) else "while"
                    yield node, (
                        f"Python `{kind}` on parameter(s) `{names}` inside "
                        f"{what} — a tensor there is read on the host (a "
                        "sync) and a torch.func trace keeps one branch; "
                        "use `torch.where`, or branch on a value the "
                        "factory closes over")
