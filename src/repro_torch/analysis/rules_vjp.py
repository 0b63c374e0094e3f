"""R005: forward/backward arity consistency of ``torch.autograd.Function``s.

Every hand-written gradient of the port flows through
``torch.autograd.Function`` subclasses (kernels/ops.py, models/layers.py,
models/blocks.py, dist/sharding.py), and torch checks little of the contract
before the first backward: a ``backward`` returning the wrong number of
gradients raises only when it runs, a tensor added to ``save_for_backward``
while an unpack of ``ctx.saved_tensors`` kept its old arity fails at the
first differentiation, and a gradient that lands in the wrong slot of the
returned tuple is silently applied to the wrong input — for the LMC
compensation path that means Thm. 2's convergence guarantee quietly no
longer applies. For each subclass, where its pieces are literal:

  * the inputs are ``forward``'s parameters less ``ctx`` (old style) or all
    of them (with ``setup_context``); where ``setup_context`` unpacks its
    ``inputs`` parameter into a literal tuple, that tuple has exactly as
    many targets;
  * ``setup_context`` takes exactly 3 parameters ``(ctx, inputs, output)``;
  * every literal tuple ``backward`` returns has one gradient per input;
  * when every ``ctx.save_for_backward(...)`` of the class saves the same
    literal number R of tensors, every tuple unpacking of
    ``ctx.saved_tensors`` has exactly R targets;
  * when ``forward``'s returns are literal tuples of k outputs,
    ``backward`` takes ``ctx`` plus k cotangents.

Computed returns and unpacks (``return helper(...)``, starred elements,
``*args`` inputs) are skipped, not guessed.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis import astutils
from repro_torch.analysis.engine import ModuleInfo, RawFinding, Rule

_FUNCTION = ("torch.autograd.Function", "torch.autograd.function.Function")


def _literal_len(node: Optional[ast.AST]) -> Optional[int]:
    """Element count of a literal tuple/list without starred elements."""
    if isinstance(node, (ast.Tuple, ast.List)) and not any(
            isinstance(e, ast.Starred) for e in node.elts):
        return len(node.elts)
    return None


def _returns(func: ast.FunctionDef) -> list[ast.Return]:
    """Return statements belonging to `func` itself (not nested defs)."""
    out = []
    stack = list(func.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (*astutils.FunctionLike, ast.Lambda,
                             ast.ClassDef)):
            continue
        if isinstance(node, ast.Return):
            out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _unpacks_of(func: ast.FunctionDef, is_source) -> list[ast.Assign]:
    """`a, b = <source>` assignments in `func` whose value `is_source`."""
    return [n for n in ast.walk(func)
            if isinstance(n, ast.Assign) and len(n.targets) == 1
            and isinstance(n.targets[0], (ast.Tuple, ast.List))
            and is_source(n.value)]


def _is_name(name: str):
    return lambda v: isinstance(v, ast.Name) and v.id == name


def _is_saved_tensors(v: ast.AST) -> bool:
    return isinstance(v, ast.Attribute) and v.attr == "saved_tensors"


class AutogradArityRule(Rule):
    id = "R005"
    name = "autograd-arity"
    doc = __doc__

    def check(self, mod: ModuleInfo) -> Iterator[RawFinding]:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef) and any(
                    astutils.qualname(b, mod.aliases) in _FUNCTION
                    for b in node.bases):
                yield from self._check_class(node)

    def _check_class(self, cls: ast.ClassDef) -> Iterator[RawFinding]:
        methods = {n.name: n for n in cls.body
                   if isinstance(n, astutils.FunctionLike)}
        fwd, bwd = methods.get("forward"), methods.get("backward")
        setup = methods.get("setup_context")
        if fwd is None:
            return
        n_in = self._inputs(fwd, setup)
        if setup is not None:
            n_setup = len(astutils.param_names(setup))
            if n_setup != 3 or setup.args.vararg:
                yield setup, (
                    f"`{cls.name}.setup_context` takes {n_setup} "
                    "parameter(s), expected 3 `(ctx, inputs, output)`")
            else:
                inputs = astutils.param_names(setup)[1]
                for asg in _unpacks_of(setup, _is_name(inputs)):
                    got = _literal_len(asg.targets[0])
                    if got is not None and n_in is not None and got != n_in:
                        yield fwd, (
                            f"`{cls.name}.setup_context` unpacks {got} "
                            f"input(s) from `{inputs}` but `forward` takes "
                            f"{n_in} — the two signatures drifted apart")
                        n_in = None   # which one is right is not knowable
        if bwd is None:
            return
        if n_in is not None:
            for ret in _returns(bwd):
                got = _literal_len(ret.value)
                if got is not None and got != n_in:
                    yield ret, (
                        f"`{cls.name}.backward` returns {got} gradient(s), "
                        f"expected {n_in} (one per input of `forward`)")
        n_out = self._outputs(fwd)
        if n_out is not None and not bwd.args.vararg:
            n_bwd = len(astutils.param_names(bwd))
            if n_bwd != n_out + 1:
                yield bwd, (
                    f"`{cls.name}.backward` takes {n_bwd} parameter(s), "
                    f"expected {n_out + 1} (ctx + one cotangent per output "
                    "of `forward`)")
        yield from self._check_saved(cls, methods, bwd)

    def _inputs(self, fwd: ast.FunctionDef,
                setup: Optional[ast.FunctionDef]) -> Optional[int]:
        if fwd.args.vararg:
            return None
        n = len(astutils.param_names(fwd))
        return n if setup is not None else n - 1

    def _outputs(self, fwd: ast.FunctionDef) -> Optional[int]:
        """k when every return of forward is a literal k-tuple."""
        lens = {_literal_len(r.value) for r in _returns(fwd)}
        if len(lens) == 1 and None not in lens:
            return lens.pop()
        return None

    def _check_saved(self, cls, methods, bwd) -> Iterator[RawFinding]:
        saved = set()
        for m in methods.values():
            if m is bwd:
                continue
            for n in ast.walk(m):
                if (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "save_for_backward"):
                    if n.keywords or any(isinstance(a, ast.Starred)
                                         for a in n.args):
                        return   # computed arity: skipped
                    saved.add(len(n.args))
        if len(saved) != 1:
            return
        n_saved = saved.pop()
        for asg in _unpacks_of(bwd, _is_saved_tensors):
            got = _literal_len(asg.targets[0])
            if got is not None and got != n_saved:
                yield asg, (
                    f"`{cls.name}.backward` unpacks {got} tensor(s) from "
                    f"`ctx.saved_tensors` but `save_for_backward` saves "
                    f"{n_saved} — the saved tuple and this unpack drifted "
                    "apart")
