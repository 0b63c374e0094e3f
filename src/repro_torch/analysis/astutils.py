"""Shared AST machinery for the rule modules (a copy of the reference's
helpers; this package imports nothing of ``repro``).

Everything here is deliberately conservative: name resolution follows import
aliases only (no cross-module inference), so ``import torch.nn.functional as
F`` makes ``F.pad`` read ``torch.nn.functional.pad`` and ``from
torch.utils.checkpoint import checkpoint`` makes ``checkpoint`` read
``torch.utils.checkpoint.checkpoint``; the constant evaluator returns ``None``
the moment an expression depends on a runtime value. Rules are written so
that "could not resolve" maps to either "skip" (R005 arity on a computed
return) or "flag" (R003 on a shared-memory size bounded by nothing) depending
on which direction is safe for the invariant.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional


def build_parents(tree: ast.AST) -> dict[ast.AST, ast.AST]:
    """child -> parent map for the whole tree."""
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def import_aliases(tree: ast.AST) -> dict[str, str]:
    """Local name -> fully dotted origin, following `import x.y as z` and
    `from x.y import z [as w]`. `from . import z` resolves to just `z`."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            for a in node.names:
                if a.name == "*":
                    continue
                full = f"{base}.{a.name}" if base else a.name
                aliases[a.asname or a.name] = full
    return aliases


def qualname(node: ast.AST, aliases: dict[str, str]) -> Optional[str]:
    """Dotted name of a Name/Attribute chain with the root resolved through
    the import aliases: `F.pad` -> `torch.nn.functional.pad`."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    root = aliases.get(node.id, node.id)
    parts.append(root)
    return ".".join(reversed(parts))


def call_qualname(node: ast.AST, aliases: dict[str, str]) -> Optional[str]:
    if isinstance(node, ast.Call):
        return qualname(node.func, aliases)
    return None


def const_eval(node: ast.AST, env: dict[str, int]) -> Optional[int]:
    """Evaluate an int expression from literals + `env`; None if runtime."""
    if isinstance(node, ast.Constant):
        return node.value if isinstance(node.value, int) else None
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = const_eval(node.operand, env)
        return None if v is None else -v
    if isinstance(node, ast.BinOp):
        lhs, rhs = const_eval(node.left, env), const_eval(node.right, env)
        if lhs is None or rhs is None:
            return None
        try:
            if isinstance(node.op, ast.Add):
                return lhs + rhs
            if isinstance(node.op, ast.Sub):
                return lhs - rhs
            if isinstance(node.op, ast.Mult):
                return lhs * rhs
            if isinstance(node.op, ast.FloorDiv):
                return lhs // rhs
            if isinstance(node.op, ast.Mod):
                return lhs % rhs
            if isinstance(node.op, ast.Pow):
                return lhs ** rhs
        except (ZeroDivisionError, OverflowError):
            return None
    return None


def const_eval_dims(node: ast.AST, env: dict[str, int]
                    ) -> Optional[list[Optional[int]]]:
    """A literal tuple/list of dim expressions -> per-dim ints (None where a
    dim is runtime-valued); None when the node is not a tuple/list at all."""
    if not isinstance(node, (ast.Tuple, ast.List)):
        return None
    return [const_eval(el, env) for el in node.elts]


def param_default_env(func: ast.FunctionDef) -> dict[str, int]:
    """Int-valued parameter defaults: the static size knobs
    (`block_rows: int = 256`) that launch shapes are built from."""
    env: dict[str, int] = {}
    args = func.args
    pos = args.posonlyargs + args.args
    for arg, default in zip(pos[len(pos) - len(args.defaults):], args.defaults):
        if isinstance(default, ast.Constant) and isinstance(default.value, int):
            env[arg.arg] = default.value
    for arg, default in zip(args.kwonlyargs, args.kw_defaults):
        if (default is not None and isinstance(default, ast.Constant)
                and isinstance(default.value, int)):
            env[arg.arg] = default.value
    return env


def module_const_env(tree: ast.Module) -> dict[str, int]:
    """Top-level `NAME = <int literal>` assignments."""
    env: dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant):
            if isinstance(node.value.value, int):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        env[tgt.id] = node.value.value
    return env


FunctionLike = (ast.FunctionDef, ast.AsyncFunctionDef)


def walk_functions(tree: ast.AST) -> Iterator[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, FunctionLike):
            yield node


def param_names(func: ast.FunctionDef) -> list[str]:
    a = func.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]


def enclosing_functions(node: ast.AST, parents: dict[ast.AST, ast.AST]
                        ) -> list[ast.FunctionDef]:
    """Innermost-first chain of function defs containing `node`."""
    chain = []
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, FunctionLike):
            chain.append(cur)
        cur = parents.get(cur)
    return chain


def decorator_info(func: ast.FunctionDef, aliases: dict[str, str]
                   ) -> list[tuple[str, Optional[ast.Call]]]:
    """(qualname, call-node-or-None) per decorator. For
    `functools.partial(f, ...)` the qualname reported is `f`'s and the call
    node is the partial call (whose keywords carry the bound arguments)."""
    out: list[tuple[str, Optional[ast.Call]]] = []
    for dec in func.decorator_list:
        if isinstance(dec, ast.Call):
            qn = qualname(dec.func, aliases)
            if qn == "functools.partial" and dec.args:
                inner = qualname(dec.args[0], aliases)
                if inner is not None:
                    out.append((inner, dec))
                    continue
            if qn is not None:
                out.append((qn, dec))
        else:
            qn = qualname(dec, aliases)
            if qn is not None:
                out.append((qn, None))
    return out


def str_elements(node: ast.AST) -> Optional[list[str]]:
    """A string literal or a tuple/list of them -> list of strings."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        vals = []
        for el in node.elts:
            if not (isinstance(el, ast.Constant) and isinstance(el.value, str)):
                return None
            vals.append(el.value)
        return vals
    return None
