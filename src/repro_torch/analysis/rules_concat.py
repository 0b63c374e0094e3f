"""R001: raw torch concatenates/stacks on the DTensor path outside the
sharding subsystem.

On a device mesh the LM's tensors are DTensors, and DTensor's rules for
``cat``/``stack`` differ between torch releases (2.11 on the card, 2.13 on
the CPU where the tests run): where a release has no rule for the operands'
placements it redistributes them implicitly, and that hides an all-gather
inside an innocent-looking line (ROADMAP C). ``repro_torch.dist.sharding.
concat_rows`` states the result's placements instead (the reference's result
layout) and is ``torch.cat`` off the mesh, so every ``torch.cat``/``concat``/
``concatenate``/``stack``/``hstack``/``vstack``/``dstack``/``column_stack``/
``row_stack`` call in scope must either route through ``concat_rows`` or
carry a pragma saying why a DTensor never reaches it (e.g. the operands are
local shards).

Scope is the code a DTensor reaches: ``src/repro_torch/{models,launch,
optim,dist}``, where ``dist/sharding.py`` is the one module allowed the raw
call (``concat_rows``' own body). The GNN core (``core/``, ``kernels/``,
``graph/``, ``train/``, ``serve/``, ``data/``) runs one process per device on
plain tensors — its distributed step exchanges rows of plain tensors through
``torch.distributed`` — so it is not this rule's business.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis import astutils
from repro_torch.analysis.engine import ModuleInfo, RawFinding, Rule

_BANNED = {"torch." + fn for fn in (
    "cat", "concat", "concatenate", "stack", "hstack", "vstack", "dstack",
    "column_stack", "row_stack")}

_SCOPED_DIRS = ("repro_torch/models/", "repro_torch/launch/",
                "repro_torch/optim/", "repro_torch/dist/")
# concat_rows' own module (its off-mesh body is the raw call)
_ALLOWED_SUFFIXES = ("repro_torch/dist/sharding.py",)


def _in_scope(path: str) -> bool:
    p = path.replace("\\", "/")
    return any(d in p for d in _SCOPED_DIRS) and \
        not p.endswith(_ALLOWED_SUFFIXES)


class ShardedConcatRule(Rule):
    id = "R001"
    name = "sharded-concat"
    doc = __doc__

    def check(self, mod: ModuleInfo) -> Iterator[RawFinding]:
        if not _in_scope(mod.path):
            return
        for node in ast.walk(mod.tree):
            qn = astutils.call_qualname(node, mod.aliases)
            if qn in _BANNED:
                short = qn.split(".")[-1]
                yield node, (
                    f"raw `torch.{short}` on the DTensor path outside "
                    "dist/sharding.py: DTensor's concat rules differ "
                    "between torch releases and an implicit redistribution "
                    "hides a gather. Route through "
                    "repro_torch.dist.sharding.concat_rows, or annotate "
                    "with `# lint: ok(R001) <why no DTensor reaches it>`")
