"""Sharding: one place that maps tensors onto mesh axes or process ranks.

Two halves, as in ``repro.dist.sharding``.

**The LM half: DTensor placements on a device mesh.** Meshes use up to three
named axes (``pod``, ``data``, ``model``; ``dist.mesh``). Model code never
names mesh axes: it labels tensor dims with the logical tags ``"dp"`` (rows:
the pod×data product), ``"model"`` or ``None`` and calls :func:`shard_act`,
which resolves the labels against the mesh registered with
:func:`activation_sharding` and redistributes a ``DTensor`` to the resolved
placements. Off-mesh, and on a mesh of one rank, the constraints are the
identity. A label whose axes are absent, already used by an earlier dim,
trivial (size 1) or do not divide the dim is dropped (:func:`resolve_spec`),
so DTensor's uneven sharding is never asked for. Tensors the model creates
(masks, positions, accumulators) come from :func:`mesh_tensor`, which puts
them on the mesh of the operand they meet.

**The GNN half: row blocks over a process group.** Where the reference
shards the node axis of the stores and features over the ``data`` axis of a
device mesh (``row_sharding``, ``store_sharding``), the distributed LMC step
gives each rank of a ``torch.distributed`` group one contiguous block of
node rows. Rank ``r`` of ``world`` owns rows ``[r·b, min(n, (r+1)·b))``
with ``b = ceil(n / world)``, so every block but the last has ``b`` rows
and the last is short (or empty).

A *placement* of an LMC state tree says which leaves are row-blocked and
which are replicated: a tree of the same structure whose leaves are the node
axis of a row-blocked leaf (an ``int``) or ``None`` for a replicated one. The
stores ``h`` and ``v`` and the features ``x`` and ``self_w`` are
row-blocked; parameters and optimizer state are replicated
(:func:`lmc_placement`, the counterpart of ``spmd_shardings``).

On a row × feature process grid (``data`` × ``model``, ``pod`` folded into
the rows; ``dist.mesh.grid_groups``) the stores are blocked on both: rank
(r, c) holds row block r of feature block c, by the same ceil rule over the
feature group. Their placement leaf is a :class:`GridAxes`;
``lmc_placement(tree, features=True)`` names it. ``x`` and ``self_w`` stay
row-blocked, whole in their features, as the reference places them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

DATA_AXES = ("pod", "data")
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class GridAxes:
    """The placement of a leaf blocked over a row × feature grid: its node
    axis ``row`` over the row group, its feature axis ``feature`` over the
    feature group."""
    row: int
    feature: int


# node axis of each row-blocked leaf of an LMC state tree
ROW_AXES = {"store": (1, 1), "x": 0, "self_w": 0}
# the same on a row × feature grid: the stores (L, n, d) on both axes
GRID_AXES = {"store": (GridAxes(1, 2), GridAxes(1, 2)), "x": 0, "self_w": 0}


def distributed(group=None) -> bool:
    """True when ``group`` is given or a default process group exists."""
    return group is not None or (dist.is_available()
                                 and dist.is_initialized())


def dp_axis_size(x=None) -> int:
    """Row-parallel ways. Of a ``DeviceMesh``: the product of its pod and
    data axes. Of a process group: its world size. Given neither: the
    registered mesh's, else the default group's world size, else 1."""
    if x is None:
        x = current_mesh()
    if isinstance(x, DeviceMesh) or hasattr(x, "axis_names"):
        names, sizes = _axes(x)
        return int(np.prod([sizes[names.index(a)] for a in data_axes(x)],
                           initial=1))
    return dist.get_world_size(x) if distributed(x) else 1


def dp_rank(group=None) -> int:
    """This process's rank in ``group``; 0 without a group."""
    return dist.get_rank(group) if distributed(group) else 0


def block_size(n: int, world: int) -> int:
    """Rows per block: ``ceil(n / world)``."""
    return -(-int(n) // int(world))


def row_block(n: int, world: int, rank: int) -> tuple[int, int]:
    """``(start, stop)`` of rank ``rank``'s contiguous block of ``n`` rows;
    the last block is short, and empty when ``world`` blocks overshoot."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    b = block_size(n, world)
    return min(n, rank * b), min(n, (rank + 1) * b)


def owner_of(gids, n: int, world: int):
    """The rank that owns each global row id in ``gids`` (numpy array or
    tensor, same kind back). Ids must lie in ``[0, n)``."""
    b = block_size(n, world)
    if isinstance(gids, torch.Tensor):
        return torch.div(gids.long(), b, rounding_mode="floor")
    return np.asarray(gids, np.int64) // b


def lmc_placement(tree: dict, *, features: bool = False) -> dict:
    """The placement of an LMC state tree, a dict with some of the keys
    ``params``, ``opt`` (replicated: every rank applies the same all-reduced
    update), ``store`` (``(h, v)``, row-blocked on axis 1; with
    ``features``, also feature-blocked on axis 2: :class:`GridAxes`), ``x``
    and ``self_w`` (row-blocked on axis 0). Other keys are replicated."""
    axes = GRID_AXES if features else ROW_AXES

    def replicated(t):
        if isinstance(t, dict):
            return {k: replicated(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(replicated(v) for v in t)
        return None

    return {k: axes[k] if k in axes else replicated(v)
            for k, v in tree.items()}


def take_block(leaf, axis, world: int, rank: int, model_world: int = 1,
               model_rank: int = 0):
    """Rank ``rank``'s row block of ``leaf`` along ``axis`` (the whole leaf
    when ``axis`` is None). For a :class:`GridAxes` placement, row block
    ``rank`` of ``world`` and feature block ``model_rank`` of
    ``model_world``."""
    if axis is None:
        return leaf
    if isinstance(axis, GridAxes):
        rows = take_block(leaf, axis.row, world, rank)
        return take_block(rows, axis.feature, model_world, model_rank)
    start, stop = row_block(leaf.shape[axis], world, rank)
    idx = [slice(None)] * leaf.ndim
    idx[axis] = slice(start, stop)
    return leaf[tuple(idx)]


# ------------------------------------------------------- mesh-context registry
class _MeshStack(threading.local):
    def __init__(self):
        self.stack: list = []


_CTX = _MeshStack()


def current_mesh() -> Optional[DeviceMesh]:
    """The mesh activations shard against (innermost
    :func:`activation_sharding`), or None off-mesh."""
    return _CTX.stack[-1] if _CTX.stack else None


@contextlib.contextmanager
def activation_sharding(mesh: Optional[DeviceMesh]):
    """Register ``mesh`` as the target of :func:`shard_act` /
    :func:`shard_res` / :func:`concat_rows` in the dynamic extent;
    ``activation_sharding(None)`` disables sharding inside it."""
    _CTX.stack.append(mesh)
    try:
        yield mesh
    finally:
        _CTX.stack.pop()


# ------------------------------------------------------------ axis arithmetic
def _axes(mesh) -> tuple[tuple, tuple]:
    """(axis names, sizes) of a ``DeviceMesh`` or of any object with the
    reference mesh's ``axis_names`` and ``devices.shape``."""
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape)
    return tuple(mesh.axis_names), tuple(mesh.devices.shape)


def data_axes(mesh) -> tuple:
    """The row-parallel axes present in ``mesh``, in (pod, data) order."""
    names = _axes(mesh)[0]
    return tuple(a for a in DATA_AXES if a in names)


def dp_entry(mesh):
    """Spec entry of the fused row axis: a tuple, a name, or None."""
    axes = data_axes(mesh)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def model_axis_size(mesh=None) -> int:
    """Size of the model (tensor / sequence-parallel) axis; 1 off-mesh."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return 1
    names, sizes = _axes(mesh)
    return int(sizes[names.index(MODEL_AXIS)]) if MODEL_AXIS in names else 1


def resolve_axes(axis_names: Sequence[str], sizes: Sequence[int],
                 dims: Sequence[int], axes_per_dim: Sequence,
                 *, drop_trivial: bool) -> tuple:
    """The mesh axes (a tuple, maybe empty) each tensor dim shards over.

    ``axes_per_dim`` gives the wanted axes of each dim (a tuple or None).
    Axes absent from the mesh or already used by an earlier dim are left
    out; the dim is left unsharded when none remain, when the remaining
    axes do not divide it, or (``drop_trivial``) when their product is 1.
    """
    size = dict(zip(axis_names, sizes))
    used: set = set()
    out = []
    for dim, want in zip(dims, axes_per_dim):
        axes = tuple(a for a in (want or ()) if a in size and a not in used)
        total = int(np.prod([size[a] for a in axes], initial=1))
        if not axes or int(dim) % total or (drop_trivial and total == 1):
            out.append(())
            continue
        used.update(axes)
        out.append(axes)
    return tuple(out)


def resolve_spec(axis_names: Sequence[str], sizes: Sequence[int],
                 dims: Sequence[int], labels: Sequence) -> tuple:
    """Per-dim mesh axes of activation labels (``"dp"`` | axis name |
    None), with the reference's drop rules (``repro.dist.sharding.
    resolve_spec``): a pure function of the mesh's names and sizes."""
    wanted = [None if lbl is None else
              tuple(a for a in DATA_AXES if a in axis_names) if lbl == "dp"
              else (lbl,) for lbl in labels]
    return resolve_axes(axis_names, sizes, dims, wanted, drop_trivial=True)


def axes_to_placements(mesh, dim_axes: Sequence) -> list:
    """One ``Shard(d)`` / ``Replicate()`` per axis of ``mesh`` from
    per-tensor-dim axis tuples. A dim over several axes shards over them in
    mesh order (pod-major for ``("pod", "data")``, as a ``PartitionSpec``
    does). An axis of one rank splits nothing and is ``Replicate()`` (the
    same layout; DTensor's view rules refuse some shards over it)."""
    names, sizes = _axes(mesh)
    out = [Replicate() for _ in names]
    for d, axes in enumerate(dim_axes):
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {d} are not in mesh order "
                             f"{names}")
        for i in idx:
            if sizes[i] > 1:
                out[i] = Shard(d)
    return out


def placements(mesh, dims: Sequence[int], labels: Sequence) -> list:
    """The placements of a tensor of shape ``dims`` labelled ``labels``."""
    names, sizes = _axes(mesh)
    return axes_to_placements(mesh, resolve_spec(names, sizes, dims, labels))


def local_shape(mesh, shape: Sequence[int], plc: Sequence) -> tuple:
    """This rank's shard shape of a tensor of ``shape`` under ``plc`` (every
    sharded dim divides evenly, as resolution guarantees)."""
    names, sizes = _axes(mesh)
    out = [int(s) for s in shape]
    for size, p in zip(sizes, plc):
        if isinstance(p, Shard):
            out[p.dim] //= int(size)
    return tuple(out)


# --------------------------------------------------------- constraint helpers
def _on(mesh) -> bool:
    return mesh is not None and mesh.size() > 1


def shard_act(x: torch.Tensor, *labels) -> torch.Tensor:
    """Redistribute activation ``x`` (one label per dim) to the resolved
    placements; the identity off-mesh, on a mesh of one rank, or when every
    label resolves to None. On a mesh ``x`` must be a DTensor on it."""
    mesh = current_mesh()
    if not _on(mesh):
        return x
    if len(labels) != x.ndim:
        raise ValueError(
            f"shard_act: {len(labels)} labels for rank-{x.ndim} tensor "
            f"(shape {tuple(x.shape)}, labels {labels})")
    if not isinstance(x, DTensor):
        raise TypeError(f"shard_act: a plain tensor of shape "
                        f"{tuple(x.shape)} met the mesh {mesh}")
    names, sizes = _axes(mesh)
    axes = resolve_spec(names, sizes, x.shape, labels)
    if not any(axes):
        return x
    return x.redistribute(mesh, axes_to_placements(mesh, axes))


def shard_res(x: torch.Tensor) -> torch.Tensor:
    """Residual-stream policy for (B, S, d): rows over dp, sequence over
    ``model`` when S divides it (sequence parallelism between blocks)."""
    if x.ndim == 3:
        return shard_act(x, "dp", MODEL_AXIS, None)
    return shard_act(x, "dp", *(None,) * (x.ndim - 1))


def whole(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x`` with ``dims`` unsharded (Replicate on the mesh axes that shard
    them; other placements kept); a plain tensor as it is. For the sites
    where a DTensor view or op has no rule for a sharded dim."""
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    plc = [Replicate() if isinstance(p, Shard) and p.dim in dims else p
           for p in x.placements]
    if plc == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, plc)


def along(x: torch.Tensor, fn: Callable, *dims: int) -> torch.Tensor:
    """``fn(x)`` for an op that works along ``dims`` only and that DTensor
    has no (working) sharding rule for, forward or backward: ``dims`` are
    gathered whole (:func:`whole`) and ``fn`` runs on the local shards,
    whose other placements its result (a tensor or a tuple) keeps. A plain
    tensor: ``fn(x)``."""
    if not isinstance(x, DTensor):
        return fn(x)
    x = whole(x, *dims)
    out = fn(x.to_local())

    def wrap(o):
        return DTensor.from_local(o, x.device_mesh, x.placements,
                                  run_check=False)
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def pad(x: torch.Tensor, widths: Sequence[int]) -> torch.Tensor:
    """``F.pad(x, widths)`` with zeros. On a DTensor the padded dims are
    gathered whole and the pad runs on the local shards (:func:`along`):
    DTensor's rule for pad builds a wrong placement list in some torch
    releases."""
    dims = [x.ndim - 1 - i // 2 for i in range(0, len(widths), 2)
            if widths[i] or widths[i + 1]]
    return along(x, lambda t: F.pad(t, tuple(widths)), *dims)


def concat_rows(parts: Sequence[torch.Tensor], axis: int = 0,
                labels: Optional[Sequence] = None) -> torch.Tensor:
    """``torch.cat`` whose result, on a mesh, is pinned to the placements
    of ``labels`` (one per result dim; default ``"dp"`` on ``axis``,
    replicated elsewhere), even when they all resolve to Replicate: the
    reference's result layout. Off-mesh this is ``torch.cat``."""
    out = torch.cat(list(parts), dim=axis)
    mesh = current_mesh()
    if not _on(mesh):
        return out
    if labels is None:
        labels = [None] * out.ndim
        labels[axis % out.ndim] = "dp"
    return out.redistribute(mesh, placements(mesh, out.shape, labels))


def mesh_tensor(ref: torch.Tensor, make: Callable, shape: Sequence[int],
                labels: Optional[Sequence] = None) -> torch.Tensor:
    """A tensor the model creates (a mask, positions, an accumulator), on
    the mesh of the operand ``ref`` it meets.

    ``make(shape)`` builds a block of the given shape on ``ref.device``.
    When ``ref`` is a plain tensor that is the whole tensor. When ``ref``
    is a DTensor the result is a DTensor on its mesh: replicated, or with
    ``labels`` resolved against that mesh, in which case ``make``
    gets this rank's shard shape and must fill it with a constant (no
    tensor of the full shape is made).
    """
    if not isinstance(ref, DTensor):
        return make(tuple(shape))
    mesh = ref.device_mesh
    plc = ([Replicate()] * mesh.ndim if labels is None
           else placements(mesh, shape, labels))
    loc = make(local_shape(mesh, shape, plc))
    return DTensor.from_local(loc, mesh, plc, run_check=False)


def _expand_ellipsis(eq: str, ops: Sequence[torch.Tensor]) -> tuple:
    """(input subscripts, output subscripts) of ``eq`` with any ``...``
    spelled out in letters no subscript uses."""
    lhs, out = eq.replace(" ", "").split("->")
    ins = lhs.split(",")
    if "..." not in eq:
        return ins, out
    spare = [c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ" if c not in eq]
    n = max(op.ndim - len(sub.replace("...", ""))
            for sub, op in zip(ins, ops) if "..." in sub)
    fill = "".join(spare[:n])
    ins = [sub.replace("...", fill[n - (op.ndim - len(sub) + 3):])
           for sub, op in zip(ins, ops)]
    return ins, out.replace("...", fill)


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of DTensors on one mesh, computed on their local
    shards.

    For each mesh axis of more than one rank it keeps one subscript
    sharded over it: of those the operands already shard on that axis, the
    one whose operands hold the most bytes in place, and only where every
    operand with that subscript can be sharded on it evenly. On the row
    axes that keeps the activation's rows and gathers an FSDP weight, as
    the reference's plan does. On ``model`` the reference keeps a weight's
    tensor-parallel subscript (the MLP's hidden dim, the vocabulary) and
    gathers the activation's sequence shard; bytes alone would choose the
    other way, so those callers gather the sequence first
    (``layers.swiglu``, ``LM._logits``) and leave the weight's subscript
    the only one held there. Each operand is redistributed explicitly to
    that layout, the einsum runs on the local shards, and the result is a
    DTensor sharded on the kept output subscripts and ``Partial`` over
    axes whose kept subscript was contracted. Gradients flow through
    ``redistribute``, ``to_local`` (an operand that lacks a kept subscript
    gets a ``Partial`` gradient) and ``from_local``. DTensor's own einsum
    decomposition would reshape sharded dims together into strided shards
    and search for a plan; this never does.
    """
    if not all(isinstance(o, DTensor) for o in ops):
        raise TypeError("einsum: mixed DTensor and plain operands")
    mesh = ops[0].device_mesh
    ins, out = _expand_ellipsis(eq, ops)
    sizes = tuple(mesh.mesh.shape)
    ops = [o.redistribute(mesh, [Replicate() if p.is_partial() else p
                                 for p in o.placements])
           if any(p.is_partial() for p in o.placements) else o for o in ops]
    dim_of = {c: o.shape[sub.index(c)] for sub, o in zip(ins, ops) for c in sub}
    ways = {c: 1 for c in dim_of}                 # shards of each subscript
    keep: list = []
    for a in range(mesh.ndim):
        held: dict = {}
        for sub, o in zip(ins, ops):
            p = o.placements[a]
            if isinstance(p, Shard):
                c = sub[p.dim]
                held[c] = held.get(c, 0) + o.to_local().numel() * o.itemsize
        choice = None
        for c in sorted(held, key=lambda c: -held[c]):
            if sizes[a] > 1 and dim_of[c] % (ways[c] * sizes[a]) == 0:
                choice = c
                break
        if choice is not None:
            ways[choice] *= sizes[a]
        keep.append(choice)
    locs = []
    for sub, o in zip(ins, ops):
        plc = [Shard(sub.index(c)) if c is not None and c in sub
               else Replicate() for c in keep]
        grad = [p if isinstance(p, Shard) else Partial() if c is not None
                else Replicate() for p, c in zip(plc, keep)]
        x = o if list(o.placements) == plc else o.redistribute(mesh, plc)
        locs.append(x.to_local(grad_placements=grad))
    res = torch.einsum(f"{','.join(ins)}->{out}", *locs)
    summed = [a for a, c in enumerate(keep) if c is not None and c not in out]
    if summed:
        res = _AllReduce.apply(res, mesh, tuple(summed))
    plc = [Shard(out.index(c)) if c is not None and c in out else Replicate()
           for c in keep]
    return DTensor.from_local(res, mesh, plc, run_check=False)


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """A local tensor reduced over ``mesh``'s ``axes`` (every rank gets the
    result); a sum's gradient is the identity, a max is not differentiated."""
    if not axes:
        return x
    if op == "sum":
        return _AllReduce.apply(x, mesh, tuple(axes))
    from torch.distributed import _functional_collectives as funcol
    x = x.detach()
    for a in axes:
        x = funcol.all_reduce(x, op, (mesh, a))
    return x


class _AllReduce(torch.autograd.Function):
    """Sum of a local tensor over mesh axes, every rank getting the sum.
    Its gradient is the identity: each rank's term enters the sum once and
    the sum's gradient is the same on every rank. (A ``Partial`` result
    would do the sum later, but its gradient must then be turned back into
    ``Partial``, which some torch releases refuse from a shard.)"""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        from torch.distributed import _functional_collectives as funcol
        for a in axes:
            x = funcol.all_reduce(x, "sum", (mesh, a))
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None, None


# ------------------------------------------------------ placement factories
def named(mesh, *entries) -> list:
    """Placements from ``PartitionSpec``-style entries (None, an axis name
    or a tuple of names, one per tensor dim)."""
    names = _axes(mesh)[0]
    dim_axes = [() if e is None else (e,) if isinstance(e, str) else tuple(e)
                for e in entries]
    return axes_to_placements(mesh, dim_axes)


def replicated(mesh) -> list:
    return named(mesh)


def row_sharding(mesh) -> list:
    """Per-row 1-D tensors (gids, masks, edge lists): leading dim over dp."""
    return named(mesh, dp_entry(mesh))


def store_sharding(mesh, *, model_axis: Optional[str] = MODEL_AXIS,
                   leading_dims: int = 1) -> list:
    """LMC historical stores ``(L, n, d)``: node axis over dp, feature
    axis over ``model_axis`` when the mesh has it."""
    feat = model_axis if model_axis in _axes(mesh)[0] else None
    return named(mesh, *(None,) * leading_dims, dp_entry(mesh), feat)


# ---------------------------------------------------------- trees of DTensors
def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)) and not _is_placements(tree):
        return type(tree)(_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _is_placements(x) -> bool:
    return isinstance(x, (list, tuple)) and all(
        isinstance(p, (Shard, Replicate)) for p in x) and len(x) > 0


def distribute(tree, placements_tree, mesh: DeviceMesh):
    """Every tensor leaf of ``tree`` as a DTensor on ``mesh`` with its
    placements from ``placements_tree`` (same structure, a placement list
    per leaf). Each rank must hold the same full tensors: its shards are
    cut locally, nothing is sent."""
    def put(t, plc):
        if t is None:
            return None
        return distribute_tensor(t, mesh, list(plc), src_data_rank=None)
    return _map(put, tree, placements_tree)


def local(tree):
    """The local shards of a tree's DTensor leaves (other leaves as they
    are)."""
    return _map(lambda t: t.to_local() if isinstance(t, DTensor) else t,
                tree)
