"""Device meshes over ``torch.distributed``, built by functions, never at
import.

The counterpart of ``repro.dist.mesh``: a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis names
(``pod``, ``data``, ``model``). Building one needs a default process group
of as many ranks as the mesh has devices: ``torchrun`` or an explicit
``init_process_group`` on the card, :func:`fake_world` for the dry run.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh of ``shape`` over the named ``axes`` on the default process
    group. ``device_type=None`` means ``"cuda"`` and raises without a card;
    pass ``"cpu"`` for a gloo or fake group."""
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: make_mesh builds a CUDA mesh by "
                "default; pass device_type='cpu' for a CPU process group")
        device_type = "cuda"
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """The production grid: 256 devices per pod, a 16-way model axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def grid_groups(mesh: DeviceMesh) -> tuple:
    """``(row group, feature group)`` of this rank on a ``data`` × ``model``
    mesh (``pod`` folded into the rows): the row group is the ranks that
    share this rank's ``model`` coordinate, the feature group those that
    share its row. A mesh without a ``model`` axis has no feature group
    (None)."""
    names = tuple(mesh.mesh_dim_names)
    rows = tuple(a for a in ("pod", "data") if a in names)
    if not rows:
        raise ValueError(f"mesh axes {names} have no row axis (pod, data)")
    row_mesh = mesh[rows] if len(rows) == 1 else mesh[rows]._flatten()
    feat = mesh["model"].get_group() if "model" in names else None
    return row_mesh.get_group(), feat


@contextlib.contextmanager
def fake_world(n: int):
    """A ``"fake"`` process group of ``n`` ranks in which this process is
    rank 0, destroyed on exit. Its collectives move no data: the dry run
    traces a step over it on meta tensors. Refuses to start inside another
    process group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
