"""Production mesh construction, the launcher-facing import path: the
implementation lives in :mod:`repro_torch.dist.mesh`, axis bookkeeping in
:mod:`repro_torch.dist.sharding`. Meshes are built by functions, never at
import."""
from __future__ import annotations

from repro_torch.dist.mesh import fake_world, make_mesh, make_production_mesh
from repro_torch.dist.sharding import data_axes

__all__ = ["make_mesh", "make_production_mesh", "fake_world", "data_axes"]
