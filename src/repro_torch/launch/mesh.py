"""Named device meshes for the LM side.

The port of the JAX package's ``launch/mesh.py``.  The mesh itself,
:class:`~repro_torch.core.layout.DeviceMesh` (re-exported here with
:func:`make_mesh`), is one process's N-axis grid of ``torch.device``\\s
with a name for each axis; its device list may name one device many times.

:func:`make_production_mesh` builds an *abstract* mesh (shape and names,
no devices): the 16x16 and 2x16x16 pod meshes the sharding policy and the
per-position byte counts are written for.  Layout operations need a mesh
with devices.  The CFD side's ``(solve, assemble)`` mesh,
:class:`repro_torch.core.comm.ShardMesh`, is a :class:`DeviceMesh` too.
"""
from __future__ import annotations

from repro_torch.core.layout import (DeviceMesh, MeshShape,  # noqa: F401
                                     make_mesh)

__all__ = ["MeshShape", "DeviceMesh", "make_mesh", "make_debug_mesh",
           "make_production_mesh"]


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 single-pod (256 chips) or 2x16x16 multi-pod (512 chips), as
    an abstract mesh: what the sharding policy and the per-position byte
    counts need, no devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return DeviceMesh(shape, axes)


def make_debug_mesh(n_data: int = 2, n_model: int = 4, devices=None, *,
                    device_type: str = "cuda") -> DeviceMesh:
    """The small ``(data, model)`` mesh of the tests; ``devices`` may name
    one device ``n_data * n_model`` times."""
    return make_mesh((n_data, n_model), ("data", "model"), devices,
                     device_type=device_type)
