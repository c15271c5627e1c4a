"""Named device meshes for the LM side.

The port of the JAX package's ``launch/mesh.py``.  A :class:`DeviceMesh`
is one process's mesh, as JAX's ``Mesh`` is one controller's: an N-axis
grid of ``torch.device``\\s with a name for each axis.  Its device list
may name one device many times (the counterpart of JAX's forced host
devices): positions that share a device hold their own tensors there, and
a copy between them is a device-local copy.  ``mesh.shape`` answers both
``mesh.shape["model"]`` (JAX's ``Mesh.shape`` is a name -> size mapping)
and ``dict(zip(mesh.axis_names, mesh.shape))``.

:func:`make_production_mesh` builds an *abstract* mesh (shape and names,
no devices): the 16x16 and 2x16x16 pod meshes the sharding policy and the
per-position byte counts are written for.  Layout operations need a mesh
with devices.  The CFD side's ``(solve, assemble)`` mesh is
:class:`repro_torch.core.comm.ShardMesh`.
"""
from __future__ import annotations

import itertools
import math

import numpy as np

from repro_torch.core.comm import canonical_device, visible_devices

__all__ = ["MeshShape", "DeviceMesh", "make_mesh", "make_debug_mesh",
           "make_production_mesh"]


class MeshShape(tuple):
    """The axis sizes in axis order, also indexable by axis name."""

    def __new__(cls, sizes, names):
        self = super().__new__(cls, (int(s) for s in sizes))
        self.names = tuple(names)
        return self

    def __getitem__(self, key):
        if isinstance(key, str):
            return tuple.__getitem__(self, self.names.index(key))
        return tuple.__getitem__(self, key)

    def __getnewargs__(self):
        return tuple(self), self.names


class DeviceMesh:
    """An N-axis grid of devices with named axes.

    ``devices`` is a numpy object array of ``torch.device``\\s of shape
    ``tuple(shape)`` (``None`` for an abstract mesh).  A *position* is a
    coordinate tuple; :meth:`positions` lists them in C order (the last
    axis fastest), the order in which a sharded leaf keeps its shards.
    """

    def __init__(self, shape, axis_names, devices=None):
        axis_names = tuple(axis_names)
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names repeat: {axis_names}")
        if len(tuple(shape)) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} does not match axes "
                             f"{axis_names}")
        self.axis_names = axis_names
        self.shape = MeshShape(shape, axis_names)
        if devices is not None:
            devs = [canonical_device(d) for d in np.asarray(
                devices, dtype=object).reshape(-1)]
            if len(devs) != self.size:
                raise ValueError(f"a {tuple(self.shape)} mesh needs "
                                 f"{self.size} devices, got {len(devs)}")
            arr = np.empty(len(devs), dtype=object)
            arr[:] = devs
            devices = arr.reshape(tuple(self.shape))
        self.devices = devices

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def abstract(self) -> bool:
        return self.devices is None

    def positions(self) -> list[tuple[int, ...]]:
        """Every coordinate tuple, in C order."""
        return list(itertools.product(*(range(n) for n in self.shape)))

    def device(self, coords) -> "torch.device":
        if self.devices is None:
            raise ValueError("an abstract mesh has no devices")
        return self.devices[tuple(coords)]

    def device_list(self) -> list:
        """The devices in position order."""
        return [self.device(c) for c in self.positions()]

    def coords(self, coords) -> dict:
        """``{axis name: coordinate}`` of a position."""
        return dict(zip(self.axis_names, coords))

    def __repr__(self) -> str:
        axes = ", ".join(f"{n!r}: {s}" for n, s in
                         zip(self.axis_names, self.shape))
        if self.devices is None:
            return f"DeviceMesh({axes}, abstract)"
        devs = sorted({str(d) for d in self.device_list()})
        return f"DeviceMesh({axes}, devices={devs})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, DeviceMesh)
                and self.axis_names == other.axis_names
                and tuple(self.shape) == tuple(other.shape)
                and ((self.devices is None and other.devices is None)
                     or (self.devices is not None and other.devices is not None
                         and self.device_list() == other.device_list())))

    def __hash__(self) -> int:
        devs = None if self.devices is None else tuple(
            str(d) for d in self.device_list())
        return hash((self.axis_names, tuple(self.shape), devs))


def make_mesh(shape, names, devices=None, *,
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh over the first ``prod(shape)`` of ``devices`` (default: the
    distinct visible devices of ``device_type``); raises when there are
    fewer, as :func:`repro_torch.core.comm.make_cfd_mesh` does.
    ``devices`` may name one device many times."""
    shape = tuple(int(s) for s in shape)
    devs = (visible_devices(device_type) if devices is None
            else [canonical_device(d) for d in devices])
    n = math.prod(shape)
    if len(devs) < n:
        raise ValueError(f"a {shape} mesh needs {n} devices, have "
                         f"{len(devs)}")
    return DeviceMesh(shape, names, devs[:n])


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
