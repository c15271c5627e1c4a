"""Meshes of devices and the layout of tensors over them.

A :class:`DeviceMesh` is one process's mesh, as JAX's ``Mesh`` is one
controller's: an N-axis grid of ``torch.device``\\s with a name for each
axis.  Its device list may name one device many times (the counterpart of
JAX's forced host devices): positions that share a device hold their own
tensors there, and a copy between them is a device-local copy.
``mesh.shape`` answers both ``mesh.shape["model"]`` (JAX's ``Mesh.shape``
is a name -> size mapping) and ``dict(zip(mesh.axis_names, mesh.shape))``.

A :class:`NamedSharding` (a mesh and a :class:`PartitionSpec`) is a layout
the JAX package hands to its compiler; here the layout is explicit.
:func:`shard` turns a tensor into a :class:`Sharded` leaf, one tensor per
mesh position on that position's device (a replicated axis holds copies,
as JAX's addressable shards do); :func:`unshard` puts it back together
bitwise; :func:`reshard` runs a move plan (:func:`move_plan`: which box of
which source shard goes to which destination) and counts the bytes it
moved between distinct positions and between distinct devices
(:class:`MoveStats`).  A position takes what its own shard already holds
from itself; the rest comes from the first position (C order) that holds
it on the same device, else from the first that holds it at all.

The LM side's sharding policy (:mod:`repro_torch.models.sharding`) and the
CFD side's ``(solve, assemble)`` mesh (:mod:`repro_torch.core.comm`) both
build on this module; :mod:`repro_torch.launch.mesh` and
:mod:`repro_torch.models.sharding` re-export its names.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["canonical_device", "visible_devices", "MeshShape", "DeviceMesh",
           "make_mesh", "PartitionSpec", "P", "NamedSharding", "MoveStats",
           "Sharded", "shard", "unshard", "unshard_moves", "move_plan",
           "reshard", "unshard_tree", "sharded_leaves"]


def canonical_device(device) -> torch.device:
    """A device with its index: ``cuda`` is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices(device_type: str = "cuda") -> list[torch.device]:
    """The distinct devices of one type this process sees."""
    if device_type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return [torch.device("cuda", i) for i in range(n)]
    if device_type == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unsupported device type {device_type!r}")


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
            return f"{type(self).__name__}({axes}, abstract)"
        devs = sorted({str(d) for d in self.device_list()})
        return f"{type(self).__name__}({axes}, devices={devs})"

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


# ---------------------------------------------------------------------------
# specs and shardings
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """One entry per leading dim: ``None`` (not sharded), an axis name, or
    a tuple of axis names (major first).  Printed as JAX prints its own."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__

    def __getnewargs__(self):
        return tuple(self)


P = PartitionSpec


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec.  Dim ``i`` is cut into the product of its axes'
    sizes; the block a position holds is the mixed-radix index of its
    coordinates on those axes, the first axis major (JAX's order)."""

    mesh: DeviceMesh
    spec: PartitionSpec

    def __post_init__(self):
        seen = [a for e in self.spec for a in _axes_of(e)]
        for a in seen:
            if a not in self.mesh.axis_names:
                raise ValueError(f"{self.spec} names {a!r}, not an axis of "
                                 f"{self.mesh.axis_names}")
        if len(set(seen)) != len(seen):
            raise ValueError(f"{self.spec} maps a mesh axis to more than "
                             "one dim")
        if not isinstance(self.spec, PartitionSpec):
            object.__setattr__(self, "spec", PartitionSpec(*self.spec))

    def tiling(self, ndim: int) -> tuple[int, ...]:
        """How many blocks each dim is cut into."""
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec} has more entries than {ndim} dims")
        t = [math.prod(self.mesh.shape[a] for a in _axes_of(e))
             for e in self.spec]
        return tuple(t) + (1,) * (ndim - len(t))

    def shard_shape(self, global_shape) -> tuple[int, ...]:
        global_shape = tuple(global_shape)
        tiles = self.tiling(len(global_shape))
        for i, (n, t) in enumerate(zip(global_shape, tiles)):
            if n % t:
                raise ValueError(
                    f"{self.spec} cuts dim {i} into {t} blocks, but its "
                    f"size is {n} (shape {global_shape})")
        return tuple(n // t for n, t in zip(global_shape, tiles))

    def block(self, coords, ndim: int) -> tuple[int, ...]:
        """The block index per dim that position ``coords`` holds."""
        c = self.mesh.coords(coords)
        out = []
        for i in range(ndim):
            idx = 0
            for a in _axes_of(self.spec[i] if i < len(self.spec) else None):
                idx = idx * self.mesh.shape[a] + c[a]
            out.append(idx)
        return tuple(out)

    def box(self, coords, global_shape) -> tuple[tuple[int, int], ...]:
        """``(start, stop)`` per dim of the slice position ``coords``
        holds."""
        ss = self.shard_shape(global_shape)
        return tuple((b * s, (b + 1) * s)
                     for b, s in zip(self.block(coords, len(ss)), ss))


# ---------------------------------------------------------------------------
# layout operations
# ---------------------------------------------------------------------------

class MoveStats(NamedTuple):
    """Bytes a layout operation copied from one mesh position to another
    (``positions``), and the part of those whose two positions are on
    distinct devices (``devices``)."""

    positions: int = 0
    devices: int = 0

    def __add__(self, other):
        return MoveStats(self.positions + other.positions,
                         self.devices + other.devices)


@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    """A leaf laid out over a mesh: ``shards[k]`` is the tensor at the
    ``k``-th position (``sharding.mesh.positions()`` order), on that
    position's device, of shape ``sharding.shard_shape(shape)``."""

    sharding: NamedSharding
    shape: tuple[int, ...]
    shards: tuple[torch.Tensor, ...]

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def mesh(self) -> DeviceMesh:
        return self.sharding.mesh

    def position_bytes(self) -> int:
        """Bytes one position holds (every position holds as many)."""
        return self.shards[0].numel() * self.shards[0].element_size()

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.sharding.spec}, mesh={self.mesh!r})")


def _slices(box, base=None) -> tuple:
    base = base or (0,) * len(box)
    return tuple(slice(lo - b, hi - b) for (lo, hi), b in zip(box, base))


def _need_devices(sharding: NamedSharding) -> None:
    if sharding.mesh.abstract:
        raise ValueError("layout operations need a mesh with devices, "
                         f"got {sharding.mesh!r}")


def shard(t: torch.Tensor, sharding: NamedSharding) -> Sharded:
    """``t`` laid out by ``sharding``: every position gets its own copy of
    its slice, on its device."""
    _need_devices(sharding)
    mesh = sharding.mesh
    shape = tuple(t.shape)
    ss = sharding.shard_shape(shape)
    shards = []
    for c in mesh.positions():
        out = torch.empty(ss, dtype=t.dtype, device=mesh.device(c))
        out.copy_(t[_slices(sharding.box(c, shape))])
        shards.append(out)
    return Sharded(sharding, shape, tuple(shards))


def _sources(s: Sharded, device) -> dict:
    """``{block index: position index}``: the first position holding
    each block on ``device`` if one does, else the first holding it."""
    devs = s.mesh.device_list()
    out: dict = {}
    for k, c in enumerate(s.mesh.positions()):
        b = s.sharding.block(c, s.ndim)
        if b not in out or (devs[k] == device and devs[out[b]] != device):
            out[b] = k
    return out


def unshard(s: Sharded, device) -> torch.Tensor:
    """The whole leaf on ``device``: each block taken from the first
    position holding it (on ``device`` if one does), joined by
    ``torch.cat`` in coordinate order.  Bitwise the tensor that was
    sharded."""
    device = torch.device(device)
    tiles = s.sharding.tiling(s.ndim)
    blocks = {b: s.shards[k].to(device)
              for b, k in _sources(s, device).items()}

    def join(prefix, dim):
        if dim == s.ndim:
            return blocks[prefix]
        parts = [join(prefix + (i,), dim + 1) for i in range(tiles[dim])]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

    out = join((), 0)
    if any(out.data_ptr() == t.data_ptr() for t in s.shards):
        out = out.clone()   # one block on ``device``: never hand out a shard
    return out


def unshard_moves(s: Sharded, device, home: int) -> MoveStats:
    """What :func:`unshard` onto ``device`` copies for the position
    ``home`` (an index in position order): every block but the one
    ``home`` holds, counted between devices where its source is on
    another device."""
    device = torch.device(device)
    devs = s.mesh.device_list()
    own = s.sharding.block(s.mesh.positions()[home], s.ndim)
    n = s.position_bytes()
    out = MoveStats()
    for b, k in _sources(s, device).items():
        if b != own:
            out += MoveStats(n, n if devs[k] != device else 0)
    return out


def move_plan(src: NamedSharding, dst: NamedSharding, shape) -> list:
    """The pieces that lay a leaf of ``shape`` out from ``src`` to ``dst``
    (one mesh): ``(dst position, src position, global box)`` for each
    non-empty intersection of a destination slice with a source block.
    A piece the destination position holds itself is taken from itself;
    otherwise from the first holder on the same device, else the first
    holder."""
    if src.mesh != dst.mesh:
        raise ValueError("reshard moves within one mesh")
    shape = tuple(shape)
    mesh = src.mesh
    pos = mesh.positions()
    devs = mesh.device_list() if not mesh.abstract else [None] * len(pos)
    s_ss = src.shard_shape(shape)
    holders: dict = {}
    for k, c in enumerate(pos):
        holders.setdefault(src.block(c, len(shape)), []).append(k)
    plan = []
    for kd, c in enumerate(pos):
        box = dst.box(c, shape)
        # the source blocks each dim's destination interval overlaps
        ranges = [range(lo // n, (hi - 1) // n + 1) if hi > lo else range(0)
                  for (lo, hi), n in zip(box, s_ss)]
        own = src.block(c, len(shape))
        for b in itertools.product(*ranges):
            piece = tuple((max(lo, i * n), min(hi, (i + 1) * n))
                          for (lo, hi), i, n in zip(box, b, s_ss))
            ks = holders[b]
            if b == own:
                ks_pick = kd
            else:
                same = [k for k in ks if devs[k] == devs[kd]]
                ks_pick = (same or ks)[0]
            plan.append((kd, ks_pick, piece))
    return plan


def reshard(s: Sharded, sharding: NamedSharding) -> tuple[Sharded, MoveStats]:
    """``s`` laid out by ``sharding`` through :func:`move_plan`, and the
    bytes it moved.  A destination shard that is the whole of its
    position's source shard is that tensor (no copy)."""
    _need_devices(sharding)
    plan = move_plan(s.sharding, sharding, s.shape)
    mesh = sharding.mesh
    pos = mesh.positions()
    devs = mesh.device_list()
    ss = sharding.shard_shape(s.shape)
    item = s.shards[0].element_size()
    src_box = [s.sharding.box(c, s.shape) for c in pos]
    by_dst: dict = {}
    for kd, ks, piece in plan:
        by_dst.setdefault(kd, []).append((ks, piece))
    stats = MoveStats()
    out = []
    for kd, c in enumerate(pos):
        box = sharding.box(c, s.shape)
        pieces = by_dst[kd]
        if (len(pieces) == 1 and pieces[0][0] == kd
                and src_box[kd] == box):
            out.append(s.shards[kd])
            continue
        t = torch.empty(ss, dtype=s.dtype, device=devs[kd])
        for ks, piece in pieces:
            t[_slices(piece, [lo for lo, _ in box])].copy_(
                s.shards[ks][_slices(piece, [lo for lo, _ in src_box[ks]])])
            if ks != kd:
                n = math.prod(hi - lo for lo, hi in piece) * item
                stats += MoveStats(n, n if devs[ks] != devs[kd] else 0)
        out.append(t)
    return Sharded(sharding, s.shape, tuple(out)), stats


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def unshard_tree(tree, device):
    """:func:`unshard` over a tree (nested dicts) of :class:`Sharded`
    leaves."""
    if isinstance(tree, dict):
        return {k: unshard_tree(v, device) for k, v in tree.items()}
    return unshard(tree, device)


def sharded_leaves(tree) -> list:
    """The :class:`Sharded` leaves of a tree (dicts and named tuples)."""
    if tree is None:
        return []
    if isinstance(tree, Sharded):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in sharded_leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in sharded_leaves(v)]
    return []
