"""Divisibility-aware sharding policy (DP/TP/SP/EP + FSDP) and the layout
operations that place tensors on a
:class:`~repro_torch.launch.mesh.DeviceMesh`.

The port of the JAX package's ``models/sharding.py``.  The policy maps
every parameter / cache / batch leaf to a :class:`PartitionSpec`, rule for
rule as JAX's does:

* **TP** — matmul contraction-free dims (flattened head dim, d_ff, vocab)
  shard over ``model``;
* **FSDP/ZeRO** — the remaining large dim shards over the data-parallel axes
  (``("pod","data")`` on the multi-pod mesh) so parameters + optimizer states
  scale with the fleet;
* **EP** — expert dims shard over the data axes when divisible (phi-3.5's 16
  experts on a 16-way axis), else fall back to FSDP on d_model;
* every rule checks divisibility and falls back to ``None`` (replication).

Batch dims shard over the data axes; cache sequence dims shard over
``model``; the period/stack leading dim is never sharded.

JAX's ``NamedSharding`` is a layout the compiler honours; here the layout
is explicit.  :func:`shard` turns a tensor into a :class:`Sharded` leaf,
one tensor per mesh position on that position's device (a replicated axis
holds copies, as JAX's addressable shards do); :func:`unshard` puts it
back together bitwise; :func:`reshard` runs a move plan
(:func:`move_plan`: which box of which source shard goes to which
destination) and counts the bytes it moved between distinct positions and
between distinct devices.  A position takes what its own shard already
holds from itself; the rest comes from the first position (C order) that
holds it on the same device, else from the first that holds it at all.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import NamedTuple

import torch

from repro_torch.launch.mesh import DeviceMesh

__all__ = ["PartitionSpec", "P", "NamedSharding", "Sharded", "MoveStats",
           "dp_axes", "param_shardings", "cache_shardings",
           "batch_shardings", "make_sharding", "set_activation_mesh",
           "set_sp_outputs", "out_spec", "constrain", "shard", "unshard",
           "reshard", "move_plan", "unshard_moves", "unshard_tree",
           "sharded_leaves"]


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


def make_sharding(mesh: DeviceMesh, *dim_axes) -> NamedSharding:
    return NamedSharding(mesh, P(*dim_axes))


# ---------------------------------------------------------------------------
# activation hints
# ---------------------------------------------------------------------------

_ACT_MESH: DeviceMesh | None = None
_SP_OUTPUTS = False


def set_activation_mesh(mesh: DeviceMesh | None):
    global _ACT_MESH
    _ACT_MESH = mesh


def set_sp_outputs(on: bool):
    """JAX's collective lever (sequence-sharded sublayer outputs); kept as
    a flag with JAX's values for :func:`out_spec`."""
    global _SP_OUTPUTS
    _SP_OUTPUTS = on


def out_spec() -> tuple:
    return ("dp", "model", None) if _SP_OUTPUTS else ("dp", None, None)


def constrain(x, *axes):
    """Returns ``x``.  In JAX this is a GSPMD layout hint
    (``with_sharding_constraint``) that keeps a layer's activations
    batch-sharded; in the port a data row's activations already are its
    batch slice, computed on that row's device, so there is nothing to
    pin.  The LM stack does not call it."""
    return x


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

def dp_axes(mesh: DeviceMesh):
    """Data-parallel axes: ('pod','data') on multi-pod, ('data',) otherwise."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axsize(mesh: DeviceMesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _fit(mesh: DeviceMesh, dim: int, axes):
    """Return `axes` if they evenly divide dim, else progressively shrink."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    while axes:
        if dim % _axsize(mesh, axes) == 0:
            return axes if len(axes) > 1 else axes[0]
        axes = axes[1:]  # drop the leading (pod) axis first
    return None


def _param_rule(name: str, shape: tuple[int, ...], mesh: DeviceMesh,
                stack_dims: int) -> PartitionSpec:
    """PartitionSpec entries for the non-stack dims of one parameter."""
    dp = dp_axes(mesh)
    dims = shape[stack_dims:]
    nd = len(dims)

    def spec(*entries):
        fitted = [_fit(mesh, dims[i], entries[i]) for i in range(nd)]
        return P(*([None] * stack_dims), *fitted)

    if name in ("embed",):            # (V, d): vocab TP; d replicated
        return spec("model", None)
    if name in ("lm_head",):          # (d, V)
        return spec(None, "model")
    if name in ("wq", "wk", "wv"):    # (d, H*hd): TP on flattened heads
        return spec(dp, "model")
    if name in ("wo",):               # (H*hd, d)
        return spec("model", dp)
    if name in ("w_up", "w_gate"):
        if nd == 3:                   # MoE (E, d, ff)
            if _fit(mesh, dims[0], dp):      # EP: experts over data axes
                return spec(dp, None, "model")
            return spec(None, dp, "model")   # else FSDP on d (mixtral: E=8)
        return spec(dp, "model")      # dense (d, ff)
    if name in ("w_down",):
        if nd == 3:                   # (E, ff, d)
            if _fit(mesh, dims[0], dp):
                return spec(dp, "model", None)
            return spec(None, "model", dp)
        return spec("model", dp)      # (ff, d)
    if name in ("router",):           # (d, E) small
        return spec(None, None)
    if name in ("in_proj",):          # mamba (d, 2*di)
        return spec(dp, "model")
    if name in ("x_proj",):           # (di, dt_rank + 2 ds)
        return spec("model", None)
    if name in ("dt_proj",):          # (r, di)
        return spec(None, "model")
    if name in ("out_proj",):         # (di, d)
        return spec("model", dp)
    if name in ("conv_w",):           # (k, di)
        return spec(None, "model")
    if name in ("A_log", "D", "conv_b", "dt_bias"):  # (di, ...) vectors
        return spec("model", *(None,) * (nd - 1))
    if name in ("wr", "wk6", "wv6", "wg"):  # rwkv square mats
        return spec(dp, "model")
    if name in ("wA",):               # (d, r)
        return spec(dp, None)
    if name in ("wB",):               # (r, d)
        return spec(None, "model")
    # norms, biases, mus, u, w0, ln_g, small leftovers: replicate
    return P(*([None] * stack_dims), *([None] * nd))


_STACKED_PREFIXES = ("blocks", "encoder")


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of nested dicts (keys as JAX's
    ``DictKey``s name them); ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_shardings(mesh: DeviceMesh, param_specs) -> dict:
    """NamedSharding tree matching ``lm.param_specs(cfg)`` / init_params
    (any tree of leaves with a ``.shape``)."""

    def visit(path, leaf):
        stack = 1 if (path and path[0] in _STACKED_PREFIXES) else 0
        name = path[-1] if path else ""
        # rwkv shares wk/wv names with attention — same rule applies (d, d)
        return NamedSharding(mesh, _param_rule(name, tuple(leaf.shape), mesh,
                                               stack))

    return _map_with_path(visit, param_specs)


def cache_shardings(mesh: DeviceMesh, cache_specs) -> dict:
    dp = dp_axes(mesh)

    def visit(path, leaf):
        name = path[-1] if path else ""
        dims = tuple(leaf.shape)  # leading dim = n_periods (never sharded)
        if name in ("k", "v"):       # (np, B, S, Hk, hd): batch DP + seq TP
            return NamedSharding(mesh, P(None, _fit(mesh, dims[1], dp),
                                         _fit(mesh, dims[2], "model"),
                                         None, None))
        if name in ("ck", "cv"):     # (np, B, M, Hk, hd)
            return NamedSharding(mesh, P(None, _fit(mesh, dims[1], dp),
                                         None, None, None))
        if name == "ssm":            # (np, B, di, ds)
            return NamedSharding(mesh, P(None, _fit(mesh, dims[1], dp),
                                         _fit(mesh, dims[2], "model"), None))
        if name == "conv":           # (np, B, k, di)
            return NamedSharding(mesh, P(None, _fit(mesh, dims[1], dp),
                                         None, _fit(mesh, dims[3], "model")))
        if name == "S":              # (np, B, H, hd, hd)
            return NamedSharding(mesh, P(None, _fit(mesh, dims[1], dp),
                                         _fit(mesh, dims[2], "model"),
                                         None, None))
        if name in ("last", "ffn_last"):  # (np, B, d)
            return NamedSharding(mesh, P(None, _fit(mesh, dims[1], dp),
                                         _fit(mesh, dims[2], "model")))
        return NamedSharding(mesh, P(*([None] * len(dims))))

    return _map_with_path(visit, cache_specs)


def batch_shardings(mesh: DeviceMesh, batch_specs) -> dict:
    """tokens/labels (B, S) → batch over DP axes; frontend (B, F, d) same."""
    dp = dp_axes(mesh)

    def visit(path, leaf):
        shape = tuple(leaf.shape)
        if shape == ():  # scalars (pos)
            return NamedSharding(mesh, P())
        entries = [_fit(mesh, shape[0], dp)] + [None] * (len(shape) - 1)
        return NamedSharding(mesh, P(*entries))

    return _map_with_path(visit, batch_specs)


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
