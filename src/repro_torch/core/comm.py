"""The ``(solve, assemble)`` mesh and the two layouts over it (paper §3).

The paper splits its ranks ``C`` into an active set ``C_a`` (one rank per
GPU, enters the solver) and an inactive set ``C_i`` (skips the solve).
The JAX package states the split as sharding, and so does the port, with
the specs of :mod:`repro_torch.core.layout`:

* assembly-phase tensors, the fine partition ``(n_fine, ...)``, are laid
  out over the whole mesh (:func:`assembly_sharding`, ``P(("solve",
  "assemble"), None, ...)``): every position assembles (= ``C``);
* solve-phase tensors, the coarse partition ``(n_coarse, ..., m_coarse)``,
  are pinned to the ``"solve"`` rows (:func:`solve_sharding`,
  ``P("solve", None, ...)``): the active ranks solve.  JAX replicates a
  row over ``"assemble"``; the port's solve consumes the row's first
  position ``(c, 0)`` only, as the paper's ``C_i`` ranks skip the solve;
* the coefficient update between the two layouts is the repartitioning
  traffic the paper is about (:mod:`repro_torch.core.update` counts it).

:class:`ShardMesh` is the CFD side's mesh: a
:class:`~repro_torch.core.layout.DeviceMesh` with the axes ``("solve",
"assemble")``, one process's grid of ``torch.device``\\s whose device list
may name one device many times (the counterpart of forced host devices).
Positions that share a device run as one tensor there
(:meth:`ShardMesh.groups`).

The full-mesh mode (``solve_mode="full_mesh"``) cuts each coarse part's
``m_coarse`` rows again into ``alpha`` row shards of ``m_loc = m_coarse /
alpha`` rows, one shard per position, in ``(solve, assemble)`` order:
shard ``c * alpha + j`` is rows ``[j * m_loc, (j + 1) * m_loc)`` of coarse
part ``c`` (``solve_sharding(..., full_mesh=True)``); every shard then
works during the solve, and :mod:`repro_torch.sparse.shardmap_spmv` swaps
one halo plane between linear neighbours.  :func:`to_shards` /
:func:`from_shards` move a stacked tensor to that layout and back (a
vector's shard layout is a view; bands ``(n_c, nb, m_c)`` are copied
once).  :func:`assembly_layout` / :func:`stacked_layout` move a stacked
fine-partition tensor to the assembly layout and back.
"""
from __future__ import annotations

import torch

from repro_torch.core.layout import (DeviceMesh, NamedSharding,
                                     PartitionSpec, Sharded,
                                     canonical_device, unshard,
                                     visible_devices)

__all__ = ["SOLVE_AXIS", "ASSEMBLE_AXIS", "ShardMesh", "make_cfd_mesh",
           "visible_devices", "canonical_device", "to_shards", "from_shards",
           "assembly_sharding", "solve_sharding", "solve_constraint",
           "assembly_layout", "stacked_layout"]

SOLVE_AXIS = "solve"
ASSEMBLE_AXIS = "assemble"


class ShardMesh(DeviceMesh):
    """An ``(n_coarse, alpha)`` grid of devices with the axes ``("solve",
    "assemble")``.

    ``ShardMesh(rows)`` takes the rows of devices (``rows[c][j]`` is
    position ``(c, j)``, linear position ``c * alpha + j``);
    :meth:`from_device_mesh` converts a two-axis :class:`DeviceMesh` with
    those names, exactly.  ``dict(zip(mesh.axis_names, mesh.shape))`` is
    ``{"solve": n_coarse, "assemble": alpha}``, as for JAX's ``Mesh``.
    """

    def __init__(self, rows):
        rows = [list(r) for r in rows]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a shard mesh needs equal non-empty rows")
        super().__init__((len(rows), len(rows[0])),
                         (SOLVE_AXIS, ASSEMBLE_AXIS),
                         [d for r in rows for d in r])

    @classmethod
    def from_device_mesh(cls, mesh: DeviceMesh) -> "ShardMesh":
        """The same positions on the same devices, as a :class:`ShardMesh`
        (raises unless the axes are ``("solve", "assemble")``)."""
        if isinstance(mesh, cls):
            return mesh
        if tuple(mesh.axis_names) != (SOLVE_AXIS, ASSEMBLE_AXIS):
            raise ValueError(f"a CFD mesh has the axes {SOLVE_AXIS!r}, "
                             f"{ASSEMBLE_AXIS!r}; got {mesh.axis_names}")
        if mesh.abstract:
            raise ValueError("a CFD mesh needs devices")
        n_c, alpha = mesh.shape
        flat = mesh.device_list()
        return cls([flat[c * alpha:(c + 1) * alpha] for c in range(n_c)])

    @property
    def n_shards(self) -> int:
        return self.size

    def flat(self) -> list[torch.device]:
        """The positions' devices in linear ``(solve, assemble)`` order."""
        return self.device_list()

    def groups(self) -> list[tuple[torch.device, int, int]]:
        """``(device, first, end)`` for each run of consecutive positions on
        one device: a run's positions are one tensor (the lanes of one
        launch)."""
        out = []
        for s, dev in enumerate(self.flat()):
            if out and out[-1][0] == dev:
                out[-1] = (dev, out[-1][1], s + 1)
            else:
                out.append((dev, s, s + 1))
        return out

    @property
    def one_device(self) -> torch.device | None:
        """The device when every position is on it, else None."""
        devs = set(self.flat())
        return devs.pop() if len(devs) == 1 else None


def make_cfd_mesh(n_coarse: int, alpha: int, devices=None, *,
                  device_type: str = "cuda") -> ShardMesh:
    """The ``(n_coarse, alpha)`` mesh over the first ``n_coarse * alpha``
    of ``devices`` (default: the distinct visible devices of
    ``device_type``); raises when there are fewer, as the JAX package's
    ``make_cfd_mesh`` does.  ``devices`` may name one device many times."""
    devs = (visible_devices(device_type) if devices is None
            else [canonical_device(d) for d in devices])
    if len(devs) < n_coarse * alpha:
        raise ValueError(f"need {n_coarse * alpha} devices, have {len(devs)}")
    devs = devs[:n_coarse * alpha]
    return ShardMesh([devs[c * alpha:(c + 1) * alpha]
                      for c in range(n_coarse)])


def to_shards(t: torch.Tensor, alpha: int) -> torch.Tensor:
    """A stacked ``(n_c, m_c)`` vector as ``(n_c * alpha, m_loc)`` (a
    view), or stacked bands ``(n_c, nb, m_c)`` as ``(n_c * alpha, nb,
    m_loc)`` (a contiguous copy): shard ``c * alpha + j`` holds rows ``[j *
    m_loc, (j + 1) * m_loc)`` of part ``c``."""
    n_c, m_c = t.shape[0], t.shape[-1]
    if m_c % alpha:
        raise ValueError(f"{m_c} rows do not split into {alpha} shards")
    m_loc = m_c // alpha
    if t.dim() == 2:
        return t.reshape(n_c * alpha, m_loc)
    nb = t.shape[1]
    return (t.reshape(n_c, nb, alpha, m_loc).permute(0, 2, 1, 3)
            .reshape(n_c * alpha, nb, m_loc).contiguous())


def from_shards(t: torch.Tensor, alpha: int) -> torch.Tensor:
    """The inverse of :func:`to_shards`: ``(n_c * alpha, m_loc)`` back to
    ``(n_c, m_c)`` (a view), ``(n_c * alpha, nb, m_loc)`` to ``(n_c, nb,
    m_c)`` (a copy)."""
    S, m_loc = t.shape[0], t.shape[-1]
    if S % alpha:
        raise ValueError(f"{S} shards are not groups of {alpha}")
    n_c = S // alpha
    if t.dim() == 2:
        return t.reshape(n_c, alpha * m_loc)
    nb = t.shape[1]
    return (t.reshape(n_c, alpha, nb, m_loc).permute(0, 2, 1, 3)
            .reshape(n_c, nb, alpha * m_loc).contiguous())


# ---------------------------------------------------------------------------
# the two layouts (the JAX package's specs, entry for entry)
# ---------------------------------------------------------------------------

def assembly_sharding(mesh: DeviceMesh, extra_dims: int = 1
                      ) -> NamedSharding:
    """Fine-partition tensors ``(n_fine, ...)``: the parts over both mesh
    axes (= ``C``)."""
    return NamedSharding(mesh, PartitionSpec((SOLVE_AXIS, ASSEMBLE_AXIS),
                                             *(None,) * extra_dims))


def solve_sharding(mesh: DeviceMesh, extra_dims: int = 1,
                   full_mesh: bool = False) -> NamedSharding:
    """Coarse-partition tensors ``(n_coarse, ..., m_coarse)``.

    Paper-faithful (default): rows on ``"solve"``, not cut over
    ``"assemble"`` (= ``C_a`` active, ``C_i`` idle).  ``full_mesh=True``:
    the trailing fused-row dim also cut over ``"assemble"``, the layout
    :mod:`repro_torch.sparse.shardmap_spmv` consumes.
    """
    if full_mesh and extra_dims >= 1:
        return NamedSharding(mesh, PartitionSpec(
            SOLVE_AXIS, *(None,) * (extra_dims - 1), ASSEMBLE_AXIS))
    return NamedSharding(mesh, PartitionSpec(SOLVE_AXIS,
                                             *(None,) * extra_dims))


def solve_constraint(mesh: DeviceMesh | None, x: torch.Tensor, *,
                     full_mesh: bool = False, parts=None, n_coarse=None,
                     device=None) -> torch.Tensor:
    """Pin a solve-phase tensor to the solve layout (``x`` itself off a
    mesh).

    JAX applies it between the coefficient update and the solve so that
    the compiler keeps the solver operands in the solve layout.  In the
    port a solve-phase tensor holds whole coarse parts ``(n, ..., m_c)``
    at the device of their owner, the position where each is solved
    (:func:`~repro_torch.core.update.owner_positions`): on a mesh of one
    device all ``n_coarse`` parts (default ``x.shape[0]``), over distinct
    devices the coarse parts ``parts`` that one owner's device holds.
    ``device`` is the mesh device ``x`` is at (default ``x.device``; a CPU
    tensor cannot tell ``cpu`` from ``cpu:0``).  The full mesh cuts the
    whole stacked tensor into its shards at the first position.  Anywhere
    else it raises.  Returns ``x``.
    """
    if mesh is None:
        return x
    solve_sharding(mesh, x.dim() - 1, full_mesh)   # a spec the mesh names
    devs = mesh.device_list()
    parts = range(x.shape[0]) if parts is None else parts
    if full_mesh:
        owners = [0] * len(parts)
    else:
        from repro_torch.core.update import owner_positions

        own = owner_positions(mesh, x.shape[0] if n_coarse is None
                              else n_coarse)
        owners = [own[c] for c in parts]
    here = canonical_device(x.device if device is None else device)
    for c, pos in zip(parts, owners):
        if devs[pos] != here:
            where = ("the solve layout's first position" if pos == 0
                     else f"position {pos}")
            raise ValueError(f"a solve-phase tensor on {here}, the owner of "
                             f"its coarse part {c} ({where}) on {devs[pos]}")
    return x


def assembly_layout(t: torch.Tensor, mesh: DeviceMesh) -> Sharded:
    """A stacked fine-partition tensor ``(n_fine, ...)`` laid out by
    :func:`assembly_sharding`: each position holds its block of parts, a
    view of ``t`` where the position is on ``t``'s device (positions that
    share a device share its storage), a copy elsewhere."""
    sharding = assembly_sharding(mesh, t.dim() - 1)
    shape = tuple(t.shape)
    shards = []
    for c, dev in zip(mesh.positions(), mesh.device_list()):
        (lo, hi), *_ = sharding.box(c, shape)
        shards.append(t[lo:hi].to(dev))
    return Sharded(sharding, shape, tuple(shards))


def stacked_layout(s: Sharded, device) -> torch.Tensor:
    """The stacked tensor of a leaf in the assembly layout, on ``device``
    (bitwise the tensor that was laid out); raises for any other
    layout."""
    want = assembly_sharding(s.mesh, s.ndim - 1)
    if s.sharding != want:
        raise ValueError(f"expected the assembly layout {want.spec}, got "
                         f"{s.sharding.spec}")
    return unshard(s, device)
