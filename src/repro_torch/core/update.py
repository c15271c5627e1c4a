"""Runtime matrix-coefficient update (paper §3, fig. 3b) — two-phase design.

The *plan* (:class:`~repro_torch.core.repartition.RepartitionPlan`) is built
once; every outer iteration only the coefficient **values** move.  The
paper's update pattern ``U`` (send targets + pointers + sizes) and
permutation ``P`` collapse here into:

1. a grouped concatenation of the alpha fine-part coefficient buffers that
   belong to one coarse part (the blockwise distribution makes the target
   contiguous);
2. a single gather by the precomputed ``*_src`` index (P ∘ U) into the
   solver layout, DIA or ELL.  The index goes to the device once per plan,
   as int32 (:meth:`RepartitionPlan.src_on`), and every update is one
   launch of the ``coef_update`` kernel
   (:mod:`repro_torch.kernels.coef_update`).

Two communication schedules mirror the paper's fig. 9:

* ``device_direct`` — the buffers go straight into the gather (GPU-aware
  MPI: each rank sends into the device buffer);
* ``host_buffer`` — the grouped buffers are staged through host memory
  first and copied back (the non-GPU-aware path: gather on the CPU rank,
  then copy to the GPU in a separate step).  Values are identical; only the
  data movement differs.

:class:`UpdaterPool` shares one output buffer and one bound update between
plans of equal shape, and rebinds each plan's own index.

Over a ``(solve, assemble)`` mesh (:mod:`repro_torch.core.comm`) the fine
buffers start in the assembly layout, fine part ``f`` on its position, and
coarse part ``c``'s ``alpha`` buffers go to its owner, the position
``(row, 0)`` of the solve layout: the paper's active rank.  The port keeps
a device's consecutive positions as one tensor, so on one device the
update runs as above and nothing is copied between positions;
:func:`update_moves` counts what each schedule carries between positions
and between devices (:class:`~repro_torch.core.layout.MoveStats`), the
traffic a mesh over distinct cards would carry.  :func:`owner_moves` and
:func:`halo_moves` count the solve operands' and the assembly's neighbour
planes' moves, and :class:`MoveRecord` keeps one step's moves by kind.
"""
from __future__ import annotations

import torch

from repro_torch.core.layout import MoveStats
from repro_torch.core.repartition import RepartitionPlan
from repro_torch.kernels.coef_update.coef_update import coef_update

__all__ = [
    "concat_group_buffers",
    "ell_values",
    "dia_values",
    "update_device_direct",
    "update_host_buffer",
    "plan_shape_signature",
    "UpdaterPool",
    "part_positions",
    "owner_positions",
    "owner_moves",
    "update_moves",
    "halo_moves",
    "MoveRecord",
]


def concat_group_buffers(buffers: torch.Tensor) -> torch.Tensor:
    """(n_coarse, alpha, L) per-fine-part buffers → (n_coarse, alpha*L + 1).

    The +1 appends the sentinel zero slot that empty band positions gather
    from.
    """
    n_c = buffers.shape[0]
    flat = buffers.reshape(n_c, -1)
    zero = torch.zeros((n_c, 1), dtype=flat.dtype, device=flat.device)
    return torch.cat([flat, zero], dim=1)


def ell_values(plan: RepartitionPlan, buf_cat: torch.Tensor) -> torch.Tensor:
    """Apply P∘U: (n_coarse, alpha*L+1) → ELL values (n_coarse, m_c, K)."""
    return coef_update(plan, buf_cat, "ell")


def dia_values(plan: RepartitionPlan, buf_cat: torch.Tensor) -> torch.Tensor:
    """Apply P∘U: (n_coarse, alpha*L+1) → DIA bands (n_coarse, n_bands, m_c)."""
    return coef_update(plan, buf_cat, "dia")


def _stage_through_host(buffers: torch.Tensor) -> torch.Tensor:
    return buffers.to("cpu", copy=True).to(buffers.device)


def update_device_direct(plan: RepartitionPlan, buffers: torch.Tensor,
                         target: str = "dia") -> torch.Tensor:
    """One-hop update: grouped concatenation + permutation."""
    return coef_update(plan, concat_group_buffers(buffers), target)


def update_host_buffer(plan: RepartitionPlan, buffers: torch.Tensor,
                       target: str = "dia") -> torch.Tensor:
    """Two-hop update (paper fig. 9, 'HB'): stage the grouped buffers in
    host memory, copy them back to their device, then permute."""
    return coef_update(plan, concat_group_buffers(_stage_through_host(buffers)),
                       target)


# ---------------------------------------------------------------------------
# Updater pool — one output buffer and bound update per plan shape.
#
# The JAX package jits one update executable per plan shape and rebinds the
# index operand.  PyTorch compiles nothing: what plans of equal shape share
# here is the output buffer (no allocation per update) and the bound launch;
# each plan's own device index is rebound on every ``updater`` call.
# ---------------------------------------------------------------------------

def plan_shape_signature(plan: RepartitionPlan, target: str = "dia") -> tuple:
    """Shapes that determine the update (not its indices)."""
    src = plan.dia_src if target == "dia" else plan.ell_src
    return (target, plan.alpha, plan.buffer_len, src.shape)


class _PooledUpdate:
    """One pool entry: a schedule and target bound to a reused output."""

    def __init__(self, schedule: str, target: str):
        self.schedule = schedule
        self.target = target
        self.out: torch.Tensor | None = None

    def __call__(self, plan: RepartitionPlan,
                 buffers: torch.Tensor) -> torch.Tensor:
        if self.schedule == "host_buffer":
            buffers = _stage_through_host(buffers)
        buf_cat = concat_group_buffers(buffers)
        src = plan.dia_src if self.target == "dia" else plan.ell_src
        shape = (buf_cat.shape[0], src.size)
        if (self.out is None or self.out.shape != shape
                or self.out.dtype != buf_cat.dtype
                or self.out.device != buf_cat.device):
            self.out = torch.empty(shape, dtype=buf_cat.dtype,
                                   device=buf_cat.device)
        return coef_update(plan, buf_cat, self.target, out=self.out)


class UpdaterPool:
    """Shared coefficient updates, keyed by plan shape.

    ``updater(plan)`` returns a ``buffers -> values`` callable bound to the
    plan, and so to its own device index; two plans with equal
    :func:`plan_shape_signature` share one entry (pool *hit*): its output
    buffer and bound update.  The
    values an updater returns are a view of that shared buffer, so the
    next call through any updater of the same entry overwrites them.
    """

    def __init__(self):
        self._entries: dict = {}
        self.hits = 0
        self.misses = 0

    def updater(self, plan: RepartitionPlan, target: str = "dia",
                schedule: str = "device_direct"):
        if schedule not in ("device_direct", "host_buffer"):
            raise ValueError(f"unknown update schedule {schedule!r}")
        key = (schedule,) + plan_shape_signature(plan, target)
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            entry = self._entries[key] = _PooledUpdate(schedule, target)
        else:
            self.hits += 1
        return lambda buffers: entry(plan, buffers)


# ---------------------------------------------------------------------------
# Moves over a (solve, assemble) mesh
#
# Positions are indices in the mesh's C order (``mesh.positions()``), so
# position ``(c, j)`` of an ``(n_solve, n_assemble)`` mesh is ``c *
# n_assemble + j``.
# ---------------------------------------------------------------------------

def part_positions(mesh, n_parts: int) -> list[int]:
    """The position holding each fine part in the assembly layout
    (``P(("solve", "assemble"), ...)``): blocks of ``n_parts / mesh.size``
    consecutive parts, in position order."""
    if n_parts % mesh.size:
        raise ValueError(f"{n_parts} fine parts do not lay out over "
                         f"{mesh.size} positions")
    block = n_parts // mesh.size
    return [f // block for f in range(n_parts)]


def owner_positions(mesh, n_coarse: int) -> list[int]:
    """The position owning each coarse part in the solve layout
    (``P("solve", ...)``): JAX's block rule on the ``"solve"`` axis,
    ``ceil(n_coarse / n_solve)`` parts a row (rows past the last part hold
    nothing, as JAX pads an uneven dim), at ``"assemble"`` coordinate 0,
    the row's active position."""
    n_solve, n_assemble = tuple(mesh.shape)
    block = -(-n_coarse // n_solve)
    return [(c // block) * n_assemble for c in range(n_coarse)]


def _owners_of_parts(mesh, n_parts: int, alpha: int) -> list[int]:
    """Each fine part's coarse owner (coarse part ``f // alpha``)."""
    own = owner_positions(mesh, n_parts // alpha)
    return [own[f // alpha] for f in range(n_parts)]


def _carry(devs, pairs, nbytes: int) -> MoveStats:
    """``nbytes`` for each ``(source, destination)`` pair of distinct
    places, counted between devices where their devices differ."""
    out = MoveStats()
    for a, b in pairs:
        if a != b:
            out += MoveStats(nbytes, nbytes if devs[a] != devs[b] else 0)
    return out


def owner_moves(mesh, n_parts: int, alpha: int, part_bytes: int
                ) -> MoveStats:
    """The bytes that take each fine part's ``part_bytes`` from its
    position to its coarse part's owner (coarse part ``f // alpha``); the
    way back, owner to fine positions, carries as many."""
    return _carry(mesh.device_list(),
                  zip(part_positions(mesh, n_parts),
                      _owners_of_parts(mesh, n_parts, alpha)), part_bytes)


def update_moves(mesh, n_parts: int, alpha: int, part_bytes: int,
                 schedule: str = "device_direct", *,
                 solve_layout: bool = True) -> MoveStats:
    """What one value update carries: ``part_bytes`` of coefficients a fine
    part, to its coarse part's owner (``solve_layout``) or, for a solve
    that stays in the fine layout (the momentum, alpha 1), back to its own
    position.

    ``device_direct`` is one hop, fine position to destination:
    ``(alpha - 1) * n_coarse * part_bytes`` between positions on an
    ``(n_coarse, alpha)`` mesh.  ``host_buffer`` is two: every buffer to
    the host's staging copy, then each to its destination; the host is a
    place of its own on the CPU, so both hops count between positions,
    ``2 * n_parts * part_bytes``, and between devices where a position is
    not on the CPU.
    """
    devs = mesh.device_list()
    fine = part_positions(mesh, n_parts)
    to = _owners_of_parts(mesh, n_parts, alpha) if solve_layout else fine
    if schedule == "device_direct":
        return _carry(devs, zip(fine, to), part_bytes)
    if schedule != "host_buffer":
        raise ValueError(f"unknown update schedule {schedule!r}")
    h = len(devs)   # the host's place, one past the positions
    devs = devs + [torch.device("cpu")]
    return (_carry(devs, ((a, h) for a in fine), part_bytes)
            + _carry(devs, ((h, b) for b in to), part_bytes))


def halo_moves(mesh, n_parts: int, plane_bytes: int) -> MoveStats:
    """One neighbour-plane exchange of the fine partition (each part reads
    its neighbours' facing planes, ``plane_bytes`` each way), counted
    where the two parts are on distinct positions."""
    devs = mesh.device_list()
    fine = part_positions(mesh, n_parts)
    return _carry(devs, ((fine[f], fine[f + 1]) for f in range(n_parts - 1)),
                  2 * plane_bytes)


class MoveRecord:
    """One step's moves over a mesh, by kind (``kinds``: kind ->
    :class:`~repro_torch.core.layout.MoveStats`); the step's seed clears
    it and its phases add to it."""

    def __init__(self):
        self.kinds: dict[str, MoveStats] = {}

    def reset(self) -> None:
        self.kinds = {}

    def add(self, kind: str, stats: MoveStats) -> None:
        self.kinds[kind] = self.kinds.get(kind, MoveStats()) + stats

    def total(self) -> MoveStats:
        return sum(self.kinds.values(), MoveStats())

    def as_dict(self) -> dict:
        """``{kind: {"positions": B, "devices": B}}`` with a ``"total"``
        entry."""
        rows = dict(self.kinds, total=self.total())
        return {k: v._asdict() for k, v in rows.items()}
