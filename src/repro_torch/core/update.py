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
"""
from __future__ import annotations

import torch

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
