"""Runtime matrix-coefficient update (paper §3, fig. 3b) — two-phase design.

The *plan* (:class:`~repro_torch.core.repartition.RepartitionPlan`) is built
once; every outer iteration only the coefficient **values** move.  The
paper's update pattern ``U`` (send targets + pointers + sizes) and
permutation ``P`` collapse here into:

1. a grouped concatenation of the alpha fine-part coefficient buffers that
   belong to one coarse part (the blockwise distribution makes the target
   contiguous);
2. a single gather by the precomputed ``dia_src`` index (P ∘ U) into the
   solver's DIA layout.  The index is copied to the device once per plan
   (:func:`dia_index`) and every update is one ``index_select``.

Two communication schedules mirror the paper's fig. 9:

* ``device_direct`` — the buffers go straight into the gather (GPU-aware
  MPI: each rank sends into the device buffer);
* ``host_buffer`` — the grouped buffers are staged through host memory
  first and copied back (the non-GPU-aware path: gather on the CPU rank,
  then copy to the GPU in a separate step).  Values are identical; only the
  data movement differs.
"""
from __future__ import annotations

import torch

from repro_torch.core.repartition import RepartitionPlan

__all__ = [
    "dia_index",
    "concat_group_buffers",
    "dia_values",
    "update_device_direct",
    "update_host_buffer",
]


def dia_index(plan: RepartitionPlan, device) -> torch.Tensor:
    """The plan's flattened ``dia_src`` (n_bands * m_c,) int64 on ``device``."""
    return torch.as_tensor(plan.dia_src.reshape(-1), dtype=torch.int64,
                           device=device)


def concat_group_buffers(buffers: torch.Tensor) -> torch.Tensor:
    """(n_coarse, alpha, L) per-fine-part buffers → (n_coarse, alpha*L + 1).

    The +1 appends the sentinel zero slot that empty band positions gather
    from.
    """
    n_c = buffers.shape[0]
    flat = buffers.reshape(n_c, -1)
    zero = torch.zeros((n_c, 1), dtype=flat.dtype, device=flat.device)
    return torch.cat([flat, zero], dim=1)


def dia_values(plan: RepartitionPlan, buf_cat: torch.Tensor,
               src: torch.Tensor) -> torch.Tensor:
    """Apply P∘U: (n_coarse, alpha*L+1) → DIA bands (n_coarse, n_bands, m_c).

    ``src`` is :func:`dia_index` of ``plan`` on the buffers' device.
    """
    nb = len(plan.dia_offsets)
    return buf_cat.index_select(1, src).reshape(buf_cat.shape[0], nb,
                                                plan.m_coarse)


def update_device_direct(plan: RepartitionPlan, buffers: torch.Tensor,
                         src: torch.Tensor) -> torch.Tensor:
    """One-hop update: grouped concatenation + permutation."""
    return dia_values(plan, concat_group_buffers(buffers), src)


def update_host_buffer(plan: RepartitionPlan, buffers: torch.Tensor,
                       src: torch.Tensor) -> torch.Tensor:
    """Two-hop update (paper fig. 9, 'HB'): stage the grouped buffers in
    host memory, copy them back to their device, then permute."""
    staged = buffers.to("cpu", copy=True).to(buffers.device)
    return dia_values(plan, concat_group_buffers(staged), src)
