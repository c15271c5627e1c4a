"""The CG loop's device-side control: CUDA kernels and plain versions.

Two port-only kernels (``csrc/krylov_loop.cu``; no TPU kernel does this
work) let :mod:`repro_torch.solvers.device_loop` run CG iterations from a
captured CUDA graph with no host read per iteration:

* :func:`cg_direction` — ``p <- z + beta p`` in place with ``beta =
  gamma_new / gamma`` read on the device; bitwise PyTorch's eager ``z +
  (gamma_new / gamma).to(z.dtype) * p`` (the JAX solver's
  ``src/repro/solvers/cg.py:74``).  Bound by bytes: three values per row;
* :func:`cg_advance` — the loop's carry update and condition (JAX: the
  ``lax.while_loop`` of ``cg.py:78`` and its ``cond``, ``:64``): while the
  flag ``active`` is set, ``gamma <- gamma_new``, ``rr <- rr_new``, ``k +=
  1`` and ``active <- (rr > thr) & (k < maxiter)``.  One thread.

Both read the loop guard ``active`` (a one-element bool tensor) and write
nothing while it is False; a guarded launch counts itself on the device
(:mod:`repro_torch.kernels.device_counts`), an unguarded one at the call.  Beside each is its plain PyTorch version
(:func:`cg_direction_plain`, :func:`cg_advance_plain`), which the wrappers
take for CPU tensors only and the plain backend
(:func:`~repro_torch.solvers.ops.reference_ops`) takes on every device: a
select on ``active``, so it too runs inside a captured graph.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import dtype_code, load
from repro_torch.kernels.device_counts import count_ptr
from repro_torch.kernels.spmv_dia.spmv_dia import (check_flag, guarded_store,
                                                   stream_ptr)

__all__ = ["cg_direction", "cg_direction_plain", "cg_advance",
           "cg_advance_plain", "cg_direction_cost", "cg_advance_cost"]


def cg_direction_cost(n: int, itemsize: int = 8) -> dict:
    """Bytes and flops of ``p <- z + beta p`` on ``n`` rows: z and p read
    once, p written once (the two accum scalars are negligible)."""
    return {"bytes_accessed": 3 * n * itemsize, "flops": 2 * n,
            "transcendentals": 0}


def cg_advance_cost(itemsize: int = 8) -> dict:
    """Bytes and operations of one guard update: gamma_new, rr_new, thr, k
    and the flag read; gamma, rr, k and the flag written."""
    return {"bytes_accessed": 5 * itemsize + 2 * 4 + 2,
            "flops": 3, "transcendentals": 0}


def cg_direction_plain(p: torch.Tensor, z: torch.Tensor,
                       gamma_new: torch.Tensor, gamma: torch.Tensor,
                       active: torch.Tensor | None = None) -> torch.Tensor:
    """``p <- z + (gamma_new / gamma).to(z.dtype) * p`` in place (under
    the guard ``active``); returns ``p``."""
    beta = gamma_new / gamma
    return guarded_store(p, z + beta.to(z.dtype) * p, active)


def cg_direction(p: torch.Tensor, z: torch.Tensor, gamma_new: torch.Tensor,
                 gamma: torch.Tensor,
                 active: torch.Tensor | None = None) -> torch.Tensor:
    """The CG direction update in place: ``p`` and ``z`` one shape and
    storage dtype, contiguous and 16-byte aligned; ``gamma_new`` and
    ``gamma`` 0-d in the accum dtype on their device.  On CPU tensors:
    :func:`cg_direction_plain`."""
    if p.device.type == "cpu" and z.device.type == "cpu":
        return cg_direction_plain(p, z, gamma_new, gamma, active)
    if (z.shape != p.shape or z.dtype != p.dtype or z.device != p.device
            or not (p.is_contiguous() and z.is_contiguous())):
        raise ValueError("p and z must share shape, dtype and device and be "
                         "contiguous")
    if p.data_ptr() % 16 or z.data_ptr() % 16:
        raise ValueError("kernel operands must start on a 16-byte boundary")
    acc = gamma.dtype
    for s in (gamma_new, gamma):
        if s.dtype != acc or s.numel() != 1 or s.device != p.device:
            raise ValueError("gamma_new and gamma must be one-element "
                             "tensors of one dtype on p's device")
    rc = load("krylov_loop").cg_direction_launch(
        dtype_code(p.dtype, acc), p.data_ptr(), z.data_ptr(),
        gamma_new.data_ptr(), gamma.data_ptr(), p.numel(),
        check_flag(active, p.device),
        count_ptr("cg_direction", p.device, active), stream_ptr(p))
    if rc != 0:
        raise RuntimeError(f"cg_direction kernel launch failed (code {rc})")
    if active is None:  # a guarded launch counts itself on the device
        cg_direction.launches += 1
    return p


def cg_advance_plain(gamma, gamma_new, rr, rr_new, k, active, thr,
                     maxiter: int) -> None:
    """The loop guard in plain PyTorch: while ``active``, ``gamma <-
    gamma_new``, ``rr <- rr_new``, ``k += 1`` and ``active <- (rr > thr) &
    (k < maxiter)``; nothing changes once ``active`` is False."""
    torch.where(active, gamma_new, gamma, out=gamma)
    torch.where(active, rr_new, rr, out=rr)
    k.add_(active.to(k.dtype))
    torch.logical_and(active, (rr > thr) & (k < maxiter), out=active)


def cg_advance(gamma, gamma_new, rr, rr_new, k, active, thr,
               maxiter: int) -> None:
    """The CG loop's carry update and condition on the device (see the
    module doc): the five scalars one-element tensors of the accum dtype,
    ``k`` int32, ``active`` bool, all on one device.  On CPU tensors:
    :func:`cg_advance_plain`."""
    scalars = (gamma, gamma_new, rr, rr_new, thr)
    if active.device.type == "cpu":
        return cg_advance_plain(gamma, gamma_new, rr, rr_new, k, active,
                                thr, maxiter)
    acc = gamma.dtype
    if any(s.dtype != acc or s.numel() != 1 or s.device != active.device
           for s in scalars):
        raise ValueError("gamma, gamma_new, rr, rr_new and thr must be "
                         "one-element tensors of one dtype on one device")
    if k.dtype != torch.int32 or k.numel() != 1 or k.device != active.device:
        raise ValueError("k must be a one-element int32 tensor")
    rc = load("krylov_loop").cg_advance_launch(
        dtype_code(acc, acc), gamma.data_ptr(), gamma_new.data_ptr(),
        rr.data_ptr(), rr_new.data_ptr(), k.data_ptr(),
        check_flag(active, active.device), thr.data_ptr(), int(maxiter),
        count_ptr("cg_advance", active.device, active), stream_ptr(active))
    if rc != 0:
        raise RuntimeError(f"cg_advance kernel launch failed (code {rc})")
    # always guarded: the kernel counts its launches on the device


cg_direction.launches = 0
cg_advance.launches = 0
