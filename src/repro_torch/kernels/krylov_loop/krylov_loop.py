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

The CG loop no longer launches :func:`cg_direction`: it folds the update
into the next iteration's SpMV+dot
(:func:`~repro_torch.kernels.krylov_fused.krylov_fused.spmv_dot_direction`),
over two direction buffers (:func:`direction_pair`) that a lane at count
``k`` reads as buffer ``k % 2`` and writes as ``(k + 1) % 2``, with the
``beta`` that :func:`cg_advance` keeps.  :func:`next_direction_plain`,
:func:`store_direction` and :func:`current_direction` are that scheme in
plain PyTorch.  :func:`cg_direction` stays as the unfused form the fold is
held against.

Both kernels read the loop guard ``active`` (a one-element bool tensor) and
write nothing while it is False; a guarded launch counts itself on the device
(:mod:`repro_torch.kernels.device_counts`), an unguarded one at the call.  Beside each is its plain PyTorch version
(:func:`cg_direction_plain`, :func:`cg_advance_plain`), which the wrappers
take for CPU tensors only and the plain backend
(:func:`~repro_torch.solvers.ops.reference_ops`) takes on every device: a
select on ``active``, so it too runs inside a captured graph.

**Lanes.**  A cohort of ``B`` systems of one shape (one contiguous run of
``p`` and ``z`` each) runs as one launch: the scalars and the flag hold one
element per lane, ``cg_direction`` runs ``B`` block rows and
``cg_advance`` ``B`` threads, each lane's work exactly the single system's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import dtype_code, load
from repro_torch.kernels.device_counts import count_ptr
from repro_torch.kernels.spmv_dia.spmv_dia import (check_flag, check_lanes,
                                                   guarded_store, stream_ptr)

__all__ = ["cg_direction", "cg_direction_plain", "cg_advance",
           "cg_advance_plain", "cg_direction_cost", "cg_advance_cost",
           "direction_pair", "next_direction_plain", "store_direction",
           "current_direction"]


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


def _step(z: torch.Tensor, beta: torch.Tensor,
          p: torch.Tensor) -> torch.Tensor:
    """``z + beta.to(z.dtype) * p`` on ``(lanes, rows)`` views, ``beta``
    ``(lanes, 1)``: PyTorch's eager rounding, which the kernels repeat."""
    return z + beta.to(z.dtype) * p


def cg_direction_plain(p: torch.Tensor, z: torch.Tensor,
                       gamma_new: torch.Tensor, gamma: torch.Tensor,
                       active: torch.Tensor | None = None) -> torch.Tensor:
    """``p <- z + (gamma_new / gamma).to(z.dtype) * p`` in place (under
    the guard ``active``), one ``beta`` per lane (``gamma.numel()`` lanes);
    returns ``p``."""
    lanes = gamma.numel()
    beta = (gamma_new / gamma).reshape(lanes, 1)
    new = _step(z.reshape(lanes, -1), beta, p.reshape(lanes, -1))
    return guarded_store(p, new.view(p.shape), active)


def direction_pair(like: torch.Tensor) -> torch.Tensor:
    """The CG loop's two direction buffers, ``(2, *like.shape)`` of
    ``like``'s dtype and device, each contiguous and starting on a 16-byte
    boundary (the axpy kernel's vector loads), uninitialised."""
    per = max(1, 16 // like.element_size())
    n = like.numel()
    flat = torch.empty((2, -(-n // per) * per), dtype=like.dtype,
                       device=like.device)
    return flat[:, :n].view(2, *like.shape)


def _odd(k: torch.Tensor) -> torch.Tensor:
    """Each lane's count is odd, as a ``(lanes, 1)`` bool."""
    return (k.reshape(-1, 1) % 2) == 1


def next_direction_plain(p: torch.Tensor, z: torch.Tensor,
                         beta: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The direction the fold forms at count ``k`` (one per lane), not
    stored: ``z`` itself where ``k`` is 0 (its bits, a select), else ``z +
    beta.to(z.dtype) * p[k % 2]``, as :func:`cg_direction_plain` rounds
    it.  ``p``: the pair of :func:`direction_pair`."""
    lanes = k.numel()
    zz = z.reshape(lanes, -1)
    old = torch.where(_odd(k), p[1].reshape(lanes, -1),
                      p[0].reshape(lanes, -1))
    step = _step(zz, beta.reshape(lanes, 1), old)
    return torch.where(k.reshape(lanes, 1) == 0, zz, step).view(z.shape)


def store_direction(p: torch.Tensor, new: torch.Tensor, k: torch.Tensor,
                    active: torch.Tensor | None = None) -> None:
    """``new`` into buffer ``(k + 1) % 2`` of each lane of the pair ``p``,
    and nothing in a lane whose guard flag is False: selects, so the same
    code runs inside a captured CUDA graph."""
    lanes = k.numel()
    odd = _odd(k)
    val = new.reshape(lanes, -1)
    for buf, sel in ((p[0], odd), (p[1], ~odd)):
        if active is not None:
            sel = sel & active.reshape(lanes, 1)
        o = buf.view(lanes, -1)
        torch.where(sel, val, o, out=o)


def current_direction(p: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The direction the fold wrote at count ``k``: buffer ``(k + 1) % 2``
    of each lane of the pair ``p`` (a copy)."""
    lanes = k.numel()
    cur = torch.where(_odd(k), p[0].reshape(lanes, -1),
                      p[1].reshape(lanes, -1))
    return cur.view(p.shape[1:])


def cg_direction(p: torch.Tensor, z: torch.Tensor, gamma_new: torch.Tensor,
                 gamma: torch.Tensor,
                 active: torch.Tensor | None = None) -> torch.Tensor:
    """The CG direction update in place: ``p`` and ``z`` one shape and
    storage dtype, contiguous and 16-byte aligned; ``gamma_new`` and
    ``gamma`` in the accum dtype on their device, one element per lane
    (``gamma.numel()`` lanes, each a contiguous run of ``p`` and ``z``, its
    own guard flag).  On CPU tensors: :func:`cg_direction_plain`."""
    if p.device.type == "cpu" and z.device.type == "cpu":
        return cg_direction_plain(p, z, gamma_new, gamma, active)
    if (z.shape != p.shape or z.dtype != p.dtype or z.device != p.device
            or not (p.is_contiguous() and z.is_contiguous())):
        raise ValueError("p and z must share shape, dtype and device and be "
                         "contiguous")
    if p.data_ptr() % 16 or z.data_ptr() % 16:
        raise ValueError("kernel operands must start on a 16-byte boundary")
    acc = gamma.dtype
    lanes = gamma.numel()
    for s in (gamma_new, gamma):
        if (s.dtype != acc or s.numel() != lanes or s.device != p.device
                or not s.is_contiguous()):
            raise ValueError("gamma_new and gamma must be contiguous tensors "
                             "of one dtype and size on p's device")
    n = check_lanes(p.numel(), lanes, p.element_size())
    rc = load("krylov_loop").cg_direction_launch(
        dtype_code(p.dtype, acc), p.data_ptr(), z.data_ptr(),
        gamma_new.data_ptr(), gamma.data_ptr(), n, lanes,
        check_flag(active, p.device, lanes),
        count_ptr("cg_direction", p.device, active), stream_ptr(p))
    if rc != 0:
        raise RuntimeError(f"cg_direction kernel launch failed (code {rc})")
    if active is None:  # a guarded launch counts itself on the device
        cg_direction.launches += 1
    return p


def cg_advance_plain(gamma, gamma_new, rr, rr_new, k, active, thr,
                     maxiter: int, beta=None) -> None:
    """The loop guard in plain PyTorch: while ``active``, ``beta <-
    gamma_new / gamma`` (when given), ``gamma <- gamma_new``, ``rr <-
    rr_new``, ``k += 1`` and ``active <- (rr > thr) & (k < maxiter)``;
    nothing changes once ``active`` is False.  Every operand holds one
    element per lane, element-wise."""
    if beta is not None:
        torch.where(active, gamma_new / gamma, beta, out=beta)
    torch.where(active, gamma_new, gamma, out=gamma)
    torch.where(active, rr_new, rr, out=rr)
    k.add_(active.to(k.dtype))
    torch.logical_and(active, (rr > thr) & (k < maxiter), out=active)


def cg_advance(gamma, gamma_new, rr, rr_new, k, active, thr,
               maxiter: int, beta=None) -> None:
    """The CG loop's carry update and condition on the device (see the
    module doc): the five scalars tensors (six with ``beta``, which keeps
    ``gamma_new / gamma`` for the next direction update) of the accum
    dtype, ``k`` int32, ``active`` bool, all on one device and contiguous,
    one element per lane (``active.numel()`` lanes, at most 1024).  On CPU
    tensors: :func:`cg_advance_plain`."""
    scalars = (gamma, gamma_new, rr, rr_new, thr) + (
        () if beta is None else (beta,))
    if active.device.type == "cpu":
        return cg_advance_plain(gamma, gamma_new, rr, rr_new, k, active,
                                thr, maxiter, beta)
    acc = gamma.dtype
    lanes = active.numel()
    if any(s.dtype != acc or s.numel() != lanes or s.device != active.device
           or not s.is_contiguous() for s in scalars):
        raise ValueError("gamma, gamma_new, rr, rr_new, thr and beta must "
                         "be contiguous tensors of one dtype on one device, "
                         "one element per lane")
    if (k.dtype != torch.int32 or k.numel() != lanes
            or k.device != active.device or not k.is_contiguous()):
        raise ValueError("k must be an int32 tensor, one element per lane")
    rc = load("krylov_loop").cg_advance_launch(
        dtype_code(acc, acc), gamma.data_ptr(), gamma_new.data_ptr(),
        rr.data_ptr(), rr_new.data_ptr(), k.data_ptr(),
        check_flag(active, active.device, lanes), thr.data_ptr(),
        int(maxiter), 0 if beta is None else beta.data_ptr(), lanes,
        count_ptr("cg_advance", active.device, active), stream_ptr(active))
    if rc != 0:
        raise RuntimeError(f"cg_advance kernel launch failed (code {rc})")
    # always guarded: the kernel counts its launches on the device


cg_direction.launches = 0
cg_advance.launches = 0
