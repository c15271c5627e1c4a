"""The CG loop's device-side control: CUDA kernels and plain versions.

Three port-only kernels (``csrc/krylov_loop.cu``; no TPU kernel does this
work) let :mod:`repro_torch.solvers.device_loop` run CG iterations from a
captured CUDA graph with no host read per iteration:

* :func:`cg_direction` — ``p <- z + beta p`` in place with ``beta =
  gamma_new / gamma`` read on the device; bitwise PyTorch's eager ``z +
  (gamma_new / gamma).to(z.dtype) * p`` (the JAX solver's
  ``src/repro/solvers/cg.py:74``).  Bound by bytes: three values per row;
* :func:`cg_alpha` — ``pAp <-`` the sum of the SpMV+dot's ``p.Ap``
  partials and ``alpha <- gamma / pAp`` (JAX: ``cg.py:74`` over the
  ``jnp.sum`` of ``src/repro/kernels/krylov_fused/ops.py:47``);
* :func:`cg_advance` — the sums of the axpy's ``r.z`` and ``r.r``
  partials into ``gamma_new`` and ``rr_new`` (JAX: ``ops.py:68``), then the
  loop's carry update and condition (JAX: the ``lax.while_loop`` of
  ``cg.py:78`` and its ``cond``, ``:64``): while the flag ``active`` is
  set, ``gamma <- gamma_new``, ``rr <- rr_new``, ``k += 1`` and ``active <-
  (rr > thr) & (k < maxiter)``.

:func:`cg_alpha` and :func:`cg_advance` are the CG iteration's scalar
tail: a thread-block cluster of :data:`TAIL_CTAS` CTAs per lane sums the
lane's partials in one fixed tree (the kernel file's notes), no atomics,
so a sum repeats bit for bit and a lane of a cohort gives its solo run's
bits.  :func:`lane_tree_sums_plain` is that tree in PyTorch (a run of
one partial sums to the value itself: the full-mesh bundle hands its own
sums so).  :func:`cg_advance_plain` given no partials takes ``gamma_new``
and ``rr_new`` as the sums: the reference bundle's advance.
:func:`partials_sum` is :func:`cg_alpha` without ``alpha``, the sums of
the fused bundle's host-loop members.

The CG loop no longer launches :func:`cg_direction`: it folds the update
into the next iteration's SpMV+dot
(:func:`~repro_torch.kernels.krylov_fused.krylov_fused.spmv_dot_direction`),
over two direction buffers (:func:`direction_pair`) that a lane at count
``k`` reads as buffer ``k % 2`` and writes as ``(k + 1) % 2``, with the
``beta`` that :func:`cg_advance` keeps.  :func:`next_direction_plain`,
:func:`store_direction` and :func:`current_direction` are that scheme in
plain PyTorch.  :func:`cg_direction` stays as the unfused form the fold is
held against.

The kernels read the loop guard ``active`` (one bool per lane) and write
nothing of a lane whose flag is False; a guarded launch counts itself on
the device (:mod:`repro_torch.kernels.device_counts`), an unguarded one at
the call.  Beside each is its plain PyTorch version
(:func:`cg_direction_plain`, :func:`cg_alpha_plain`,
:func:`cg_advance_plain`), which the wrappers take for CPU tensors only and
the plain backend (:func:`~repro_torch.solvers.ops.reference_ops`) takes on
every device: a select on ``active``, so it too runs inside a captured
graph.

**Lanes.**  A cohort of ``B`` systems of one shape (one contiguous run of
``p`` and ``z`` each, one run of partials each) runs as one launch: the
scalars and the flag hold one element per lane, ``cg_direction`` runs
``B`` block rows and the tail kernels ``B`` cluster rows, each lane's work
exactly the single system's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import dtype_code, load
from repro_torch.kernels.device_counts import MAX_LANES, count_ptr
from repro_torch.kernels.spmv_dia.spmv_dia import (check_flag, check_lanes,
                                                   guarded_store, stream_ptr)

__all__ = ["cg_direction", "cg_direction_plain", "cg_alpha",
           "cg_alpha_plain", "cg_advance", "cg_advance_plain",
           "partials_sum", "lane_tree_sums_plain", "cg_direction_cost",
           "cg_alpha_cost", "cg_advance_cost", "direction_pair",
           "next_direction_plain", "store_direction", "current_direction",
           "TAIL_CTAS"]

# the tail kernels' cluster: CTAs per lane and threads per CTA
# (csrc/krylov_loop.cu: kTailCtas, common.cuh: kThreads)
TAIL_CTAS = 8
TAIL_THREADS = 256


def cg_direction_cost(n: int, itemsize: int = 8) -> dict:
    """Bytes and flops of ``p <- z + beta p`` on ``n`` rows: z and p read
    once, p written once (the two accum scalars are negligible)."""
    return {"bytes_accessed": 3 * n * itemsize, "flops": 2 * n,
            "transcendentals": 0}


def cg_alpha_cost(npl: int, lanes: int = 1, itemsize: int = 8) -> dict:
    """Bytes and operations of :func:`cg_alpha` on ``lanes`` runs of
    ``npl`` partials: the partials and ``gamma`` read, ``pAp`` and
    ``alpha`` written; an add per partial and a division per lane."""
    return {"bytes_accessed": (npl + 3) * lanes * itemsize,
            "flops": npl * lanes, "transcendentals": 0}


def cg_advance_cost(npl: int, lanes: int = 1, itemsize: int = 8) -> dict:
    """Bytes and operations of :func:`cg_advance` on ``lanes`` lanes of
    ``npl`` partials: the ``r.z`` and ``r.r`` runs read and ``gamma_new``,
    ``rr_new`` written (an add per partial); then ``gamma``, ``rr``,
    ``thr``, ``k`` and the flag read, ``beta``, ``gamma``, ``rr``, ``k``
    and the flag written."""
    return {"bytes_accessed": lanes * ((2 * npl + 7) * itemsize + 2 * 4 + 2),
            "flops": lanes * (2 * npl + 3), "transcendentals": 0}


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


def lane_tree_sums_plain(part: torch.Tensor, npl: int, stride: int,
                         lanes: int) -> torch.Tensor:
    """Each lane's ``npl`` partials (lane ``l`` at ``part[l * stride:]``)
    summed in the tail kernels' tree (``csrc/krylov_loop.cu``), ``(lanes,)``
    of ``part``'s dtype: a lane's run in :data:`TAIL_CTAS` contiguous
    chunks of ``J`` rounds of :data:`TAIL_THREADS` 16-byte vectors (zeros
    past ``npl``); each thread adds its vectors' values in order from +0.0,
    each warp of 32 threads adds down ``w[:h] + w[h:]`` (h = 16 .. 1), each
    chunk's 8 warp sums likewise (h = 4, 2, 1), and the chunks' sums are
    added in chunk order."""
    W = 16 // part.element_size()
    J = -(-npl // (TAIL_CTAS * TAIL_THREADS * W))
    runs = part.as_strided((lanes, npl), (stride, 1))
    a = part.new_zeros((lanes, TAIL_CTAS * J * TAIL_THREADS * W))
    a[:, :npl] = runs
    a = a.view(lanes, TAIL_CTAS, J, TAIL_THREADS, W)
    acc = part.new_zeros((lanes, TAIL_CTAS, TAIL_THREADS))
    for j in range(J):
        for e in range(W):
            acc = acc + a[:, :, j, :, e]
    w = acc.view(lanes, TAIL_CTAS, TAIL_THREADS // 32, 32)
    for h in (16, 8, 4, 2, 1):
        w = w[..., :h] + w[..., h:]
    w = w[..., 0]
    for h in (4, 2, 1):
        w = w[..., :h] + w[..., h:]
    w = w[..., 0]
    total = w[:, 0]
    for c in range(1, TAIL_CTAS):
        total = total + w[:, c]
    return total


def cg_alpha_plain(part: torch.Tensor, npl: int, stride: int,
                   pAp: torch.Tensor, gamma: torch.Tensor | None = None,
                   alpha: torch.Tensor | None = None,
                   active: torch.Tensor | None = None) -> None:
    """:func:`cg_alpha` in plain PyTorch: ``pAp <-`` each lane's partials
    summed by :func:`lane_tree_sums_plain` and, with ``gamma``, ``alpha <-
    gamma / pAp``, both through selects on ``active``."""
    sums = lane_tree_sums_plain(part, npl, stride,
                                pAp.numel()).reshape(pAp.shape)
    guarded_store(pAp, sums, active)
    if gamma is not None:
        guarded_store(alpha, gamma / sums, active)


def cg_advance_plain(gamma, gamma_new, rr, rr_new, k, active, thr,
                     maxiter: int, beta=None, part: dict | None = None
                     ) -> None:
    """The loop guard in plain PyTorch: with ``part`` (``{"rz", "rr",
    "npl", "stride"}`` as :func:`~repro_torch.kernels.krylov_fused.
    krylov_fused.partials_buffers` lays them out), ``gamma_new`` and
    ``rr_new`` <- the sums of each lane's ``r.z`` and ``r.r`` partials
    (:func:`lane_tree_sums_plain`) first; then, while ``active``, ``beta <-
    gamma_new / gamma`` (when given), ``gamma <- gamma_new``, ``rr <-
    rr_new``, ``k += 1`` and ``active <- (rr > thr) & (k < maxiter)``;
    nothing changes once ``active`` is False.  Every operand holds one
    element per lane, element-wise."""
    if part is not None:
        lanes = active.numel()
        for dst, key in ((gamma_new, "rz"), (rr_new, "rr")):
            guarded_store(dst, lane_tree_sums_plain(
                part[key], part["npl"], part["stride"], lanes
            ).reshape(dst.shape), active)
    if beta is not None:
        torch.where(active, gamma_new / gamma, beta, out=beta)
    torch.where(active, gamma_new, gamma, out=gamma)
    torch.where(active, rr_new, rr, out=rr)
    k.add_(active.to(k.dtype))
    torch.logical_and(active, (rr > thr) & (k < maxiter), out=active)


def _check_run(part: torch.Tensor, npl: int, stride: int, lanes: int,
               dtype: torch.dtype, device: torch.device) -> None:
    """Raise unless ``part`` holds ``lanes`` runs of ``npl`` partials of
    ``dtype`` on ``device``, ``stride`` apart."""
    if (part.dtype != dtype or part.device != device
            or not part.is_contiguous() or npl < 1
            or (lanes > 1 and stride < npl)
            or part.numel() < (lanes - 1) * stride + npl):
        raise ValueError(f"the partials must be a contiguous {dtype} tensor "
                         f"on {device} holding {lanes} run(s) of {npl}, "
                         f"{stride} apart")


def cg_alpha(part: torch.Tensor, npl: int, stride: int, pAp: torch.Tensor,
             gamma: torch.Tensor | None = None,
             alpha: torch.Tensor | None = None,
             active: torch.Tensor | None = None) -> None:
    """The first half of the CG iteration's scalar tail on the device:
    ``pAp`` (one accum value per lane, ``pAp.numel()`` lanes) <- the sum of
    lane ``l``'s ``npl`` partials at ``part[l * stride:]`` and, with
    ``gamma``, ``alpha <- gamma / pAp`` (``gamma``, ``alpha`` like
    ``pAp``); under the loop guard ``active`` nothing of a lane whose flag
    is False is written.  On CPU tensors: :func:`cg_alpha_plain`."""
    if pAp.device.type == "cpu":
        return cg_alpha_plain(part, npl, stride, pAp, gamma, alpha, active)
    acc, dev, lanes = pAp.dtype, pAp.device, pAp.numel()
    _check_run(part, npl, stride, lanes, acc, dev)
    scalars = (pAp,) + (() if gamma is None else (gamma, alpha))
    if any(s.dtype != acc or s.numel() != lanes or s.device != dev
           or not s.is_contiguous() for s in scalars):
        raise ValueError("pAp, gamma and alpha must be contiguous tensors of "
                         "the partials' dtype, one element per lane")
    rc = load("krylov_loop").cg_alpha_launch(
        dtype_code(acc, acc), part.data_ptr(), npl, stride, pAp.data_ptr(),
        0 if gamma is None else gamma.data_ptr(),
        0 if gamma is None else alpha.data_ptr(), lanes,
        check_flag(active, dev, lanes), count_ptr("cg_alpha", dev, active),
        stream_ptr(pAp))
    if rc != 0:
        raise RuntimeError(f"cg_alpha kernel launch failed (code {rc})")
    if active is None:  # a guarded launch counts itself on the device
        cg_alpha.launches += 1


def partials_sum(part: torch.Tensor) -> torch.Tensor:
    """One run of partials summed in the tail kernels' tree, 0-d:
    :func:`cg_alpha` without ``alpha``, unguarded."""
    out = torch.empty((), dtype=part.dtype, device=part.device)
    cg_alpha(part, part.numel(), part.numel(), out)
    return out


def cg_advance(gamma, gamma_new, rr, rr_new, k, active, thr,
               maxiter: int, beta=None, part: dict | None = None) -> None:
    """The CG loop's carry update and condition on the device (see the
    module doc): the five scalars tensors (six with ``beta``, which keeps
    ``gamma_new / gamma`` for the next direction update) of the accum
    dtype, ``k`` int32, ``active`` bool, all on one device and contiguous,
    one element per lane (``active.numel()`` lanes, at most
    :data:`~repro_torch.kernels.device_counts.MAX_LANES`).  ``part`` (as
    :func:`cg_advance_plain` takes it; the kernel requires it) holds each
    lane's ``r.z`` and ``r.r`` partials, whose sums are written to
    ``gamma_new`` and ``rr_new`` first.  On CPU tensors:
    :func:`cg_advance_plain`."""
    if active.device.type == "cpu":
        return cg_advance_plain(gamma, gamma_new, rr, rr_new, k, active,
                                thr, maxiter, beta, part)
    scalars = (gamma, gamma_new, rr, rr_new, thr) + (
        () if beta is None else (beta,))
    acc, dev = gamma.dtype, active.device
    lanes = active.numel()
    if lanes > MAX_LANES:
        raise ValueError(f"{lanes} lanes; cg_advance takes at most "
                         f"{MAX_LANES}")
    if any(s.dtype != acc or s.numel() != lanes or s.device != dev
           or not s.is_contiguous() for s in scalars):
        raise ValueError("gamma, gamma_new, rr, rr_new, thr and beta must "
                         "be contiguous tensors of one dtype on one device, "
                         "one element per lane")
    if (k.dtype != torch.int32 or k.numel() != lanes
            or k.device != dev or not k.is_contiguous()):
        raise ValueError("k must be an int32 tensor, one element per lane")
    if part is None:
        raise ValueError("the cg_advance kernel sums the r.z and r.r "
                         "partials: pass part")
    npl, stride = part["npl"], part["stride"]
    for key in ("rz", "rr"):
        _check_run(part[key], npl, stride, lanes, acc, dev)
    rc = load("krylov_loop").cg_advance_launch(
        dtype_code(acc, acc), gamma.data_ptr(), gamma_new.data_ptr(),
        rr.data_ptr(), rr_new.data_ptr(), k.data_ptr(),
        check_flag(active, dev, lanes), thr.data_ptr(), int(maxiter),
        0 if beta is None else beta.data_ptr(), part["rz"].data_ptr(),
        part["rr"].data_ptr(), npl, stride, lanes,
        count_ptr("cg_advance", dev, active), stream_ptr(active))
    if rc != 0:
        raise RuntimeError(f"cg_advance kernel launch failed (code {rc})")
    # always guarded: the kernel counts its launches on the device


cg_direction.launches = 0
cg_alpha.launches = 0
cg_advance.launches = 0
