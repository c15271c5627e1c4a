"""Preconditioned conjugate gradients over a pluggable SolverOps backend.

Mirrors Ginkgo's CG used for the paper's pressure solves.  The body is
written against :class:`repro_torch.solvers.ops.SolverOps`, so one control
flow serves the plain-PyTorch and the fused-kernel backends.

The JAX package's ``lax.while_loop`` becomes a device-resident loop
(:mod:`repro_torch.solvers.device_loop`): the carry ``x, r, p, gamma, rr,
k`` and a device flag ``active`` live at fixed addresses, one iteration is
``matvec_dot``, ``alpha = gamma / pAp``, the in-place axpy with the
Jacobi apply and both dots, ``direction`` (``p <- z + beta p``) and
``advance`` (the carry update and ``active <- rr > thr & k < maxiter``),
every write guarded on ``active``; on the card blocks of iterations replay
from a captured CUDA graph with one host read per block.  The squared
residual norm ``r . r`` is **carried** (the fused step computes it) and
the condition is evaluated on the initial state too, so a NaN residual
gives 0 iterations with ``converged`` and ``hit_cap`` both False.  The
results are 0-d device tensors, as in JAX.  :func:`_cg_sweep_host` keeps
the former host loop (one host read per iteration) as the plain version
the device loop is held against.

**Iterative refinement.**  When the bundle's policy refines (``f32_ir`` /
``bf16_ir``), that loop becomes the *inner sweep* of an outer f64 loop:
replay the true residual ``r = b - A_hi x`` in f64, solve the correction
system ``A_lo d = r`` with one sweep at the storage dtype from zero to
``inner_tol`` relative to the correction's own residual, apply ``x += d``
in f64, and repeat until the caller's tolerance holds on the carried f64
``r . r`` or ``max_outer`` passes ran.  The outer loop reads the device
once per pass (its condition; at most ``max_outer`` reads).  The exit
flags keep the plain path's health signature (NaN anywhere: ``converged``
and ``hit_cap`` both False).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, NamedTuple

import torch

from repro_torch.solvers.device_loop import run_loop
from repro_torch.solvers.ops import SolverOps, _vdot, reference_ops

__all__ = ["cg", "CGResult", "threshold_sq", "inner_threshold_sq"]


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor     # Krylov iterations run, int32 (inner total
    #                         when refined)
    residual: torch.Tensor  # final ||r||_2 (the f64 true residual when
    #                         refined)
    converged: torch.Tensor  # ||r|| <= threshold at exit (False on NaN)
    hit_cap: torch.Tensor   # exited at an iteration cap w/o converging
    outer_iters: torch.Tensor | int = 0  # refinement passes, int32 (0 on
    #                                      the f64 policy)


def threshold_sq(bb: torch.Tensor, tol: float, atol: float) -> torch.Tensor:
    """``max(tol * ||b||, atol)^2``, 0-d on ``bb``'s device and dtype."""
    return torch.clamp_min(tol * torch.sqrt(bb), atol) ** 2


def inner_threshold_sq(inner_tol: float, rr_lo: torch.Tensor) -> torch.Tensor:
    """An inner sweep's threshold ``inner_tol^2 * rr_lo``, a product in
    ``rr_lo``'s (accum) dtype on its device: the sweep compares its carried
    ``r.r`` against it in that dtype."""
    return inner_tol ** 2 * rr_lo


def _cg_buffers(b, thr: torch.Tensor) -> SimpleNamespace:
    """The CG loop's carry (``x, r, p, gamma, rr, k, active``), scratch and
    threshold at fixed addresses, and the block captured over them."""
    vec = lambda: torch.empty_like(b)  # noqa: E731
    scal = lambda: torch.empty((), dtype=thr.dtype, device=b.device)  # noqa: E731
    return SimpleNamespace(
        x=vec(), r=vec(), p=vec(), Ap=vec(), z=vec(), gamma=scal(),
        rr=scal(), pAp=scal(), alpha=scal(), gamma_new=scal(),
        rr_new=scal(), thr=scal(), graph=None,
        k=torch.empty((), dtype=torch.int32, device=b.device),
        active=torch.empty((), dtype=torch.bool, device=b.device))


def _cg_body(ops: SolverOps, st: SimpleNamespace, maxiter: int):
    """One CG iteration over the buffers ``st``, every write guarded on the
    flag it is given.  (Made per sweep, not kept in ``st``: a closure kept
    there would make a reference cycle, and a bundle with its graph would
    then be freed by the cycle collector at some later moment, perhaps in
    the middle of another capture.)"""
    def body(flag):
        ops.matvec_dot_into(st.p, st.Ap, st.pAp, flag)
        torch.div(st.gamma, st.pAp, out=st.alpha)
        ops.fused_step_into(st.x, st.r, st.p, st.Ap, st.alpha, st.z,
                            st.gamma_new, st.rr_new, flag)
        ops.direction(st.p, st.z, st.gamma_new, st.gamma, flag)
        ops.advance(st.gamma, st.gamma_new, st.rr, st.rr_new, st.k, flag,
                    st.thr, maxiter)

    return body


def _cg_sweep(ops: SolverOps, b, x0, thr: torch.Tensor, maxiter: int):
    """One preconditioned-CG loop at the bundle's storage dtype, on the
    device loop (see the module doc).

    The bundle keeps the loop's buffers per (shape, dtype, maxiter), so a
    later sweep of the same bundle (the next refinement pass, the next
    velocity component) starts them anew in place and replays the graph
    already captured.  Returns ``(x, rr, k)``: the iterate, the carried
    squared residual norm (accum dtype, 0-d) and the iteration count (0-d
    int32), copies that the next sweep does not touch; ``x0`` is not
    written.  The f64 policy runs this once; it is the plain solver.
    """
    key = ("cg", tuple(b.shape), b.dtype, thr.dtype, maxiter)
    st = ops.loops.get(key)
    if st is None:
        st = ops.loops[key] = _cg_buffers(b, thr)
    st.x.copy_(x0)
    torch.sub(b, ops.matvec(x0), out=st.r)
    st.p.copy_(ops.precond(st.r))
    gamma, rr = ops.dots((st.r, st.p), (st.r, st.r))
    st.gamma.copy_(gamma)
    st.rr.copy_(rr)
    st.thr.copy_(thr)
    st.k.zero_()
    torch.logical_and(st.rr > st.thr, st.k < maxiter, out=st.active)
    run_loop(_cg_body(ops, st, maxiter), st, "cg")
    return st.x.clone(), st.rr.clone(), st.k.clone()


def _cg_sweep_host(ops: SolverOps, b, x0, thr: torch.Tensor, maxiter: int):
    """The former host loop of :func:`_cg_sweep`: the same arithmetic, one
    host read of the carried ``r . r`` per iteration.  Returns ``(x, rr,
    k)`` with ``k`` a Python int.  The plain version the device loop is
    held against (tests, ``chip_smoke.py``); no solve calls it."""
    x = x0
    r = b - ops.matvec(x0)
    p = ops.precond(r)
    gamma, rr = ops.dots((r, p), (r, r))
    k = 0
    while bool(rr > thr) and k < maxiter:
        Ap, pAp = ops.matvec_dot(p)
        alpha = gamma / pAp
        x, r, z, gamma_new, rr = ops.fused_step(x, r, p, Ap, alpha)
        beta = gamma_new / gamma
        p = z + beta.to(z.dtype) * p
        gamma = gamma_new
        k += 1
    return x, rr, k


def _cg_refined(ops: SolverOps, b, x0, *, tol, atol, maxiter) -> CGResult:
    """Outer f64 refinement loop around low-precision inner sweeps."""
    pol = ops.policy
    A_hi = ops.matvec_hi if ops.matvec_hi is not None else ops.matvec
    lo = pol.storage_dtype
    thr = threshold_sq(_vdot(b, b), tol, atol)
    x = x0
    r = b - A_hi(x)
    rr = _vdot(r, r)
    k_out = 0
    inner_total = torch.zeros((), dtype=torch.int32, device=b.device)
    inner_capped = torch.zeros((), dtype=torch.bool, device=b.device)
    # one host read per outer pass: the outer condition
    while bool(rr > thr) and k_out < pol.max_outer:
        # correction solve A_lo d = r at the storage dtype, from zero, to
        # the policy's loose relative tolerance
        r_lo = r.to(lo)
        (rr_lo,) = ops.dots((r_lo, r_lo))
        d, _, k_in = _cg_sweep(ops, r_lo, torch.zeros_like(r_lo),
                               inner_threshold_sq(pol.inner_tol, rr_lo),
                               maxiter)
        x = x + d.to(b.dtype)
        r = b - A_hi(x)   # f64 replay: low precision never touches x
        rr = _vdot(r, r)
        k_out += 1
        inner_total = inner_total + k_in
        inner_capped = inner_capped | (k_in >= maxiter)
    converged = rr <= thr
    hit_cap = (inner_capped | (k_out >= pol.max_outer)) & ~converged
    return CGResult(x=x, iters=inner_total, residual=torch.sqrt(rr),
                    converged=converged, hit_cap=hit_cap,
                    outer_iters=torch.full((), k_out, dtype=torch.int32,
                                           device=b.device))


def cg(A: Callable[[torch.Tensor], torch.Tensor] | SolverOps,
       b: torch.Tensor, x0: torch.Tensor, *,
       M: Callable[[torch.Tensor], torch.Tensor] | None = None,
       tol: float = 1e-8, atol: float = 0.0, maxiter: int = 1000) -> CGResult:
    """Solve ``A x = b`` (SPD) with preconditioned CG.

    ``A`` is either an operator closure (with ``M`` applying the
    preconditioner inverse) or a ready-made :class:`SolverOps` bundle
    (``M`` must then be None).  Converged means ``||r|| <= max(tol *
    ||b||, atol)``, on the true f64 residual when the bundle's policy
    refines; ``maxiter`` then caps each inner sweep.
    """
    if isinstance(A, SolverOps):
        if M is not None:
            raise ValueError("pass the preconditioner inside SolverOps")
        ops = A
    else:
        ops = reference_ops(A, M)

    if ops.policy.refine:
        return _cg_refined(ops, b, x0, tol=tol, atol=atol, maxiter=maxiter)

    (bb,) = ops.dots((b, b))
    thr = threshold_sq(bb, tol, atol)
    x, rr, k = _cg_sweep(ops, b, x0, thr, maxiter)
    # NaN compares False on both sides: converged and hit_cap both stay
    # False, which the step's health flags read as divergence
    converged = rr <= thr
    return CGResult(x=x, iters=k, residual=torch.sqrt(rr),
                    converged=converged, hit_cap=(k >= maxiter) & ~converged,
                    outer_iters=torch.zeros((), dtype=torch.int32,
                                            device=b.device))
