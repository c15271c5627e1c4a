"""Preconditioned conjugate gradients over a pluggable SolverOps backend.

Mirrors Ginkgo's CG used for the paper's pressure solves.  The body is
written against :class:`repro_torch.solvers.ops.SolverOps`, so one control
flow serves the plain-PyTorch and the fused-kernel backends.

The JAX package's ``lax.while_loop`` becomes a Python loop.  The squared
residual norm ``r . r`` is **carried** from one iteration to the next (the
``fused_step`` computes it), and the loop condition reads that carried
value — one host read per iteration, no extra reduction.  As in JAX the
condition is evaluated on the initial state too, so a NaN residual gives 0
iterations with ``converged`` and ``hit_cap`` both False.

**Iterative refinement.**  When the bundle's policy refines (``f32_ir`` /
``bf16_ir``), that loop becomes the *inner sweep* of an outer f64 loop:
replay the true residual ``r = b - A_hi x`` in f64, solve the correction
system ``A_lo d = r`` with one sweep at the storage dtype from zero to
``inner_tol`` relative to the correction's own residual, apply ``x += d``
in f64, and repeat until the caller's tolerance holds on the carried f64
``r . r`` or ``max_outer`` passes ran.  The exit flags keep the plain
path's health signature (NaN anywhere: ``converged`` and ``hit_cap`` both
False).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.solvers.ops import SolverOps, _vdot, reference_ops

__all__ = ["cg", "CGResult", "threshold_sq", "inner_threshold_sq"]


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int            # Krylov iterations run (inner total when refined)
    residual: torch.Tensor  # final ||r||_2 (0-d; the f64 true residual
    #                         when refined)
    converged: bool       # ||r|| <= threshold at exit (False on NaN)
    hit_cap: bool         # exited at an iteration cap w/o converging
    outer_iters: int = 0  # refinement passes (0 on the f64 policy)


def threshold_sq(bb: torch.Tensor, tol: float, atol: float) -> float:
    """``max(tol * ||b||, atol)^2`` as a host float (one device read)."""
    return float(torch.clamp_min(tol * torch.sqrt(bb), atol) ** 2)


def inner_threshold_sq(inner_tol: float, rr_lo: torch.Tensor) -> float:
    """An inner sweep's threshold ``inner_tol^2 * rr_lo``, formed as a
    product in ``rr_lo``'s (accum) dtype and read once.  The read is exact
    (a float32 value is a double), so comparing the sweep's carried ``r.r``
    against it on the host decides as the accum-dtype comparison does."""
    return float(inner_tol ** 2 * rr_lo)


def _cg_sweep(ops: SolverOps, b, x0, thr: float, maxiter: int):
    """One preconditioned-CG loop at the bundle's storage dtype.

    Returns ``(x, rr, k)``: the iterate, the carried squared residual norm
    (accum dtype, 0-d) and the iteration count.  The f64 policy runs this
    once; it is the plain solver.
    """
    x = x0
    r = b - ops.matvec(x0)
    p = ops.precond(r)
    gamma, rr = ops.dots((r, p), (r, r))
    k = 0
    while float(rr) > thr and k < maxiter:
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
    k_out = inner_total = 0
    inner_capped = False
    while float(rr) > thr and k_out < pol.max_outer:
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
        inner_total += k_in
        inner_capped = inner_capped or k_in >= maxiter
    rr_h = float(rr)
    converged = rr_h <= thr
    hit_cap = (k_out >= pol.max_outer or inner_capped) and not converged
    return CGResult(x=x, iters=inner_total, residual=torch.sqrt(rr),
                    converged=converged, hit_cap=hit_cap, outer_iters=k_out)


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
    rr_h = float(rr)
    # NaN compares False on both sides: converged and hit_cap both stay
    # False, which the step's health flags read as divergence
    converged = rr_h <= thr
    return CGResult(x=x, iters=k, residual=torch.sqrt(rr),
                    converged=converged,
                    hit_cap=(k >= maxiter) and not converged)
