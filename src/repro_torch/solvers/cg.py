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
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.solvers.ops import SolverOps, reference_ops

__all__ = ["cg", "CGResult", "threshold_sq"]


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int            # Krylov iterations run
    residual: torch.Tensor  # final ||r||_2 (0-d, the solve's device)
    converged: bool       # ||r|| <= threshold at exit (False on NaN)
    hit_cap: bool         # exited at the iteration cap w/o converging


def threshold_sq(bb: torch.Tensor, tol: float, atol: float) -> float:
    """``max(tol * ||b||, atol)^2`` as a host float (one device read)."""
    return float(torch.clamp_min(tol * torch.sqrt(bb), atol) ** 2)


def cg(A: Callable[[torch.Tensor], torch.Tensor] | SolverOps,
       b: torch.Tensor, x0: torch.Tensor, *,
       M: Callable[[torch.Tensor], torch.Tensor] | None = None,
       tol: float = 1e-8, atol: float = 0.0, maxiter: int = 1000) -> CGResult:
    """Solve ``A x = b`` (SPD) with preconditioned CG.

    ``A`` is either an operator closure (with ``M`` applying the
    preconditioner inverse) or a ready-made :class:`SolverOps` bundle
    (``M`` must then be None).  Converged means ``||r|| <= max(tol *
    ||b||, atol)``.
    """
    if isinstance(A, SolverOps):
        if M is not None:
            raise ValueError("pass the preconditioner inside SolverOps")
        ops = A
    else:
        ops = reference_ops(A, M)

    (bb,) = ops.dots((b, b))
    thr = threshold_sq(bb, tol, atol)
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
    rr_h = float(rr)
    # NaN compares False on both sides: converged and hit_cap both stay
    # False, which the step's health flags read as divergence
    converged = rr_h <= thr
    return CGResult(x=x, iters=k, residual=torch.sqrt(rr),
                    converged=converged,
                    hit_cap=(k >= maxiter) and not converged)
