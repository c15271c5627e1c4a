"""BiCGStab for the (non-symmetric) momentum systems — OpenFOAM's choice.

Same conventions as :mod:`repro_torch.solvers.cg`: the body runs over a
:class:`repro_torch.solvers.ops.SolverOps` backend (or wraps ``A``/``M``
closures into the reference one), global dots, a Python loop whose
condition reads the carried squared residual norm — one host read per
iteration, which also carries the breakdown test.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.solvers.cg import threshold_sq
from repro_torch.solvers.ops import SolverOps, reference_ops

__all__ = ["bicgstab", "BiCGStabResult"]


class BiCGStabResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual: torch.Tensor
    converged: bool       # ||r|| <= threshold at exit (False on NaN)
    hit_cap: bool         # exited at the iteration cap w/o converging


def _safe_div(num, den):
    """num/den with 0 where den == 0 (breakdown guard)."""
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def bicgstab(A: Callable[[torch.Tensor], torch.Tensor] | SolverOps,
             b: torch.Tensor, x0: torch.Tensor, *,
             M: Callable[[torch.Tensor], torch.Tensor] | None = None,
             tol: float = 1e-8, atol: float = 0.0,
             maxiter: int = 1000) -> BiCGStabResult:
    """Solve ``A x = b`` with preconditioned BiCGStab.

    Breakdown-guarded exactly as the JAX solver: when ``rho = <rhat, r>``
    or ``<rhat, v>`` vanishes the iteration that found it still counts, the
    previous iterate is kept and the loop stops.  ``<t, t> = 0`` forces
    ``omega`` to 0 (the plain BiCG half-step, NaN-free).
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
    rhat = r  # shadow residual
    (rr,) = ops.dots((r, r))
    one = torch.ones((), dtype=rr.dtype, device=rr.device)
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = one
    k = 0
    rr_h = float(rr)
    brk = False
    while rr_h > thr and k < maxiter and not brk:
        (rho_new,) = ops.dots((rhat, r))
        beta = _safe_div(rho_new * alpha, rho * omega)
        p_new = r + beta.to(r.dtype) * (p - omega.to(r.dtype) * v)
        phat = ops.precond(p_new)
        v_new = ops.matvec(phat)
        (rv,) = ops.dots((rhat, v_new))
        alpha_new = _safe_div(rho_new, rv)
        a_lo = alpha_new.to(r.dtype)
        s = r - a_lo * v_new
        shat = ops.precond(s)
        t = ops.matvec(shat)
        ts, tt = ops.dots((t, s), (t, t))
        omega_new = _safe_div(ts, tt)
        o_lo = omega_new.to(r.dtype)
        x_new = x + a_lo * phat + o_lo * shat
        r_new = s - o_lo * t
        (rr_new,) = ops.dots((r_new, r_new))
        k += 1
        # one host read: the carried residual and the breakdown test
        rr_new_h, rho_h, rv_h = torch.stack([rr_new, rho_new, rv]).tolist()
        # rho or <rhat, v> hitting zero is a true breakdown: the step above
        # is no longer a Krylov update — keep the previous iterate and stop
        brk = rho_h == 0 or rv_h == 0
        if not brk:
            x, r, p, v = x_new, r_new, p_new, v_new
            rho, alpha, omega, rr = rho_new, alpha_new, omega_new, rr_new
            rr_h = rr_new_h
    # NaN rr yields converged=False and hit_cap=False; a breakdown exit
    # before the cap reports converged=False too
    converged = rr_h <= thr
    return BiCGStabResult(x=x, iters=k, residual=torch.sqrt(rr),
                          converged=converged,
                          hit_cap=(k >= maxiter) and not converged)
