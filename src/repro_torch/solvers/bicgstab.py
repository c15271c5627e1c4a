"""BiCGStab for the (non-symmetric) momentum systems — OpenFOAM's choice.

Same conventions as :mod:`repro_torch.solvers.cg`: the body runs over a
:class:`repro_torch.solvers.ops.SolverOps` backend (or wraps ``A``/``M``
closures into the reference one), global dots, and the device-resident
loop of :mod:`repro_torch.solvers.device_loop`: the carry ``x, r, p, v,
rho, alpha, omega, rr, k`` at fixed addresses, both matvecs guarded on the
device flag ``active``, the vector and scalar updates written into the
carry through a select (JAX's ``keep(old, new)``, plus the flag), and the
condition ``rr > thr & k < maxiter & ~breakdown`` formed on the device.
The results are 0-d device tensors.  :func:`_bicgstab_sweep_host` keeps
the former host loop (one host read per iteration) as the plain version.
When the bundle's precision policy refines, the loop becomes the inner
sweep of the same outer f64 iterative-refinement loop as CG's
(true-residual replay ``r = b - A_hi x``, low-precision correction solve,
f64 correction apply; one host read per outer pass).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, NamedTuple

import torch

from repro_torch.solvers.cg import inner_threshold_sq, threshold_sq
from repro_torch.solvers.device_loop import run_loop
from repro_torch.solvers.ops import SolverOps, _vdot, reference_ops

__all__ = ["bicgstab", "BiCGStabResult"]


class BiCGStabResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor      # Krylov iterations run, int32 (inner total
    #                          when refined)
    residual: torch.Tensor
    converged: torch.Tensor  # ||r|| <= threshold at exit (False on NaN)
    hit_cap: torch.Tensor    # exited at an iteration cap w/o converging
    outer_iters: torch.Tensor | int = 0  # refinement passes, int32 (0 on
    #                                      the f64 policy)


def _safe_div(num, den):
    """num/den with 0 where den == 0 (breakdown guard)."""
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def _bicgstab_buffers(b, thr: torch.Tensor) -> SimpleNamespace:
    """The BiCGStab loop's carry (``x, r, p, v, rho, alpha, omega, rr, k,
    active``), shadow residual, matvec outputs and threshold at fixed
    addresses, and the block captured over them."""
    vec = lambda: torch.empty_like(b)  # noqa: E731
    scal = lambda: torch.empty((), dtype=thr.dtype, device=b.device)  # noqa: E731
    return SimpleNamespace(
        x=vec(), r=vec(), rhat=vec(), p=vec(), v=vec(), v_new=vec(),
        t=vec(), rho=scal(), alpha=scal(), omega=scal(), rr=scal(),
        thr=scal(), graph=None,
        k=torch.empty((), dtype=torch.int32, device=b.device),
        active=torch.empty((), dtype=torch.bool, device=b.device))


def _bicgstab_body(ops: SolverOps, st: SimpleNamespace, maxiter: int):
    """One iteration over the buffers ``st``: both matvecs guarded on the
    flag it is given and every other write into the carry a select on it
    (JAX's ``keep(old, new)``), so that under a False flag the body changes
    nothing.  Made per sweep, as :func:`~repro_torch.solvers.cg._cg_body`
    is."""
    carry = (st.x, st.r, st.p, st.v, st.rho, st.alpha, st.omega, st.rr)

    def body(flag):
        x, r, p, v, rho, alpha, omega, rr = carry
        (rho_new,) = ops.dots((st.rhat, r))
        beta = _safe_div(rho_new * alpha, rho * omega)
        p_new = r + beta.to(r.dtype) * (p - omega.to(r.dtype) * v)
        phat = ops.precond(p_new)
        ops.matvec_into(phat, st.v_new, flag)
        (rv,) = ops.dots((st.rhat, st.v_new))
        alpha_new = _safe_div(rho_new, rv)
        a_lo = alpha_new.to(r.dtype)
        s = r - a_lo * st.v_new
        shat = ops.precond(s)
        ops.matvec_into(shat, st.t, flag)
        ts, tt = ops.dots((st.t, s), (st.t, st.t))
        omega_new = _safe_div(ts, tt)
        o_lo = omega_new.to(r.dtype)
        x_new = x + a_lo * phat + o_lo * shat
        r_new = s - o_lo * st.t
        (rr_new,) = ops.dots((r_new, r_new))
        # rho or <rhat, v> hitting zero is a true breakdown: the step above
        # is no longer a Krylov update — keep the previous iterate and stop
        # (the iteration that found it still counts)
        brk = (rho_new == 0) | (rv == 0)
        keep = ~flag | brk
        for old, new in zip(carry, (x_new, r_new, p_new, st.v_new, rho_new,
                                    alpha_new, omega_new, rr_new)):
            torch.where(keep, old, new, out=old)
        st.k.add_(flag.to(st.k.dtype))
        torch.logical_and(flag & ~brk, (rr > st.thr) & (st.k < maxiter),
                          out=flag)

    return body


def _bicgstab_sweep(ops: SolverOps, b, x0, thr: torch.Tensor,
                    maxiter: int):
    """One breakdown-guarded BiCGStab loop at the storage dtype, on the
    device loop (see the module doc); the bundle keeps its buffers and
    captured graph for the next sweep, as :func:`~repro_torch.solvers.cg.
    _cg_sweep` does.

    Returns ``(x, rr, k)``, copies, ``k`` 0-d int32; ``x0`` is not
    written.  The scalars (rho/alpha/omega/rr) live at the accum dtype of
    the bundle's dots and are cast down per vector use; every cast is a
    no-op on the f64 policy, which runs this once.
    """
    key = ("bicgstab", tuple(b.shape), b.dtype, thr.dtype, maxiter)
    st = ops.loops.get(key)
    if st is None:
        st = ops.loops[key] = _bicgstab_buffers(b, thr)
    st.x.copy_(x0)
    torch.sub(b, ops.matvec(x0), out=st.r)
    st.rhat.copy_(st.r)  # the shadow residual
    (rr,) = ops.dots((st.r, st.r))
    st.rr.copy_(rr)
    st.p.zero_()
    st.v.zero_()
    for s in (st.rho, st.alpha, st.omega):
        s.fill_(1)
    st.thr.copy_(thr)
    st.k.zero_()
    torch.logical_and(st.rr > st.thr, st.k < maxiter, out=st.active)
    run_loop(_bicgstab_body(ops, st, maxiter), st, "bicgstab")
    return st.x.clone(), st.rr.clone(), st.k.clone()


def _bicgstab_sweep_host(ops: SolverOps, b, x0, thr: torch.Tensor,
                         maxiter: int):
    """The former host loop of :func:`_bicgstab_sweep`: the same arithmetic,
    one host read per iteration (the carried residual and the breakdown
    test).  Returns ``(x, rr, k)`` with ``k`` a Python int.  The plain
    version the device loop is held against; no solve calls it."""
    x = x0
    r = b - ops.matvec(x0)
    rhat = r  # shadow residual
    (rr,) = ops.dots((r, r))
    one = torch.ones((), dtype=rr.dtype, device=rr.device)
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = one
    k = 0
    above = bool(rr > thr)
    brk = False
    while above and k < maxiter and not brk:
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
        above_new, rho_h, rv_h = torch.stack(
            [(rr_new > thr).to(rr_new.dtype), rho_new, rv]).tolist()
        # rho or <rhat, v> hitting zero is a true breakdown: the step above
        # is no longer a Krylov update — keep the previous iterate and stop
        brk = rho_h == 0 or rv_h == 0
        if not brk:
            x, r, p, v = x_new, r_new, p_new, v_new
            rho, alpha, omega, rr = rho_new, alpha_new, omega_new, rr_new
            above = bool(above_new)
    return x, rr, k


def _bicgstab_refined(ops: SolverOps, b, x0, *, tol, atol,
                      maxiter) -> BiCGStabResult:
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
        r_lo = r.to(lo)
        (rr_lo,) = ops.dots((r_lo, r_lo))
        d, _, k_in = _bicgstab_sweep(ops, r_lo, torch.zeros_like(r_lo),
                                     inner_threshold_sq(pol.inner_tol, rr_lo),
                                     maxiter)
        x = x + d.to(b.dtype)
        r = b - A_hi(x)
        rr = _vdot(r, r)
        k_out += 1
        inner_total = inner_total + k_in
        inner_capped = inner_capped | (k_in >= maxiter)
    converged = rr <= thr
    hit_cap = (inner_capped | (k_out >= pol.max_outer)) & ~converged
    return BiCGStabResult(x=x, iters=inner_total, residual=torch.sqrt(rr),
                          converged=converged, hit_cap=hit_cap,
                          outer_iters=torch.full((), k_out,
                                                 dtype=torch.int32,
                                                 device=b.device))


def bicgstab(A: Callable[[torch.Tensor], torch.Tensor] | SolverOps,
             b: torch.Tensor, x0: torch.Tensor, *,
             M: Callable[[torch.Tensor], torch.Tensor] | None = None,
             tol: float = 1e-8, atol: float = 0.0,
             maxiter: int = 1000) -> BiCGStabResult:
    """Solve ``A x = b`` with preconditioned BiCGStab.

    Breakdown-guarded exactly as the JAX solver: when ``rho = <rhat, r>``
    or ``<rhat, v>`` vanishes the iteration that found it still counts, the
    previous iterate is kept and the loop stops.  ``<t, t> = 0`` forces
    ``omega`` to 0 (the plain BiCG half-step, NaN-free).  On a refined
    policy convergence is tested on the true f64 residual of the outer
    loop and ``maxiter`` caps each inner sweep.
    """
    if isinstance(A, SolverOps):
        if M is not None:
            raise ValueError("pass the preconditioner inside SolverOps")
        ops = A
    else:
        ops = reference_ops(A, M)

    if ops.policy.refine:
        return _bicgstab_refined(ops, b, x0, tol=tol, atol=atol,
                                 maxiter=maxiter)

    (bb,) = ops.dots((b, b))
    thr = threshold_sq(bb, tol, atol)
    x, rr, k = _bicgstab_sweep(ops, b, x0, thr, maxiter)
    # NaN rr yields converged=False and hit_cap=False; a breakdown exit
    # before the cap reports converged=False too
    converged = rr <= thr
    return BiCGStabResult(x=x, iters=k, residual=torch.sqrt(rr),
                          converged=converged,
                          hit_cap=(k >= maxiter) & ~converged,
                          outer_iters=torch.zeros((), dtype=torch.int32,
                                                  device=b.device))
