"""Preconditioned conjugate gradients over a pluggable SolverOps backend.

Mirrors Ginkgo's CG used for the paper's pressure solves.  The body is
written against :class:`repro_torch.solvers.ops.SolverOps`, so one control
flow serves the plain-PyTorch and the fused-kernel backends.

The JAX package's ``lax.while_loop`` becomes a device-resident loop
(:mod:`repro_torch.solvers.device_loop`): the carry ``x, r, z, p, gamma,
beta, rr, k`` and a device flag ``active`` live at fixed addresses, one
iteration is ``matvec_dot_direction`` (the direction update ``p <- z +
beta p``, ``p = z`` at ``k == 0``, folded into ``(A p, p . A p)``),
``alpha_into`` (``alpha = gamma / pAp``), the in-place axpy with the
Jacobi apply and both dots, and ``advance`` (``beta <- gamma_new /
gamma``, the carry update and ``active <- rr > thr & k < maxiter``), every
write of the carry guarded on ``active``.  On the fused backend these are
four kernel launches an iteration, for one system and for any number of
lanes: the fold and the axpy write their dots' partials, and the tail
kernels ``cg_alpha`` and ``cg_advance`` sum them on the way
(:mod:`repro_torch.kernels.krylov_loop`).  On the card blocks of
iterations replay from a captured CUDA graph with one host read per
block.  The direction lives in two buffers (``p``, a
pair): other blocks read the old direction at halo offsets while the new
one is written, so iteration ``k`` reads ``p[k % 2]`` and writes ``p[(k +
1) % 2]``, chosen on the device from each lane's own ``k``.  The squared
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
and ``hit_cap`` both False).  Over a bundle whose operators span several
devices (``ops.host_loop``) the inner sweep is the host loop and the f64
dots are the bundle's ``dots_hi``, summed over the devices.  Over a
bundle that keeps its rows on several devices (``ops.ranks``, the full
mesh's) the f64 host loop runs on every device over its own rows
(:func:`_cg_sweep_ranks`).

**Lanes.**  Over a cohort bundle (``ops.lanes = B``,
:mod:`repro_torch.solvers.ops`) the same loop solves ``B`` systems at once:
the carried scalars, the count ``k`` and the flag ``active`` hold one
element per lane, a lane whose flag has dropped is frozen exactly as one
system is (its kernels return at once, its selects keep its carry), the
host read stops when no flag is set, and the results are ``(B,)`` per
lane.  The refinement loop freezes a lane whose outer loop has ended the
same way: its inner sweep starts with its flag down and its iterate is
kept.  A lane's dots are its own, so each lane computes what it computes
alone.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels.krylov_fused.krylov_fused import lane_vdot
from repro_torch.kernels.krylov_loop.krylov_loop import direction_pair
from repro_torch.solvers.device_loop import run_loop
from repro_torch.solvers.ops import SolverOps, reference_ops

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


def _cg_buffers(b, thr: torch.Tensor, lanes: int | None) -> SimpleNamespace:
    """The CG loop's carry (``x, r, z, p`` (the direction pair), ``gamma,
    beta, rr, k, active``), scratch and threshold at fixed addresses, one
    scalar per lane (0-d for one system: ``lanes`` None), and the block
    captured over them."""
    vec = lambda: torch.empty_like(b)  # noqa: E731
    shape = () if lanes is None else (lanes,)
    scal = lambda: torch.empty(shape, dtype=thr.dtype, device=b.device)  # noqa: E731
    return SimpleNamespace(
        x=vec(), r=vec(), p=direction_pair(b), Ap=vec(), z=vec(),
        gamma=scal(), beta=scal(), rr=scal(), pAp=scal(), alpha=scal(),
        gamma_new=scal(), rr_new=scal(), thr=scal(), graph=None,
        k=torch.empty(shape, dtype=torch.int32, device=b.device),
        active=torch.empty(shape, dtype=torch.bool, device=b.device))


def lane_results(ops: SolverOps, *ts):
    """Per-lane loop results as the caller takes them: 0-d for one system
    (``ops.lanes`` None), ``(B,)`` for a cohort (a host loop's Python int
    count passes as it is)."""
    if ops.lanes is None:
        return tuple(t.reshape(()) if torch.is_tensor(t) else t for t in ts)
    return ts


def lane_select(flag: torch.Tensor, new: torch.Tensor,
                old: torch.Tensor) -> torch.Tensor:
    """``new`` in the lanes whose ``flag`` is set, ``old`` elsewhere
    (``flag`` one element per lane, each lane a contiguous run)."""
    n = flag.numel()
    return torch.where(flag.reshape(n, 1), new.reshape(n, -1),
                       old.reshape(n, -1)).view(old.shape)


def _cg_body(ops: SolverOps, st: SimpleNamespace, maxiter: int):
    """One CG iteration over the buffers ``st``, every write guarded on the
    flag it is given.  (Made per sweep, not kept in ``st``: a closure kept
    there would make a reference cycle, and a bundle with its graph would
    then be freed by the cycle collector at some later moment, perhaps in
    the middle of another capture.)"""
    def body(flag):
        ops.matvec_dot_direction_into(st.p, st.z, st.beta, st.k, st.Ap,
                                      st.pAp, flag)
        ops.alpha_into(st.gamma, st.pAp, st.alpha, flag)
        ops.fused_step_into(st.x, st.r, st.p, st.Ap, st.alpha, st.z,
                            st.gamma_new, st.rr_new, flag, st.k)
        ops.advance(st.gamma, st.gamma_new, st.rr, st.rr_new, st.k, flag,
                    st.thr, maxiter, beta=st.beta)

    return body


def _cg_sweep(ops: SolverOps, b, x0, thr: torch.Tensor, maxiter: int,
              start: torch.Tensor | None = None):
    """One preconditioned-CG loop at the bundle's storage dtype, on the
    device loop (see the module doc).

    The bundle keeps the loop's buffers per (shape, dtype, maxiter), so a
    later sweep of the same bundle (the next refinement pass, the next
    velocity component) starts them anew in place and replays the graph
    already captured.  Returns ``(x, rr, k)``: the iterate, the carried
    squared residual norm (accum dtype) and the iteration count (int32),
    one per lane (``(B,)``, ``(1,)`` for one system), copies that the next
    sweep does not touch; ``x0`` is not written.  ``start`` (one flag per
    lane) keeps the lanes it clears from running at all.  The f64 policy
    runs this once; it is the plain solver.
    """
    key = ("cg", tuple(b.shape), b.dtype, thr.dtype, maxiter)
    st = ops.loops.get(key)
    if st is None:
        st = ops.loops[key] = _cg_buffers(b, thr, ops.lanes)
    st.x.copy_(x0)
    torch.sub(b, ops.matvec(x0), out=st.r)
    st.z.copy_(ops.precond(st.r))
    gamma, rr = ops.dots((st.r, st.z), (st.r, st.r))
    st.gamma.copy_(gamma)
    st.rr.copy_(rr)
    st.thr.copy_(thr)
    st.k.zero_()
    torch.logical_and(st.rr > st.thr, st.k < maxiter, out=st.active)
    if start is not None:
        st.active.logical_and_(start.reshape(st.active.shape))
    run_loop(_cg_body(ops, st, maxiter), st, "cg")
    return st.x.clone(), st.rr.clone(), st.k.clone()


def _cg_sweep_host(ops: SolverOps, b, x0, thr: torch.Tensor, maxiter: int,
                   start: torch.Tensor | None = None):
    """The former host loop of :func:`_cg_sweep`: the same arithmetic, one
    host read of the carried ``r . r`` per iteration.  Returns ``(x, rr,
    k)`` with ``k`` a Python int.  The plain version the device loop is
    held against (tests, ``chip_smoke.py``), and the loop of a bundle
    whose operators span several devices (``ops.host_loop``), the
    refinement loop's inner sweep there too.  One system only: ``start``
    must be set (the refinement loop passes it)."""
    if start is not None and not bool(start.all()):
        raise ValueError("the host loop runs one started system")
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


def _cg_sweep_ranks(rows, b, x0, thr: torch.Tensor, maxiter: int):
    """:func:`_cg_sweep_host` on every rank of ``rows`` (a bundle's
    ``ranks``, :class:`~repro_torch.sparse.shardmap_spmv.ShardRanks`), each
    over its own rows with its own bundle, one thread a rank
    (:meth:`~repro_torch.core.ranks.Ranks.run`).  Returns ``(x, rr, k)``
    with ``x`` on ``b``'s device: the ranks' dots are summed on the host,
    so every rank ends with the same ``rr`` and ``k``."""
    def work(r):
        b_r, x_r, thr_r = rows.take(r, b, x0, thr)
        x, rr, k = _cg_sweep_host(rows.ops[r], b_r, x_r, thr_r, maxiter)
        return rows.give(r, x), rr, k

    outs = rows.run(work)
    return rows.join(b, [x for x, _, _ in outs]), outs[0][1], outs[0][2]


def refine(ops: SolverOps, sweep, b, x0, *, tol, atol, maxiter):
    """The outer f64 refinement loop around low-precision inner sweeps
    (``sweep``: :func:`_cg_sweep` or BiCGStab's), per lane.

    Returns ``(x, inner_total, rr, converged, hit_cap, k_out)``, the
    scalars 0-d for one system and ``(B,)`` for a cohort.  A lane whose
    outer condition has failed is frozen: its inner sweep starts with its
    flag down and its iterate is kept (the other lanes' passes go on).
    The f64 dots are ``ops.dots_hi``'s where the bundle has them (a
    bundle whose rows span devices: every device then holds the same
    sums, so every one takes the same passes).
    """
    pol = ops.policy
    A_hi = ops.matvec_hi if ops.matvec_hi is not None else ops.matvec

    def dot(u, v):
        if ops.dots_hi is not None:
            return ops.dots_hi((u, v))[0]
        return lane_vdot(u, v, ops.lanes)

    lo = pol.storage_dtype
    thr = threshold_sq(dot(b, b), tol, atol)
    x = x0
    r = b - A_hi(x)
    rr = dot(r, r)
    k_out = torch.zeros(rr.shape, dtype=torch.int32, device=b.device)
    inner_total = torch.zeros(rr.shape, dtype=torch.int32, device=b.device)
    inner_capped = torch.zeros(rr.shape, dtype=torch.bool, device=b.device)
    going = (rr > thr) & (k_out < pol.max_outer)
    # one host read per outer pass: the outer condition
    while bool(going.any()):
        # correction solve A_lo d = r at the storage dtype, from zero, to
        # the policy's loose relative tolerance
        r_lo = r.to(lo)
        (rr_lo,) = ops.dots((r_lo, r_lo))
        d, _, k_in = sweep(ops, r_lo, torch.zeros_like(r_lo),
                           inner_threshold_sq(pol.inner_tol, rr_lo),
                           maxiter, start=going.reshape(-1))
        (k_in,) = lane_results(ops, k_in)
        k_in = torch.as_tensor(k_in, dtype=torch.int32, device=b.device)
        if ops.lanes is None:  # one system: it is going inside the loop
            x = x + d.to(b.dtype)
        else:
            x = lane_select(going, x + d.to(b.dtype), x)
            k_in = torch.where(going, k_in, 0)
        r = b - A_hi(x)   # f64 replay: low precision never touches x
        rr = dot(r, r)
        k_out = k_out + going.to(torch.int32)
        inner_total = inner_total + k_in
        inner_capped = inner_capped | (going & (k_in >= maxiter))
        going = going & (rr > thr) & (k_out < pol.max_outer)
    converged = rr <= thr
    hit_cap = (inner_capped | (k_out >= pol.max_outer)) & ~converged
    return x, inner_total, rr, converged, hit_cap, k_out


def _cg_refined(ops: SolverOps, b, x0, *, tol, atol, maxiter) -> CGResult:
    """Outer f64 refinement loop around low-precision inner sweeps."""
    sweep = _cg_sweep_host if ops.host_loop else _cg_sweep
    x, inner, rr, converged, hit_cap, k_out = refine(
        ops, sweep, b, x0, tol=tol, atol=atol, maxiter=maxiter)
    return CGResult(x=x, iters=inner, residual=torch.sqrt(rr),
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
    refines; ``maxiter`` then caps each inner sweep.  A cohort bundle
    (``ops.lanes``) solves each lane to its own tolerance and returns
    per-lane results.
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
    if ops.host_loop:
        if ops.ranks is not None:
            x, rr, k = _cg_sweep_ranks(ops.ranks, b, x0, thr, maxiter)
        else:
            x, rr, k = _cg_sweep_host(ops, b, x0, thr, maxiter)
        k = torch.tensor([k], dtype=torch.int32, device=b.device)
    else:
        x, rr, k = _cg_sweep(ops, b, x0, thr, maxiter)
    rr, k = lane_results(ops, rr, k)
    # NaN compares False on both sides: converged and hit_cap both stay
    # False, which the step's health flags read as divergence
    converged = rr <= thr
    return CGResult(x=x, iters=k, residual=torch.sqrt(rr),
                    converged=converged, hit_cap=(k >= maxiter) & ~converged,
                    outer_iters=torch.zeros(rr.shape, dtype=torch.int32,
                                            device=b.device))
