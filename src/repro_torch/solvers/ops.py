"""Pluggable per-iteration operation backends for the Krylov solvers.

One solver body (``cg``/``bicgstab``) runs over a :class:`SolverOps`
bundle, so the plain-PyTorch and the fused-kernel implementations share
the same control flow and the same convergence decisions:

* ``matvec(x)``            — ``A x`` (operator apply, halo exchange inside)
* ``precond(r)``           — ``M^-1 r`` (Jacobi here)
* ``matvec_dot(p)``        — ``(A p, p . A p)``; the fused backend computes
  the dot's block partials in the same pass as the SpMV
* ``fused_step(x, r, p, Ap, alpha)`` — ``(x', r', z, r'.z, r'.r')``: the
  axpy pair, the preconditioner apply and both reductions of the second
  half of a CG iteration
* ``dots(*pairs)``         — a tuple of global dots (initial residual,
  BiCGStab's rho/rv/ts/tt)

and, for the device-resident loops of :mod:`repro_torch.solvers.
device_loop`, the same work into buffers the loop holds, under its guard
``active`` (a one-element bool tensor; nothing is written while it is
False):

* ``matvec_into(x, out, active)`` — ``out <- A x``
* ``matvec_dot_into(p, Ap, pAp, active)`` — ``Ap <- A p``, ``pAp <- p.Ap``
* ``fused_step_into(x, r, p, Ap, alpha, z, rz, rr, active)`` — ``x`` and
  ``r`` updated in place, ``z``, ``rz = r'.z``, ``rr = r'.r'`` written
* ``direction(p, z, gamma_new, gamma, active)`` — ``p <- z + beta p`` in
  place, ``beta = gamma_new / gamma`` on the device
* ``advance(gamma, gamma_new, rr, rr_new, k, active, thr, maxiter)`` — the
  CG loop's carry update and condition

The fused backend's members are the guarded kernels (with the reductions'
scratch allocated once per bundle); the reference backend's are plain
PyTorch that writes through selects, so both run in one loop on every
device.

Backends:

* :func:`reference_ops` — plain PyTorch over any ``A``/``M`` closures.
* :func:`fused_stacked_ops` — the hand-written CUDA kernels of
  :mod:`repro_torch.kernels` on stacked DIA bands.  On CPU tensors their
  wrappers run the kernels' plain versions, which is what the CPU tests
  exercise.

Selection (:func:`resolve_backend`): ``"auto"`` is ``"fused"`` on a CUDA
device and ``"reference"`` on the CPU, for every part size so far — the
part-size crossover below which the reference path would win is still to
be measured on the card.

**Precision.**  Both constructors take a
:class:`~repro_torch.solvers.precision.PrecisionPolicy`.  Under the
default ``f64`` policy every cast below is a no-op and the op sequence is
the plain f64 solver's.  Under a refined policy (``f32_ir`` /
``bf16_ir``) the members run the *inner* sweep at the storage dtype with
accum-dtype reductions, and the bundle carries ``matvec_hi``, the
operator over the original f64 bands, for the outer residual replay
``r = b - A x`` of the solvers' iterative-refinement loop.  In the fused
backend that replay is the f64 ``spmv_dia_stacked`` kernel on a CUDA
tensor (its plain version on the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.solvers.precision import F64, PrecisionPolicy, get_policy

__all__ = ["SolverOps", "reference_ops", "fused_stacked_ops",
           "resolve_backend", "BACKENDS"]

BACKENDS = ("auto", "fused", "reference")


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


@dataclasses.dataclass(frozen=True)
class SolverOps:
    """The per-iteration operation bundle consumed by ``cg``/``bicgstab``."""

    matvec: Callable
    precond: Callable
    matvec_dot: Callable
    fused_step: Callable
    dots: Callable
    matvec_into: Callable
    matvec_dot_into: Callable
    fused_step_into: Callable
    direction: Callable
    advance: Callable
    backend: str = "reference"   # informational (logs)
    # the policy the members were built under and, for a refined policy,
    # the full-precision operator of the outer residual replay (None
    # falls back to ``matvec``: right for f64 only)
    policy: PrecisionPolicy = F64
    matvec_hi: Callable | None = None
    # the device loops' buffers and captured blocks, kept per sweep shape
    # for the bundle's later sweeps (solvers/cg.py, solvers/bicgstab.py)
    loops: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)


def resolve_backend(requested: str, device: torch.device | str) -> str:
    """Concrete backend for a solve on ``device`` (see module doc)."""
    if requested not in BACKENDS:
        raise ValueError(f"unknown solver backend {requested!r}")
    if requested != "auto":
        return requested
    return "fused" if torch.device(device).type == "cuda" else "reference"


def _policy_dot(policy: PrecisionPolicy) -> Callable:
    """Per-policy global dot: both operands upcast to the accum dtype.

    The f64 policy returns the plain dot (no casts at all)."""
    if policy.name == "f64":
        return _vdot
    acc = policy.accum_dtype

    def dot(a, b):
        return _vdot(a.to(acc), b.to(acc))

    return dot


def _policy_dots(policy: PrecisionPolicy) -> Callable:
    """``dots(*pairs)``: a tuple of global dots under the policy."""
    dot = _policy_dot(policy)

    def dots(*pairs):
        return tuple(dot(a, b) for a, b in pairs)

    return dots


def _plain_into(matvec: Callable, matvec_dot: Callable,
                fused_step: Callable) -> dict:
    """The loop members in plain PyTorch, over the bundle's own members:
    each result stored through a select on the guard."""
    from repro_torch.kernels.krylov_loop.krylov_loop import (
        cg_advance_plain, cg_direction_plain)
    from repro_torch.kernels.spmv_dia.spmv_dia import guarded_store

    def matvec_into(x, out, active):
        guarded_store(out, matvec(x), active)

    def matvec_dot_into(p, Ap, pAp, active):
        for dst, val in zip((Ap, pAp), matvec_dot(p)):
            guarded_store(dst, val, active)

    def fused_step_into(x, r, p, Ap, alpha, z, rz, rr, active):
        for dst, val in zip((x, r, z, rz, rr),
                            fused_step(x, r, p, Ap, alpha)):
            guarded_store(dst, val, active)

    return {"matvec_into": matvec_into, "matvec_dot_into": matvec_dot_into,
            "fused_step_into": fused_step_into,
            "direction": cg_direction_plain, "advance": cg_advance_plain}


def reference_ops(A: Callable, M: Callable | None = None, *,
                  policy: PrecisionPolicy | str = F64,
                  matvec_hi: Callable | None = None) -> SolverOps:
    """Plain-PyTorch backend over operator closures (any layout).

    Under a refined ``policy`` the caller passes closures over the
    *downcast* operator (``A``/``M`` at the storage dtype) and a
    ``matvec_hi`` over the original f64 bands; the reductions then
    accumulate at the policy's accum dtype.
    """
    policy = get_policy(policy)
    M = M if M is not None else (lambda r: r)
    dot = _policy_dot(policy)

    def matvec_dot(p):
        Ap = A(p)
        return Ap, dot(p, Ap)

    def fused_step(x, r, p, Ap, alpha):
        a = alpha.to(x.dtype)  # accum scalar -> storage (f64: no-op)
        xn = x + a * p
        rn = r - a * Ap
        z = M(rn)
        return xn, rn, z, dot(rn, z), dot(rn, rn)

    return SolverOps(matvec=A, precond=M, matvec_dot=matvec_dot,
                     fused_step=fused_step, dots=_policy_dots(policy),
                     **_plain_into(A, matvec_dot, fused_step),
                     backend="reference", policy=policy,
                     matvec_hi=matvec_hi)


def fused_stacked_ops(bands: torch.Tensor, diag: torch.Tensor, *,
                      offsets: tuple[int, ...], plane: int,
                      policy: PrecisionPolicy | str = F64) -> SolverOps:
    """Fused-kernel backend on stacked DIA bands ``(P, nb, m)``.

    ``diag`` is the stacked matrix diagonal (P, m); its safe Jacobi inverse
    (zero entries invert to 0) is computed once and folded into the fused
    update kernel.  Under a refined ``policy`` the bands and the diagonal
    are downcast once to the storage dtype (the inverse is taken of the
    downcast diagonal), the kernels accumulate at the accum dtype, and
    ``matvec_hi`` is the f64 SpMV kernel over the original bands.
    """
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        fused_matvec_dot, fused_matvec_dot_into, fused_update_step,
        fused_update_step_into, partials_buffers)
    from repro_torch.kernels.krylov_loop.krylov_loop import (cg_advance,
                                                             cg_direction)
    from repro_torch.kernels.spmv_dia.spmv_dia import spmv_dia_stacked
    from repro_torch.solvers.jacobi import safe_jacobi_inverse

    policy = get_policy(policy)
    bands_hi = bands = bands.contiguous()
    accum = None
    if policy.name != "f64":
        bands = bands.to(policy.storage_dtype).contiguous()
        diag = diag.to(policy.storage_dtype)
        accum = policy.accum_dtype
    inv = safe_jacobi_inverse(diag).contiguous()

    def matvec(x):
        return spmv_dia_stacked(bands, x, offsets=offsets, plane=plane,
                                accum_dtype=accum)

    def precond(r):
        return r * inv

    def matvec_dot(p):
        return fused_matvec_dot(bands, p, offsets=offsets, plane=plane,
                                accum_dtype=accum)

    def fused_step(x, r, p, Ap, alpha):
        return fused_update_step(x, r, p, Ap, inv, alpha, accum_dtype=accum)

    # the reductions' scratch of the loop members, allocated here: never
    # inside a captured graph
    part = partials_buffers(bands.shape[0] * bands.shape[2],
                            policy.accum_dtype, bands.device)

    def matvec_into(x, out, active):
        spmv_dia_stacked(bands, x, offsets=offsets, plane=plane,
                         accum_dtype=accum, out=out, active=active)

    def matvec_dot_into(p, Ap, pAp, active):
        fused_matvec_dot_into(bands, p, Ap, pAp, part, offsets=offsets,
                              plane=plane, accum_dtype=accum, active=active)

    def fused_step_into(x, r, p, Ap, alpha, z, rz, rr, active):
        fused_update_step_into(x, r, p, Ap, inv, alpha, z, rz, rr, part,
                               accum_dtype=accum, active=active)

    matvec_hi = None
    if policy.refine:
        def matvec_hi(x):
            return spmv_dia_stacked(bands_hi, x, offsets=offsets,
                                    plane=plane)

    return SolverOps(matvec=matvec, precond=precond, matvec_dot=matvec_dot,
                     fused_step=fused_step, dots=_policy_dots(policy),
                     matvec_into=matvec_into,
                     matvec_dot_into=matvec_dot_into,
                     fused_step_into=fused_step_into, direction=cg_direction,
                     advance=cg_advance, backend="fused", policy=policy,
                     matvec_hi=matvec_hi)
