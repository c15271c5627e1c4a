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

Both backends run in the bands' dtype (float64 on the main path).  The
JAX package's mixed-precision policies (``solvers/precision.py``) need its
outer iterative-refinement loop, which is still to be ported, so the
bundle carries no policy yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

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
    backend: str = "reference"   # informational (logs)


def resolve_backend(requested: str, device: torch.device | str) -> str:
    """Concrete backend for a solve on ``device`` (see module doc)."""
    if requested not in BACKENDS:
        raise ValueError(f"unknown solver backend {requested!r}")
    if requested != "auto":
        return requested
    return "fused" if torch.device(device).type == "cuda" else "reference"


def _dots(*pairs):
    return tuple(_vdot(a, b) for a, b in pairs)


def reference_ops(A: Callable, M: Callable | None = None) -> SolverOps:
    """Plain-PyTorch backend over operator closures (any layout)."""
    M = M if M is not None else (lambda r: r)

    def matvec_dot(p):
        Ap = A(p)
        return Ap, _vdot(p, Ap)

    def fused_step(x, r, p, Ap, alpha):
        xn = x + alpha * p
        rn = r - alpha * Ap
        z = M(rn)
        return xn, rn, z, _vdot(rn, z), _vdot(rn, rn)

    return SolverOps(matvec=A, precond=M, matvec_dot=matvec_dot,
                     fused_step=fused_step, dots=_dots, backend="reference")


def fused_stacked_ops(bands: torch.Tensor, diag: torch.Tensor, *,
                      offsets: tuple[int, ...], plane: int) -> SolverOps:
    """Fused-kernel backend on stacked DIA bands ``(P, nb, m)``.

    ``diag`` is the stacked matrix diagonal (P, m); its safe Jacobi inverse
    (zero entries invert to 0) is computed once and folded into the fused
    update kernel.
    """
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        fused_matvec_dot, fused_update_step)
    from repro_torch.kernels.spmv_dia.spmv_dia import spmv_dia_stacked
    from repro_torch.solvers.jacobi import safe_jacobi_inverse

    bands = bands.contiguous()
    inv = safe_jacobi_inverse(diag).contiguous()

    def matvec(x):
        return spmv_dia_stacked(bands, x, offsets=offsets, plane=plane)

    def precond(r):
        return r * inv

    def matvec_dot(p):
        return fused_matvec_dot(bands, p, offsets=offsets, plane=plane)

    def fused_step(x, r, p, Ap, alpha):
        return fused_update_step(x, r, p, Ap, inv, alpha)

    return SolverOps(matvec=matvec, precond=precond, matvec_dot=matvec_dot,
                     fused_step=fused_step, dots=_dots, backend="fused")
