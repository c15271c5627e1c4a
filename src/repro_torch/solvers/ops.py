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
* ``dots_hi(*pairs)``      — the refinement loop's f64 dots (None: the
  plain dot of the bundle's rows; a bundle whose rows span devices sums
  them over the devices)

and, for the device-resident loops of :mod:`repro_torch.solvers.
device_loop`, the same work into buffers the loop holds, under its guard
``active`` (a one-element bool tensor; nothing is written while it is
False):

* ``matvec_into(x, out, active)`` — ``out <- A x``
* ``matvec_dot_direction_into(p, z, beta, k, Ap, pAp, active)`` — the CG
  direction update folded into the SpMV+dot: per lane ``p' = z`` at count
  ``k == 0``, else ``z + beta p[k % 2]``, written to ``p[(k + 1) % 2]`` of
  the direction pair ``p``; ``Ap <- A p'`` and ``p'.Ap'``
* ``alpha_into(gamma, pAp, alpha, active)`` — ``pAp`` holds ``p'.Ap'``
  and ``alpha <- gamma / pAp``
* ``fused_step_into(x, r, p, Ap, alpha, z, rz, rr, active, k)`` — ``x``
  and ``r`` updated in place, ``z`` written and ``r'.z``, ``r'.r'``
  formed, lane ``l`` reading its direction from ``p[(k[l] + 1) % 2]``
  of the pair
* ``advance(gamma, gamma_new, rr, rr_new, k, active, thr, maxiter,
  beta=None)`` — ``gamma_new``, ``rr_new`` hold ``r'.z``, ``r'.r'``; the
  CG loop's carry update and condition, keeping ``beta = gamma_new /
  gamma`` for the next direction update

The reference backend's members are plain PyTorch that writes through
selects: its fold writes ``pAp``, its axpy ``rz`` and ``rr``.  The fused
backend's are the guarded kernels, one launch each (with the reductions'
scratch allocated once per bundle): its fold and axpy leave their
partials in that scratch, and the tail kernels sum them, ``cg_alpha``
into ``pAp`` in ``alpha_into`` and ``cg_advance`` into ``gamma_new`` and
``rr_new`` in ``advance`` (:mod:`repro_torch.kernels.krylov_loop`).  So
both run in one loop on every device, and the fused loop is four launches
an iteration for any number of lanes.  The fused bundle's host-loop forms
(``matvec_dot``, ``fused_step``) sum their partials in the same tree, so
the host loop is bitwise the device loop.

Backends:

* :func:`reference_ops` — plain PyTorch over any ``A``/``M`` closures.
* :func:`fused_stacked_ops` — the hand-written CUDA kernels of
  :mod:`repro_torch.kernels` on stacked DIA bands.  On CPU tensors their
  wrappers run the kernels' plain versions, which is what the CPU tests
  exercise.

Selection (:func:`resolve_backend`): ``"auto"`` is ``"fused"`` on a CUDA
device, at every part size, and ``"reference"`` on the CPU.  The JAX
package's part-size threshold (``FUSED_MIN_ROWS``) is not carried over:
on the H100 the kernels beat plain PyTorch at every part size measured,
512 to 308,700 rows (``chip_smoke.py`` phase 12d).

**Lanes.**  Both constructors take ``lanes``: ``None`` for one system (the
dots are 0-d), or ``B`` for a cohort of ``B`` systems of one shape stacked
one after another (the cohort executors of
:mod:`repro_torch.fvm.step_program`).  Then every dot is ``(B,)``, lane
``l``'s the dot of its own contiguous run (the call it makes alone), the
operators never read across a lane border, the loop members take one
``alpha``/``gamma`` and one guard flag per lane, and the kernels run the
``B`` lanes as one launch.  :func:`lanes_of` gives ``B`` (1 for one
system).  The unguarded ``matvec_dot``/``fused_step`` of the fused
backend (the host loop's forms) take one system only.

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

from repro_torch.kernels.krylov_fused.krylov_fused import lane_vdot
from repro_torch.solvers.precision import F64, PrecisionPolicy, get_policy

__all__ = ["SolverOps", "reference_ops", "fused_stacked_ops",
           "resolve_backend", "lanes_of", "BACKENDS"]

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
    matvec_dot_direction_into: Callable
    alpha_into: Callable
    fused_step_into: Callable
    advance: Callable
    backend: str = "reference"   # informational (logs)
    # the policy the members were built under and, for a refined policy,
    # the full-precision operator of the outer residual replay (None
    # falls back to ``matvec``: right for f64 only)
    policy: PrecisionPolicy = F64
    matvec_hi: Callable | None = None
    # the outer refinement loop's f64 dots ``dots_hi(*pairs)`` (None: the
    # plain dot of the bundle's own rows)
    dots_hi: Callable | None = None
    # the device loops' buffers and captured blocks, kept per sweep shape
    # for the bundle's later sweeps (solvers/cg.py, solvers/bicgstab.py)
    loops: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)
    # None: one system; B: a cohort of B lanes (module doc)
    lanes: int | None = None
    # the solvers run their host loops over this bundle: its operators
    # span several devices, which one CUDA graph cannot capture
    host_loop: bool = False
    # a bundle that keeps its rows on several devices: one host-loop
    # bundle a device over that device's rows (``ranks.ops``), which the
    # solver's loop runs over the ranks (sparse/shardmap_spmv.py
    # ShardRanks, solvers/cg.py _cg_sweep_ranks)
    ranks: object | None = None


def lanes_of(ops: SolverOps) -> int:
    """The lane count of a bundle: 1 for one system."""
    return 1 if ops.lanes is None else ops.lanes


def resolve_backend(requested: str, device: torch.device | str) -> str:
    """Concrete backend for a solve on ``device`` (see module doc)."""
    if requested not in BACKENDS:
        raise ValueError(f"unknown solver backend {requested!r}")
    if requested != "auto":
        return requested
    return "fused" if torch.device(device).type == "cuda" else "reference"


def _policy_dot(policy: PrecisionPolicy, lanes: int | None = None
                ) -> Callable:
    """Per-policy dot (per lane with ``lanes``): both operands upcast to
    the accum dtype.  The f64 policy returns the plain dot (no casts)."""
    if policy.name == "f64":
        return lambda a, b: lane_vdot(a, b, lanes)
    acc = policy.accum_dtype

    def dot(a, b):
        return lane_vdot(a.to(acc), b.to(acc), lanes)

    return dot


def _policy_dots(policy: PrecisionPolicy, lanes: int | None = None
                 ) -> Callable:
    """``dots(*pairs)``: a tuple of dots under the policy."""
    dot = _policy_dot(policy, lanes)

    def dots(*pairs):
        return tuple(dot(a, b) for a, b in pairs)

    return dots


def _plain_into(matvec: Callable, matvec_dot: Callable,
                fused_step: Callable) -> dict:
    """The loop members in plain PyTorch, over the bundle's own members:
    each result stored through a select on the guard."""
    from repro_torch.kernels.krylov_loop.krylov_loop import (
        cg_advance_plain, current_direction, next_direction_plain,
        store_direction)
    from repro_torch.kernels.spmv_dia.spmv_dia import guarded_store

    def matvec_into(x, out, active):
        guarded_store(out, matvec(x), active)

    def matvec_dot_direction_into(p, z, beta, k, Ap, pAp, active):
        new = next_direction_plain(p, z, beta, k)
        store_direction(p, new, k, active)
        for dst, val in zip((Ap, pAp), matvec_dot(new)):
            guarded_store(dst, val, active)

    def alpha_into(gamma, pAp, alpha, active):
        # scratch: the axpy reads alpha only in a lane that goes on
        torch.div(gamma, pAp, out=alpha)

    def fused_step_into(x, r, p, Ap, alpha, z, rz, rr, active, k):
        for dst, val in zip((x, r, z, rz, rr), fused_step(
                x, r, current_direction(p, k), Ap, alpha)):
            guarded_store(dst, val, active)

    return {"matvec_into": matvec_into,
            "matvec_dot_direction_into": matvec_dot_direction_into,
            "alpha_into": alpha_into, "fused_step_into": fused_step_into,
            "advance": cg_advance_plain}


def reference_ops(A: Callable, M: Callable | None = None, *,
                  policy: PrecisionPolicy | str = F64,
                  matvec_hi: Callable | None = None,
                  lanes: int | None = None) -> SolverOps:
    """Plain-PyTorch backend over operator closures (any layout).

    Under a refined ``policy`` the caller passes closures over the
    *downcast* operator (``A``/``M`` at the storage dtype) and a
    ``matvec_hi`` over the original f64 bands; the reductions then
    accumulate at the policy's accum dtype.  With ``lanes`` the closures
    must keep each lane to itself (module doc).
    """
    policy = get_policy(policy)
    M = M if M is not None else (lambda r: r)
    dot = _policy_dot(policy, lanes)

    def matvec_dot(p):
        Ap = A(p)
        return Ap, dot(p, Ap)

    def fused_step(x, r, p, Ap, alpha):
        # one alpha per lane; accum scalar -> storage (f64: no-op)
        n = alpha.numel()
        a = alpha.to(x.dtype).reshape(n, 1)
        xn = (x.reshape(n, -1) + a * p.reshape(n, -1)).view(x.shape)
        rn = (r.reshape(n, -1) - a * Ap.reshape(n, -1)).view(x.shape)
        z = M(rn)
        return xn, rn, z, dot(rn, z), dot(rn, rn)

    return SolverOps(matvec=A, precond=M, matvec_dot=matvec_dot,
                     fused_step=fused_step,
                     dots=_policy_dots(policy, lanes),
                     **_plain_into(A, matvec_dot, fused_step),
                     backend="reference", policy=policy,
                     matvec_hi=matvec_hi, lanes=lanes)


def fused_stacked_ops(bands: torch.Tensor, diag: torch.Tensor, *,
                      offsets: tuple[int, ...], plane: int,
                      policy: PrecisionPolicy | str = F64,
                      lanes: int | None = None) -> SolverOps:
    """Fused-kernel backend on stacked DIA bands ``(P, nb, m)``.

    ``diag`` is the stacked matrix diagonal (P, m); its safe Jacobi inverse
    (zero entries invert to 0) is computed once and folded into the fused
    update kernel.  Under a refined ``policy`` the bands and the diagonal
    are downcast once to the storage dtype (the inverse is taken of the
    downcast diagonal), the kernels accumulate at the accum dtype, and
    ``matvec_hi`` is the f64 SpMV kernel over the original bands.
    ``lanes``: the parts are a cohort of that many lanes (module doc).
    """
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        axpy_precond_partials, fused_matvec_dot_direction_into,
        fused_update_step_into, partials_buffers, spmv_dot_partials)
    from repro_torch.kernels.krylov_loop.krylov_loop import (cg_advance,
                                                             cg_alpha,
                                                             partials_sum)
    from repro_torch.kernels.spmv_dia.spmv_dia import spmv_dia_stacked
    from repro_torch.solvers.jacobi import safe_jacobi_inverse

    policy = get_policy(policy)
    B = 1 if lanes is None else lanes
    bands_hi = bands = bands.contiguous()
    accum = None
    if policy.name != "f64":
        bands = bands.to(policy.storage_dtype).contiguous()
        diag = diag.to(policy.storage_dtype)
        accum = policy.accum_dtype
    inv = safe_jacobi_inverse(diag).contiguous()

    def matvec(x):
        return spmv_dia_stacked(bands, x, offsets=offsets, plane=plane,
                                accum_dtype=accum, lanes=B)

    def precond(r):
        return r * inv

    def one_system():
        if lanes is not None:
            raise ValueError("the unguarded matvec_dot / fused_step take "
                             "one system; a cohort runs the loop members")

    # the host loop's forms: the partials summed in the tail kernels' tree
    def matvec_dot(p):
        one_system()
        y, dot = spmv_dot_partials(bands, p, offsets=offsets, plane=plane,
                                   accum_dtype=accum)
        return y, partials_sum(dot)

    def fused_step(x, r, p, Ap, alpha):
        one_system()
        *vecs, rz, rr = axpy_precond_partials(x, r, p, Ap, inv, alpha,
                                              accum_dtype=accum)
        return (*vecs, partials_sum(rz), partials_sum(rr))

    # the reductions' scratch of the loop members, allocated here: never
    # inside a captured graph
    part = partials_buffers(bands.shape[0] * bands.shape[2],
                            policy.accum_dtype, bands.device, lanes=B)

    def matvec_into(x, out, active):
        spmv_dia_stacked(bands, x, offsets=offsets, plane=plane,
                         accum_dtype=accum, out=out, active=active, lanes=B)

    # the loop members: the fold and the axpy leave their partials in
    # part, the tail kernels sum them (pAp, rz and rr: written by alpha_into
    # and advance)
    def matvec_dot_direction_into(p, z, beta, k, Ap, pAp, active):
        fused_matvec_dot_direction_into(bands, z, p, beta, k, Ap, part,
                                        offsets=offsets, plane=plane,
                                        accum_dtype=accum, active=active,
                                        lanes=B)

    def alpha_into(gamma, pAp, alpha, active):
        cg_alpha(part["dot"], part["npl"], part["stride"], pAp, gamma, alpha,
                 active)

    def fused_step_into(x, r, p, Ap, alpha, z, rz, rr, active, k):
        fused_update_step_into(x, r, p, Ap, inv, alpha, z, part,
                               accum_dtype=accum, active=active, lanes=B,
                               k=k)

    def advance(gamma, gamma_new, rr, rr_new, k, active, thr, maxiter,
                beta=None):
        cg_advance(gamma, gamma_new, rr, rr_new, k, active, thr, maxiter,
                   beta=beta, part=part)

    matvec_hi = None
    if policy.refine:
        def matvec_hi(x):
            return spmv_dia_stacked(bands_hi, x, offsets=offsets,
                                    plane=plane, lanes=B)

    return SolverOps(matvec=matvec, precond=precond, matvec_dot=matvec_dot,
                     fused_step=fused_step, dots=_policy_dots(policy, lanes),
                     matvec_into=matvec_into,
                     matvec_dot_direction_into=matvec_dot_direction_into,
                     alpha_into=alpha_into, fused_step_into=fused_step_into,
                     advance=advance, backend="fused", policy=policy,
                     matvec_hi=matvec_hi, lanes=lanes)
