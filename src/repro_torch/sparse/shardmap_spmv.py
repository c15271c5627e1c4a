"""Row-sharded DIA SpMV and the full-mesh solver bundle.

The port's counterpart of the JAX package's
``src/repro/sparse/shardmap_spmv.py``, for ``solve_mode="full_mesh"``: the
fused pressure system's ``n_coarse`` parts are cut into ``n_coarse *
alpha`` row shards of ``m_loc = m_coarse / alpha`` rows
(:mod:`repro_torch.core.comm`), each shard swapping one ``plane`` of halo
with its linear neighbours, across coarse-part borders too; the first
shard's lower and the last shard's upper halo are zero.

The per-shard apply is split as JAX splits it so the exchange can overlap
the compute:

1. the halo planes are taken (on one device, slices of the neighbouring
   shards; across devices, plane copies issued first, non-blocking);
2. every row against the shard's own rows with zero halos: the shards on
   one device are the lanes of **one** launch of the DIA SpMV kernel
   (:func:`~repro_torch.kernels.spmv_dia.spmv_dia_stacked`, ``lanes =``
   shards; a lane border zeroes the halo, which is exactly the local apply
   on the zero-extended local vector);
3. the band terms that reach a halo are added to the shard's first and
   last rows, in plain PyTorch as they are ``jnp`` in JAX: for a band of
   offset ``o < 0`` the rows ``[0, -o)``, for ``o > 0`` the rows ``[m_loc -
   o, m_loc)``, the widest band first and the others in band order.

:func:`make_spmv_full_mesh` is that apply, with (``with_dot``) the dot
``x . A x`` as per-shard dots taken after the boundary add and summed in
shard order (:func:`shard_sum`, on the first shard's device).
:func:`make_jacobi_full_mesh` and :func:`make_fused_step_full_mesh` are the
shard-local Jacobi apply and axpy/precondition/dots step, the latter with
its ``r . z`` and ``r . r`` per shard summed in shard order.

:func:`make_fused_ops_full_mesh` is the fused
:class:`~repro_torch.solvers.ops.SolverOps` bundle on one device, with
the device loop's guarded members.  Its CG iteration keeps the stacked
loop's structure: the direction update ``p' = z + beta p`` folded into
the SpMV+dot kernel (``spmv_dot_direction``, one lane a shard, over the
loop's pair of direction buffers), the boundary add from ``p'``'s planes,
the axpy kernel in place (one lane a shard), ``cg_alpha`` and
``cg_advance``.  Its ``p' . A p'`` is each lane's partials of ``p' .
A_local p'`` (written by the same kernel) plus the boundary rows' ``p' .
(A p' - A_local p')``, per shard, summed in shard order: the per-shard
dot after the boundary add, without another pass over ``p'`` and ``A
p'``.  The bundle keeps those sums (and the axpy's, each shard's partials
then the shards in order), each in a run of one partial, whose sum is the
value itself: ``cg_alpha`` takes ``p' . A p'`` so, ``cg_advance`` ``r'.z``
and ``r'.r'``.  The host loop's form
(``matvec_dot``) computes the same values through the unfused SpMV+dot
kernel, so the device loop stays bitwise the host loop.  The lane kernels
take one flag, ``beta``, ``k`` and ``alpha`` per lane; the bundle fills
its ``(n_shards,)`` buffers of them from the loop's one value before each
launch.

A mesh over several distinct devices runs :func:`make_spmv_full_mesh`
(each device's shards one launch, halo planes copied between devices) and
the reference backend's host loop; a CUDA graph cannot capture it, and
the fused bundle takes one device only.  Neither branch has run on more
than one card.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.comm import ShardMesh, to_shards

__all__ = ["make_spmv_full_mesh", "make_jacobi_full_mesh",
           "make_fused_step_full_mesh", "make_fused_ops_full_mesh",
           "shard_sum", "shard_dots", "shard_bands", "halo_bands",
           "check_full_mesh"]


def check_full_mesh(mesh: ShardMesh, *, offsets, plane: int, n_coarse: int,
                    alpha: int, m_coarse: int) -> tuple[int, int]:
    """``(n_shards, m_loc)``; raises unless the mesh and the system fit
    (one halo plane a side: ``m_loc >= plane``)."""
    if tuple(mesh.shape) != (n_coarse, alpha):
        raise ValueError(f"mesh shape {tuple(mesh.shape)} is not "
                         f"({n_coarse}, {alpha})")
    if m_coarse % alpha:
        raise ValueError(f"{m_coarse} rows do not split into {alpha} shards")
    m_loc = m_coarse // alpha
    if m_loc < plane:
        raise ValueError(f"a shard of {m_loc} rows holds less than one halo "
                         f"plane of {plane}")
    if any(abs(int(o)) > plane for o in offsets):
        raise ValueError(f"offsets {offsets} reach beyond the halo {plane}")
    return n_coarse * alpha, m_loc


def halo_bands(offsets) -> tuple[list, list]:
    """The bands whose terms reach a halo, as ``(band, width)`` per side
    (``o < 0``: width ``-o``; ``o > 0``: width ``o``), the widest first and
    the others in band order."""
    def side(pairs):
        if not pairs:
            return []
        wide = max(range(len(pairs)), key=lambda i: pairs[i][1])
        return [pairs[wide]] + pairs[:wide] + pairs[wide + 1:]

    offs = [int(o) for o in offsets]
    return (side([(d, -o) for d, o in enumerate(offs) if o < 0]),
            side([(d, o) for d, o in enumerate(offs) if o > 0]))


def shard_sum(parts: torch.Tensor, out: torch.Tensor | None = None):
    """The shards' partials ``(n_shards,)`` summed in shard order (one
    ``torch.sum``: a fixed order), 0-d."""
    return torch.sum(parts, dim=0, out=out)


def shard_dots(a: torch.Tensor, b: torch.Tensor, n_shards: int,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """``a . b`` as the per-shard dots summed in shard order."""
    per = (a.reshape(n_shards, -1) * b.reshape(n_shards, -1)).sum(1)
    return shard_sum(per, out)


def _halo_terms(b_sh: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                down: list, up: list, m: int, plane: int):
    """``(dc, uc)``: the halo terms of the rows ``[0, wd)`` of shards 1..S-1
    (from the last planes ``hi`` of shards 0..S-2) and of the rows ``[m -
    wu, m)`` of shards 0..S-2 (from the first planes ``lo`` of shards
    1..S-1); ``lo``, ``hi``: ``(S, plane)``.  None for a side no band
    reaches."""
    dc = uc = None
    for d, w in down:
        t = (b_sh[1:, d, :w], hi[:-1, plane - w:])
        if dc is None:
            dc = t[0] * t[1]
        else:
            dc[:, :w].addcmul_(*t)
    for d, w in up:
        t = (b_sh[:-1, d, m - w:], lo[1:, :w])
        if uc is None:
            uc = t[0] * t[1]
        else:
            uc[:, uc.shape[1] - w:].addcmul_(*t)
    return dc, uc


def _add_halo(y: torch.Tensor, dc, uc, m: int,
              active: torch.Tensor | None = None) -> None:
    """``y[1:, :wd] += dc`` and ``y[:-1, m - wu:] += uc`` in place (``y``
    ``(S, m)``); under the loop guard ``active`` through selects, so nothing
    changes while it is False."""
    for win, t in ((None if dc is None else y[1:, :dc.shape[1]], dc),
                   (None if uc is None else y[:-1, m - uc.shape[1]:], uc)):
        if t is None:
            continue
        if active is None:
            win.add_(t)
        else:
            torch.where(active, win + t, win, out=win)


def _boundary_dots(lo, hi, dc, uc, m: int, plane: int,
                   per: torch.Tensor) -> None:
    """Add each boundary row's ``x . (A x - A_local x)`` to its shard's
    partial in ``per`` ``(S,)``: ``lo``/``hi`` the shards' first and last
    planes of ``x``, ``dc``/``uc`` of :func:`_halo_terms`."""
    if dc is not None:
        per[1:] += (lo[1:, :dc.shape[1]] * dc).sum(1)
    if uc is not None:
        per[:-1] += (hi[:-1, plane - uc.shape[1]:] * uc).sum(1)


def _local_apply(b_sh, x_sh, offsets, plane, use_kernel, out=None,
                 active=None):
    """Every row of every shard against the shard's own rows (zero halos):
    the shards as lanes of one launch (``use_kernel`` None or True: the
    kernel's wrapper, which takes its plain version for CPU tensors), or
    the plain shift loop (False)."""
    from repro_torch.kernels.spmv_dia.spmv_dia import (guarded_store,
                                                       spmv_dia_stacked)
    from repro_torch.sparse.distributed import spmv_dia

    S = b_sh.shape[0]
    if use_kernel is False:
        return guarded_store(out, spmv_dia(b_sh, x_sh, offsets=offsets,
                                           plane=plane, lanes=S), active)
    return spmv_dia_stacked(b_sh, x_sh, offsets=offsets, plane=plane,
                            out=out, active=active, lanes=S)


def make_spmv_full_mesh(mesh: ShardMesh, *, offsets: tuple[int, ...],
                        plane: int, n_coarse: int, alpha: int, m_coarse: int,
                        with_dot: bool = False,
                        use_kernel: bool | None = None) -> Callable:
    """``A(bands_sh, x)`` with rows sharded over ``(solve, assemble)``.

    ``bands_sh``: the bands in the shard layout (``to_shards(bands,
    alpha)``, ``(n_shards, nb, m_loc)``; a list of per-device blocks for a
    mesh of several devices, :func:`shard_bands`); ``x``: the stacked
    ``(n_c, m_c)`` vector (or ``(n_shards, m_loc)``) on the first shard's
    device.  Returns ``A x`` shaped as ``x``, and with ``with_dot`` also
    ``x . A x`` (per-shard dots after the boundary add, summed in shard
    order).  ``use_kernel``: None or True, the DIA SpMV kernel for the
    local apply (its plain version for CPU tensors); False, the plain
    shift loop.
    """
    S, m = check_full_mesh(mesh, offsets=offsets, plane=plane,
                           n_coarse=n_coarse, alpha=alpha, m_coarse=m_coarse)
    down, up = halo_bands(offsets)
    groups = mesh.groups()

    def one(b_sh, x_sh):
        y = _local_apply(b_sh, x_sh, offsets, plane, use_kernel)
        dc, uc = _halo_terms(b_sh, x_sh[:, :plane], x_sh[:, m - plane:],
                             down, up, m, plane)
        _add_halo(y, dc, uc, m)
        return y

    def several(blocks, x_sh):
        # the halo planes first, each copied (non-blocking) to the device
        # of the shard that reads it, with each device's own rows
        moved = []
        for dev, s0, s1 in groups:
            below = (x_sh[s0 - 1, m - plane:].to(dev, non_blocking=True)
                     if s0 > 0 else None)
            above = (x_sh[s1, :plane].to(dev, non_blocking=True)
                     if s1 < S else None)
            moved.append((x_sh[s0:s1].to(dev, non_blocking=True), below,
                          above))
        y = torch.empty_like(x_sh)
        for (dev, s0, s1), b_ext, (xg, below, above) in zip(groups, blocks,
                                                            moved):
            # the block's shards between a zero-band shard for each
            # neighbour, which holds only the plane it lends
            f = 0 if below is None else 1
            n = s1 - s0
            y_ext = torch.zeros((n + f + (above is not None), m),
                                dtype=xg.dtype, device=dev)
            y_ext[f:f + n] = _local_apply(b_ext[f:f + n], xg, offsets, plane,
                                          use_kernel)
            zero = torch.zeros((1, plane), dtype=xg.dtype, device=dev)
            lo = [xg[:, :plane]]
            hi = [xg[:, m - plane:]]
            if below is not None:
                lo, hi = [zero] + lo, [below[None]] + hi
            if above is not None:
                lo, hi = lo + [above[None]], hi + [zero]
            dc, uc = _halo_terms(b_ext, torch.cat(lo), torch.cat(hi), down,
                                 up, m, plane)
            _add_halo(y_ext, dc, uc, m)
            y[s0:s1].copy_(y_ext[f:f + n], non_blocking=True)
        return y

    def spmv(bands_sh, x):
        x_sh = x.reshape(S, m)
        y = (one(bands_sh, x_sh) if len(groups) == 1
             else several(bands_sh, x_sh))
        if not with_dot:
            return y.view(x.shape)
        return y.view(x.shape), shard_dots(x_sh, y, S)

    return spmv


def shard_bands(mesh: ShardMesh, bands: torch.Tensor, alpha: int):
    """The stacked bands ``(n_c, nb, m_c)`` in the shard layout that
    :func:`make_spmv_full_mesh` takes: one tensor when every shard is on
    the bands' device, else one block per device
    (:meth:`~repro_torch.core.comm.ShardMesh.groups`), copied there, with a
    zero-band shard before it (after it) when it has a lower (upper)
    neighbour."""
    b_sh = to_shards(bands, alpha)
    groups = mesh.groups()
    if len(groups) == 1 and groups[0][0] == bands.device:
        return b_sh
    S = b_sh.shape[0]
    zero = torch.zeros_like(b_sh[:1])
    return [torch.cat([zero] * (s0 > 0) + [b_sh[s0:s1]] + [zero] * (s1 < S))
            .to(dev) for dev, s0, s1 in groups]


def make_jacobi_full_mesh(mesh: ShardMesh, diag: torch.Tensor) -> Callable:
    """The Jacobi apply ``M(r) = r / diag`` on the shard layout: ``diag``
    the stacked ``(n_c, m_c)`` diagonal.  Shard-local (no halo)."""
    def apply(r):
        return r / diag.reshape(r.shape)

    return apply


def _axpy_lanes(x, r, p, Ap, inv, alpha_s, z, part, S, *, active=None,
                k=None):
    """The axpy kernel in place on ``x`` and ``r``, one lane a shard
    (``alpha_s`` one value a shard), then each shard's ``r'.z`` and
    ``r'.r'`` from its partials: ``(rz, rr)``, ``(S,)`` each."""
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        axpy_precond_inplace)

    axpy_precond_inplace(x, r, p, Ap, inv, alpha_s, z, part["rz"],
                         part["rr"], active=active, lanes=S, k=k)
    return tuple(_lane_part_sums(part[key], part) for key in ("rz", "rr"))


def _lane_part_sums(buf: torch.Tensor, part: dict,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Each lane's partials summed: ``(S,)``."""
    npl, stride = part["npl"], part["stride"]
    return torch.sum(buf.view(-1, stride)[:, :npl], dim=1, out=out)


def make_fused_step_full_mesh(mesh: ShardMesh,
                              diag: torch.Tensor) -> Callable:
    """``step(x, r, p, Ap, alpha) -> (x', r', z, r'.z, r'.r')``: the axpy
    pair, the Jacobi apply (by the diagonal's safe inverse) and the dots as
    per-shard partials summed in shard order; the axpy kernel, one lane a
    shard (its plain version for CPU tensors).  ``x`` and ``r`` are not
    written."""
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        partials_buffers)
    from repro_torch.solvers.jacobi import safe_jacobi_inverse

    S = mesh.n_shards
    inv = safe_jacobi_inverse(diag).contiguous()

    def step(x, r, p, Ap, a):
        part = partials_buffers(x.numel(), x.dtype, x.device, lanes=S)
        xn, rn, z = x.clone(), r.clone(), torch.empty_like(x)
        rz, rr = _axpy_lanes(xn, rn, p, Ap, inv,
                             a.reshape(1).expand(S).contiguous(), z, part, S)
        return xn, rn, z, shard_sum(rz), shard_sum(rr)

    return step


def make_fused_ops_full_mesh(mesh: ShardMesh, bands: torch.Tensor,
                             diag: torch.Tensor, *, offsets: tuple[int, ...],
                             plane: int, n_coarse: int, alpha: int,
                             m_coarse: int):
    """The full-mesh fused :class:`~repro_torch.solvers.ops.SolverOps`
    bundle (module doc) over the stacked bands ``(n_c, nb, m_c)`` and
    diagonal ``(n_c, m_c)``, all shards on the bands' device.  f64 only, as
    in JAX; one system (no cohort lanes)."""
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        partials_buffers, spmv_dot_direction, spmv_dot_partials)
    from repro_torch.kernels.krylov_loop.krylov_loop import (cg_advance,
                                                             cg_alpha)
    from repro_torch.solvers.jacobi import safe_jacobi_inverse
    from repro_torch.solvers.ops import SolverOps

    S, m = check_full_mesh(mesh, offsets=offsets, plane=plane,
                           n_coarse=n_coarse, alpha=alpha, m_coarse=m_coarse)
    dev = bands.device
    if mesh.one_device != dev:
        raise NotImplementedError(
            f"the fused full-mesh bundle takes every shard on the bands' "
            f"device {dev}; mesh devices {sorted(set(map(str, mesh.flat())))}"
            f" (a mesh of several devices: solver_backend='reference')")
    if bands.dtype != torch.float64:
        raise ValueError("the full-mesh solve is f64 only")
    down, up = halo_bands(offsets)
    b_sh = to_shards(bands.contiguous(), alpha)
    inv = safe_jacobi_inverse(diag).contiguous()
    plain = make_spmv_full_mesh(mesh, offsets=offsets, plane=plane,
                                n_coarse=n_coarse, alpha=alpha,
                                m_coarse=m_coarse)
    step = make_fused_step_full_mesh(mesh, diag)
    dtype = bands.dtype
    # the loop members' scratch, allocated here (never inside a capture):
    # the lane kernels' partials, and one flag, k, beta and alpha a shard
    part = partials_buffers(S * m, dtype, dev, lanes=S)
    flags = torch.empty(S, dtype=torch.bool, device=dev)
    ks = torch.empty(S, dtype=torch.int32, device=dev)
    betas = torch.empty(S, dtype=dtype, device=dev)
    alphas = torch.empty(S, dtype=dtype, device=dev)
    per = torch.empty(S, dtype=dtype, device=dev)
    # p'.Ap', r'.z and r'.r', each the tail kernels' run of one partial
    pap_sum, rz_sum, rr_sum = (torch.empty(1, dtype=dtype, device=dev)
                               for _ in range(3))
    tail_part = {"rz": rz_sum, "rr": rr_sum, "npl": 1, "stride": 1}
    kw = dict(offsets=offsets, plane=plane)

    def vec(t):
        return t.reshape(S, m)

    def dot_after_halo(dot_part, lo, hi, dc, uc, out=None):
        """``p' . A p'``: each lane's partials ``dot_part`` of ``p' .
        A_local p'`` plus its boundary rows, summed in shard order."""
        _lane_part_sums(dot_part, part, out=per)
        _boundary_dots(lo, hi, dc, uc, m, plane, per)
        return shard_sum(per, out)

    def matvec(x):
        return plain(b_sh, x)

    def precond(r):
        return r * inv

    def matvec_dot(p):
        y, dot_part = spmv_dot_partials(b_sh, vec(p), lanes=S, **kw)
        p_sh = vec(p)
        lo, hi = p_sh[:, :plane], p_sh[:, m - plane:]
        dc, uc = _halo_terms(b_sh, lo, hi, down, up, m, plane)
        _add_halo(y, dc, uc, m)
        return y.view(p.shape), dot_after_halo(dot_part, lo, hi, dc, uc)

    def dots(*pairs):
        return tuple(shard_dots(a, b, S) for a, b in pairs)

    def matvec_into(x, out, active):
        flags.copy_(active.reshape(1).expand(S))
        y = vec(out)
        _local_apply(b_sh, vec(x), offsets, plane, None, out=y,
                     active=flags)
        x_sh = vec(x)
        dc, uc = _halo_terms(b_sh, x_sh[:, :plane], x_sh[:, m - plane:],
                             down, up, m, plane)
        _add_halo(y, dc, uc, m, active)

    def matvec_dot_direction_into(p, z, beta, k, Ap, pAp, active):
        flags.copy_(active.reshape(1).expand(S))
        ks.copy_(k.reshape(1).expand(S))
        betas.copy_(beta.reshape(1).expand(S))
        y = vec(Ap)
        spmv_dot_direction(b_sh, vec(z), p.view(2, S, m), betas, ks,
                           out=(y, part["dot"]), active=flags, lanes=S, **kw)
        # p' is in buffer (k + 1) % 2: its first and last planes
        odd = torch.remainder(k, 2) == 1
        pair = p.view(2, S, m)
        lo = torch.where(odd, pair[0, :, :plane], pair[1, :, :plane])
        hi = torch.where(odd, pair[0, :, m - plane:], pair[1, :, m - plane:])
        dc, uc = _halo_terms(b_sh, lo, hi, down, up, m, plane)
        _add_halo(y, dc, uc, m, active)
        dot_after_halo(part["dot"], lo, hi, dc, uc, out=pap_sum.view(()))

    def alpha_into(gamma, pAp, a, active):
        cg_alpha(pap_sum, 1, 1, pAp, gamma, a, active)

    def fused_step_into(x, r, p, Ap, a, z, rz, rr, active, k):
        flags.copy_(active.reshape(1).expand(S))
        ks.copy_(k.reshape(1).expand(S))
        alphas.copy_(a.reshape(1).expand(S))
        rz_s, rr_s = _axpy_lanes(x, r, p, Ap, inv, alphas, z, part, S,
                                 active=flags, k=ks)
        shard_sum(rz_s, out=rz_sum.view(()))
        shard_sum(rr_s, out=rr_sum.view(()))

    def advance(gamma, gamma_new, rr, rr_new, k, active, thr, maxiter,
                beta=None):
        cg_advance(gamma, gamma_new, rr, rr_new, k, active, thr, maxiter,
                   beta=beta, part=tail_part)

    return SolverOps(matvec=matvec, precond=precond, matvec_dot=matvec_dot,
                     fused_step=step, dots=dots, matvec_into=matvec_into,
                     matvec_dot_direction_into=matvec_dot_direction_into,
                     alpha_into=alpha_into, fused_step_into=fused_step_into,
                     advance=advance, backend="fused")
