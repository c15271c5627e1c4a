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

1. the halo planes are taken (slices of the neighbouring shards);
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
``x . A x`` as each shard's partials of ``x . A_local x`` (the SpMV+dot
kernel's) plus its boundary rows' terms, summed in shard order
(:func:`shard_sum`); over several devices it runs the ranks' product
(below), bit for bit the one-device operator on the CPU.
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

A mesh whose shards sit on several distinct devices takes
:func:`make_rank_ops_full_mesh`'s bundle (the fused one's, and the
reference backend's with the kernels' plain versions): one *rank* a
distinct device (:class:`ShardRanks`, a thread a device as in
:mod:`repro_torch.fvm.distinct`, rank 0 the first shard's), a device
holding several runs of shards one rank.  Each rank holds its shards'
rows of ``x``, ``r``, ``p``, ``z`` and ``A p``, their bands and safe
Jacobi inverse for the whole solve, copied from rank 0 once, and runs the
CG host loop over them; a CUDA graph cannot capture a loop across
devices, so the device loop's members refuse.  A product first copies
the one plane each way at every boundary between shards on two devices
(move kind ``solve_halo``), then runs the rank's shards as the lanes of
one launch of the SpMV+dot kernel (its plain version on a CPU rank), then
the halo terms as above, from the neighbour planes (a zero plane past
the first and the last shard).  The axpy runs in place, one lane a
shard.  Every dot hands the rank's per-shard values to the host, which
puts them in shard order and sums them there with :func:`shard_sum`: on
the CPU the bundle is bit for bit the one-device bundle's host loop.
:func:`~repro_torch.solvers.cg.cg` runs that loop over the ranks: the
bundle's ``ranks`` hands each rank its rows and bundle, and takes the
solution rows back.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.core.comm import ShardMesh, from_shards, to_shards
from repro_torch.core.ranks import HOST, MeshRanks

__all__ = ["make_spmv_full_mesh", "make_jacobi_full_mesh",
           "make_fused_step_full_mesh", "make_fused_ops_full_mesh",
           "make_rank_ops_full_mesh", "ShardRanks",
           "shard_sum", "shard_dots", "halo_bands",
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


def _neighbour_terms(b_dn, below, b_up, above, down: list, up: list,
                     m: int, plane: int):
    """``(dc, uc)``: the halo terms of the rows ``[0, wd)`` of the shards
    whose bands are ``b_dn`` from the planes ``below`` them (each the last
    plane of the shard below), and of the rows ``[m - wu, m)`` of the
    shards ``b_up`` from the planes ``above`` them (each the first plane of
    the shard above); ``below``, ``above``: ``(n, plane)``.  None for a
    side no band reaches."""
    dc = uc = None
    for d, w in down:
        t = (b_dn[:, d, :w], below[:, plane - w:])
        if dc is None:
            dc = t[0] * t[1]
        else:
            dc[:, :w].addcmul_(*t)
    for d, w in up:
        t = (b_up[:, d, m - w:], above[:, :w])
        if uc is None:
            uc = t[0] * t[1]
        else:
            uc[:, uc.shape[1] - w:].addcmul_(*t)
    return dc, uc


def _halo_terms(b_sh: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                down: list, up: list, m: int, plane: int):
    """:func:`_neighbour_terms` of consecutive shards: the rows ``[0, wd)``
    of shards 1..S-1 (from the last planes ``hi`` of shards 0..S-2) and the
    rows ``[m - wu, m)`` of shards 0..S-2 (from the first planes ``lo`` of
    shards 1..S-1); ``lo``, ``hi``: ``(S, plane)``."""
    return _neighbour_terms(b_sh[1:], hi[:-1], b_sh[:-1], lo[1:], down, up,
                            m, plane)


def _add_terms(y_dn, y_up, dc, uc, m: int,
               active: torch.Tensor | None = None) -> None:
    """``y_dn[:, :wd] += dc`` and ``y_up[:, m - wu:] += uc`` in place; under
    the loop guard ``active`` through selects, so nothing changes while it
    is False."""
    for win, t in ((None if dc is None else y_dn[:, :dc.shape[1]], dc),
                   (None if uc is None else y_up[:, m - uc.shape[1]:], uc)):
        if t is None:
            continue
        if active is None:
            win.add_(t)
        else:
            torch.where(active, win + t, win, out=win)


def _add_halo(y: torch.Tensor, dc, uc, m: int,
              active: torch.Tensor | None = None) -> None:
    """:func:`_add_terms` of :func:`_halo_terms`: ``y[1:, :wd] += dc`` and
    ``y[:-1, m - wu:] += uc`` (``y`` ``(S, m)``)."""
    _add_terms(y[1:], y[:-1], dc, uc, m, active)


def _terms_dots(lo_dn, hi_up, dc, uc, plane: int, per_dn, per_up) -> None:
    """Add each boundary row's ``x . (A x - A_local x)`` to its shard's
    partial: ``lo_dn`` the first planes of ``x`` of the shards ``dc``
    reaches (partials ``per_dn``), ``hi_up`` the last planes of those
    ``uc`` reaches (``per_up``)."""
    if dc is not None:
        per_dn += (lo_dn[:, :dc.shape[1]] * dc).sum(1)
    if uc is not None:
        per_up += (hi_up[:, plane - uc.shape[1]:] * uc).sum(1)


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
    alpha)``, ``(n_shards, nb, m_loc)``); ``x``: the stacked ``(n_c,
    m_c)`` vector (or ``(n_shards, m_loc)``).  Returns ``A x`` shaped as
    ``x``, and with ``with_dot`` also ``x . A x``: each shard's partials
    of ``x . A_local x`` (the SpMV+dot kernel's, which computes ``A x``
    too) plus its boundary rows' terms, summed in shard order.
    ``use_kernel``: None or True, the DIA SpMV (or SpMV+dot) kernel for
    the local apply (its plain version for CPU tensors); False, the plain
    shift loop (the SpMV+dot's plain version).

    On a mesh whose shards sit on several distinct devices (f64 only, both
    tensors on the first shard's device), each call lays the bands out on
    a :class:`ShardRanks` and runs its ranks' product: the halo planes
    copied between devices, each rank's shards as the lanes of one launch,
    the dot's per-shard values summed in shard order on the host; ``A x``
    comes back on the first shard's device.
    """
    S, m = check_full_mesh(mesh, offsets=offsets, plane=plane,
                           n_coarse=n_coarse, alpha=alpha, m_coarse=m_coarse)
    if mesh.one_device is None:
        return _spmv_on_ranks(mesh, S, m, offsets, plane, alpha, with_dot,
                              use_kernel)
    from repro_torch.kernels.krylov_fused import krylov_fused as kf

    down, up = halo_bands(offsets)
    spmv_dot = (kf.spmv_dot_partials_plain if use_kernel is False
                else kf.spmv_dot_partials)
    npl, stride = kf.lane_partials(S * m, S)
    part = {"npl": npl, "stride": stride}

    def spmv(b_sh, x):
        x_sh = x.reshape(S, m)
        if with_dot:
            y, dot_part = spmv_dot(b_sh, x_sh, offsets=offsets, plane=plane,
                                   lanes=S)
        else:
            y = _local_apply(b_sh, x_sh, offsets, plane, use_kernel)
        lo, hi = x_sh[:, :plane], x_sh[:, m - plane:]
        dc, uc = _halo_terms(b_sh, lo, hi, down, up, m, plane)
        _add_halo(y, dc, uc, m)
        if not with_dot:
            return y.view(x.shape)
        per = _lane_part_sums(dot_part, part)
        _terms_dots(lo[1:], hi[:-1], dc, uc, plane, per[1:], per[:-1])
        return y.view(x.shape), shard_sum(per)

    return spmv


def _spmv_on_ranks(mesh, S, m, offsets, plane, alpha, with_dot,
                   use_kernel) -> Callable:
    """:func:`make_spmv_full_mesh` over several devices: the product of a
    :class:`ShardRanks` built from the call's bands (a unit diagonal: the
    product takes no Jacobi apply)."""
    def spmv(b_sh, x):
        sr = ShardRanks(mesh, from_shards(b_sh, alpha),
                        b_sh.new_ones((S, m)), offsets=offsets, plane=plane,
                        alpha=alpha, kernels=use_kernel is not False)
        x_sh = x.reshape(S, m)
        home = sr.group.devices[0]

        def work(r):
            ranks, dev = sr.group.ranks, sr.group.devices[r]
            x_r = ranks.carry(x_sh[sr.sel[r]], home, dev, "b_c")
            if with_dot:
                y_r, dot = sr.ops[r].matvec_dot(x_r)
            else:
                y_r, dot = sr.ops[r].matvec(x_r), None
            return ranks.carry(y_r, dev, home, "x_back"), dot

        outs = sr.group.ranks.run(work)
        y = sr.join(x_sh, [y_r for y_r, _ in outs]).view(x.shape)
        return (y, outs[0][1]) if with_dot else y

    return spmv


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
                             m_coarse: int, moves=None):
    """The full-mesh fused :class:`~repro_torch.solvers.ops.SolverOps`
    bundle (module doc) over the stacked bands ``(n_c, nb, m_c)`` and
    diagonal ``(n_c, m_c)`` on the device of the mesh's first shard.  f64
    only, as in JAX; one system (no cohort lanes).  A mesh over several
    distinct devices gives :func:`make_rank_ops_full_mesh`'s bundle, its
    copies between devices booked in ``moves`` (a
    :class:`~repro_torch.core.update.MoveRecord`, optional)."""
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        partials_buffers, spmv_dot_direction)
    from repro_torch.kernels.krylov_loop.krylov_loop import (cg_advance,
                                                             cg_alpha)
    from repro_torch.solvers.jacobi import safe_jacobi_inverse
    from repro_torch.solvers.ops import SolverOps

    S, m = check_full_mesh(mesh, offsets=offsets, plane=plane,
                           n_coarse=n_coarse, alpha=alpha, m_coarse=m_coarse)
    if mesh.one_device is None:
        return make_rank_ops_full_mesh(
            mesh, bands, diag, offsets=offsets, plane=plane,
            n_coarse=n_coarse, alpha=alpha, m_coarse=m_coarse, moves=moves)
    _check_home(mesh, bands)
    dev = bands.device
    down, up = halo_bands(offsets)
    b_sh = to_shards(bands.contiguous(), alpha)
    inv = safe_jacobi_inverse(diag).contiguous()
    plain, plain_dot = (make_spmv_full_mesh(
        mesh, offsets=offsets, plane=plane, n_coarse=n_coarse, alpha=alpha,
        m_coarse=m_coarse, with_dot=d) for d in (False, True))
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
        _terms_dots(lo[1:], hi[:-1], dc, uc, plane, per[1:], per[:-1])
        return shard_sum(per, out)

    def matvec(x):
        return plain(b_sh, x)

    def precond(r):
        return r * inv

    def matvec_dot(p):
        return plain_dot(b_sh, p)

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


def _check_home(mesh: ShardMesh, bands: torch.Tensor) -> None:
    """Raise unless the bands are f64 and on the mesh's first shard's
    device (a CPU tensor on any CPU place)."""
    first = mesh.flat()[0]
    if bands.device.type != first.type or (first.type == "cuda"
                                           and bands.device != first):
        raise ValueError(f"the mesh's first shard is on {first}, the bands "
                         f"on {bands.device}")
    if bands.dtype != torch.float64:
        raise ValueError("the full-mesh solve is f64 only")


def _on_ranks(*_args, **_kwargs):
    raise RuntimeError("a full-mesh bundle over several devices holds its "
                       "rows on its ranks: solvers.cg runs the host loop "
                       "of each rank's bundle (ops.ranks.ops)")


class ShardRanks:
    """A full mesh's CG over its distinct devices (module doc): one rank a
    device (:class:`~repro_torch.core.ranks.MeshRanks`, a row shard in
    the place of a fine part), rank 0 the first shard's.  Built from the
    stacked system on rank 0's device, it gives each rank its shards'
    bands (move kind ``bands_p``), diagonal (``diag_c``) and safe Jacobi
    inverse, once, and its host-loop bundle ``ops[r]``.  A solve over the
    ranks (:attr:`~repro_torch.solvers.ops.SolverOps.ranks`,
    :func:`~repro_torch.solvers.cg._cg_sweep_ranks`) runs one loop a rank
    through :meth:`run`: :meth:`take` gives the rank its rows of ``b`` and
    ``x0`` (``b_c``, ``x0_c``), :meth:`give` hands its rows of the
    solution back (``x_back``), :meth:`join` stacks them.  ``kernels``: a
    card's
    rank launches the SpMV+dot and the axpy kernels (the wrappers, which
    take their plain versions for a CPU rank's tensors); False, the plain
    versions everywhere (the reference backend).  ``moves`` (a
    :class:`~repro_torch.core.update.MoveRecord`, optional) books each
    copy between devices and each kind's closed form.  ``last_ranks``:
    the last call's ``{"device", "shards", "s", "waited_s"}`` a rank."""

    def __init__(self, mesh: ShardMesh, bands, diag, *, offsets, plane: int,
                 alpha: int, kernels: bool = True, moves=None):
        from repro_torch.core.update import shard_moves, solve_halo_moves
        from repro_torch.solvers.jacobi import safe_jacobi_inverse

        _check_home(mesh, bands)
        S, m = mesh.n_shards, bands.shape[-1] // alpha
        self.mesh, self.S, self.m, self.plane = mesh, S, m, plane
        self.offsets = tuple(int(o) for o in offsets)
        self.kernels, self.moves = kernels, moves
        self.itemsize = bands.element_size()
        self.group = g = MeshRanks(mesh, S, ledger=moves)
        self.sel = [slice(ids[0], ids[-1] + 1)
                    if ids[-1] + 1 - ids[0] == len(ids) else ids
                    for ids in g.parts]
        b_sh = to_shards(bands.contiguous(), alpha)
        d_sh = diag.reshape(S, m)
        home = g.devices[0]
        if moves is not None:
            for kind, t in (("bands_p", b_sh), ("diag_c", d_sh)):
                moves.add(kind, shard_moves(mesh, t[0].numel()
                                            * t.element_size()))
        self.halo_form = solve_halo_moves(mesh, list(range(S)),
                                          plane * bands.element_size())
        self.ops = []
        for r, dev in enumerate(g.devices):
            bands_r = g.ranks.carry(b_sh[self.sel[r]], home, dev, "bands_p")
            diag_r = g.ranks.carry(d_sh[self.sel[r]], home, dev, "diag_c")
            self.ops.append(self._rank_ops(
                r, bands_r.contiguous(),
                safe_jacobi_inverse(diag_r).contiguous()))
        self.last_ranks = None
        self._seconds = [0.0] * g.ranks.n

    def _total(self, r: int, pers) -> tuple:
        """Each of ``pers`` (rank ``r``'s per-shard values, ``(n,)``) over
        every shard: the ranks' values put in shard order on the host and
        summed there by :func:`shard_sum`, on every rank the same bits."""
        ranks, dev = self.group.ranks, self.group.devices[r]
        mine = ranks.carry(torch.stack(list(pers)), dev, HOST, "scalars")

        def take(slots):
            full = slots[0].new_empty((len(pers), self.S))
            for sel, got in zip(self.sel, slots):
                full[:, sel] = got
            sums = torch.stack([shard_sum(row) for row in full])
            return ranks.carry(sums, HOST, dev, "scalars")

        return tuple(ranks.exchange(r, mine, take).unbind())

    def _rank_ops(self, r: int, bands, inv):
        """Rank ``r``'s bundle over its ``n`` shards' rows ``(n, m)``."""
        from repro_torch.kernels.krylov_fused import krylov_fused as kf
        from repro_torch.solvers.ops import SolverOps

        g, S, m, plane = self.group, self.S, self.m, self.plane
        ids, dev = g.parts[r], g.devices[r]
        n = len(ids)
        # the shards a halo term reaches: not the first shard's lower rows,
        # not the last shard's upper ones
        d0, nu = int(ids[0] == 0), n - int(ids[-1] == S - 1)
        down, up = halo_bands(self.offsets)
        planes = g.planes(r, ids, g.rank_of_part, g.index, plane,
                          "solve_halo")
        npl, stride = kf.lane_partials(n * m, n)
        part = (kf.partials_buffers(n * m, bands.dtype, dev, lanes=n)
                if self.kernels else {"npl": npl, "stride": stride})
        kw = dict(offsets=self.offsets, plane=plane, lanes=n)

        def product(x, with_dot: bool):
            """``A x`` over the rank's rows and (``with_dot``) each shard's
            ``x . A x``: the neighbour planes first, then one launch over
            the shards as lanes, then the halo terms."""
            if r == 0 and self.moves is not None:
                self.moves.add("solve_halo", self.halo_form)
            below, above = planes(x)
            per = None
            if with_dot:
                spmv_dot = (kf.spmv_dot_partials if self.kernels
                            else kf.spmv_dot_partials_plain)
                y, dot_part = spmv_dot(bands, x, **kw)
                per = _lane_part_sums(dot_part, part)
            else:
                y = _local_apply(bands, x, self.offsets, plane,
                                 None if self.kernels else False)
            dc, uc = _neighbour_terms(bands[d0:], below[d0:], bands[:nu],
                                      above[:nu], down, up, m, plane)
            _add_terms(y[d0:], y[:nu], dc, uc, m)
            if with_dot:
                _terms_dots(x[d0:, :plane], x[:nu, m - plane:], dc, uc,
                            plane, per[d0:], per[:nu])
            return y, per

        def matvec_dot(p):
            y, per = product(p, True)
            return y, self._total(r, (per,))[0]

        def fused_step(x, rv, p, Ap, a):
            # x and r in place: the rank's own rows
            alphas = a.reshape(1).expand(n).contiguous()
            if self.kernels:
                z = torch.empty_like(x)
                rz, rr = _axpy_lanes(x, rv, p, Ap, inv, alphas, z, part, n)
            else:
                x, rv, z, *got = kf.axpy_precond_partials_plain(
                    x, rv, p, Ap, inv, alphas)
                rz, rr = (_lane_part_sums(t, part) for t in got)
            return (x, rv, z, *self._total(r, (rz, rr)))

        def dots(*pairs):
            return self._total(r, [(a.reshape(n, -1) * b.reshape(n, -1))
                                   .sum(1) for a, b in pairs])

        return SolverOps(
            matvec=lambda x: product(x, False)[0], precond=lambda v: v * inv,
            matvec_dot=matvec_dot, fused_step=fused_step, dots=dots,
            matvec_into=_on_ranks, matvec_dot_direction_into=_on_ranks,
            alpha_into=_on_ranks, fused_step_into=_on_ranks,
            advance=_on_ranks, host_loop=True,
            backend="fused" if self.kernels else "reference")

    def take(self, r: int, b, x0, thr):
        """Rank ``r``'s rows of the stacked ``b`` and ``x0`` and the
        threshold ``thr`` (on rank 0's device) on its device, ``x0``'s a
        copy the loop may write; starts the rank's clock."""
        ranks, sel = self.group.ranks, self.sel[r]
        self._seconds[r] = time.perf_counter()
        home, dev = ranks.devices[0], ranks.devices[r]
        rows = (self.S, self.m)
        return (ranks.carry(b.reshape(rows)[sel], home, dev, "b_c"),
                ranks.carry(x0.reshape(rows)[sel], home, dev, "x0_c",
                            copy=True),
                ranks.carry(thr, home, dev, "scalars"))

    def give(self, r: int, x):
        """Rank ``r``'s rows of the solution on rank 0's device; stops the
        rank's clock."""
        ranks = self.group.ranks
        x = ranks.carry(x, ranks.devices[r], ranks.devices[0], "x_back")
        self._seconds[r] = time.perf_counter() - self._seconds[r]
        return x

    def run(self, work) -> list:
        """``[work(0), ..., work(n - 1)]``, one thread a rank
        (:meth:`~repro_torch.core.ranks.Ranks.run`), the solve's closed
        forms booked and each rank's seconds and waits kept in
        ``last_ranks``."""
        from repro_torch.core.update import shard_moves

        ranks = self.group.ranks
        if self.moves is not None:
            form = shard_moves(self.mesh, self.m * self.itemsize)
            for kind in ("b_c", "x0_c", "x_back"):
                self.moves.add(kind, form)
        outs = ranks.run(work)
        self.last_ranks = [
            {"device": str(d), "shards": len(ids), "s": s, "waited_s": w}
            for d, ids, s, w in zip(ranks.devices, self.group.parts,
                                    self._seconds, ranks.waited)]
        return outs

    def join(self, b, xs):
        """The ranks' solution rows ``xs`` (rank order, on rank 0's
        device) stacked as ``b``."""
        x = torch.empty((self.S, self.m), dtype=b.dtype, device=b.device)
        for sel, x_r in zip(self.sel, xs):
            x[sel] = x_r
        return x.view(b.shape)


def make_rank_ops_full_mesh(mesh: ShardMesh, bands: torch.Tensor,
                            diag: torch.Tensor, *, offsets: tuple[int, ...],
                            plane: int, n_coarse: int, alpha: int,
                            m_coarse: int, kernels: bool = True, moves=None):
    """The full-mesh :class:`~repro_torch.solvers.ops.SolverOps` bundle of a
    mesh whose shards sit on several distinct devices: a
    :class:`ShardRanks` as its ``ranks`` (``kernels``: the fused
    backend's kernels on a card's rank, else the plain versions; ``moves``
    books the copies), ``host_loop``, and ``dots`` on the stacked vectors
    (per shard, in shard order: the threshold of :func:`~repro_torch.
    solvers.cg.cg`).  Its other members refuse: its rows live on the
    ranks."""
    from repro_torch.solvers.ops import SolverOps

    S, _ = check_full_mesh(mesh, offsets=offsets, plane=plane,
                           n_coarse=n_coarse, alpha=alpha, m_coarse=m_coarse)
    ranks = ShardRanks(mesh, bands, diag, offsets=offsets, plane=plane,
                       alpha=alpha, kernels=kernels, moves=moves)

    def dots(*pairs):
        return tuple(shard_dots(a, b, S) for a, b in pairs)

    return SolverOps(matvec=_on_ranks, precond=_on_ranks,
                     matvec_dot=_on_ranks, fused_step=_on_ranks, dots=dots,
                     matvec_into=_on_ranks,
                     matvec_dot_direction_into=_on_ranks,
                     alpha_into=_on_ranks, fused_step_into=_on_ranks,
                     advance=_on_ranks, host_loop=True, ranks=ranks,
                     backend="fused" if kernels else "reference")
