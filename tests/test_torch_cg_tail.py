"""The CG iteration's scalar tail (``cg_alpha``, ``cg_advance``) on the CPU.

The two tail kernels sum each lane's reduction partials in one fixed tree
(``csrc/krylov_loop.cu``): a cluster of 8 CTAs a lane, each CTA a
contiguous chunk of the run in rounds of 256 16-byte vectors, a thread's
values added in order from +0.0, a warp's 32 sums down a shuffle tree, a
CTA's 8 warp sums down a tree, the 8 CTA sums in rank order.  Here the
plain versions must be that tree bit for bit, as an independent numpy
model of the documented order computes it; the guard must leave today's
carry given the same sums and write nothing while a lane's flag is down;
and the CG loop on the new body (fold, ``cg_alpha``, axpy,
``cg_advance``) must keep JAX's counts and flags with solutions within
1e-10, for one system, a cohort and the full mesh's shard lanes.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.repartition import plan_for_mesh as jax_plan_for_mesh
from repro.core.update import update_device_direct as jax_update
from repro.fvm.mesh import CavityMesh as JaxMesh
from repro.solvers.cg import cg as jax_cg
from repro.solvers.jacobi import jacobi_preconditioner as jax_jacobi
from repro.solvers.ops import reference_ops as jax_reference_ops
from repro.sparse.distributed import spmv_dia as jax_spmv_dia

from repro_torch.core.comm import make_cfd_mesh
from repro_torch.core.repartition import plan_for_mesh
from repro_torch.core.update import update_device_direct
from repro_torch.fvm.mesh import CavityMesh
from repro_torch.kernels import WRAPPERS
from repro_torch.kernels.device_counts import (MAX_LANES, PER_LANE, SLOTS,
                                               launched)
from repro_torch.kernels.krylov_fused import krylov_fused as torch_kf
from repro_torch.kernels.krylov_loop import krylov_loop as torch_kl
from repro_torch.kernels.krylov_loop.krylov_loop import (
    TAIL_CTAS, cg_advance, cg_advance_cost, cg_advance_plain, cg_alpha,
    cg_alpha_cost, cg_alpha_plain, lane_tree_sums_plain, partials_sum)
from repro_torch.solvers import device_loop
from repro_torch.solvers.cg import cg
from repro_torch.solvers.ops import fused_stacked_ops
from repro_torch.sparse.shardmap_spmv import make_fused_ops_full_mesh

from test_solvers import laplacian_buffers
from test_torch_solvers import PARITY

THREADS = 256
NPLS = (1, 7, 4523, 36176)
LANES = (1, 3, 30)
DTYPES = {"f64": torch.float64, "f32": torch.float32}
BITS = {torch.float64: torch.int64, torch.float32: torch.int32}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal, NaN payloads and signed zeros included."""
    if a.dtype in BITS:
        return torch.equal(a.contiguous().view(BITS[a.dtype]),
                           b.contiguous().view(BITS[b.dtype]))
    return torch.equal(a, b)


def np_tree(run: np.ndarray):
    """The documented tree over one run, element by element in numpy:
    CTA ``c`` of 8 takes ``[c L, c L + L)``, ``L = J 256 W``; thread ``t``
    adds, round by round, the ``W`` values at ``c L + (j 256 + t) W + e``
    (zero past the run); ``__shfl_down_sync`` (a lane past the warp reads
    its own value), then ``w[i] += w[i + h]`` over the 8 warp sums, then
    the CTA sums in rank order."""
    n, dt = run.size, run.dtype
    W = 16 // run.itemsize
    J = -(-n // (TAIL_CTAS * THREADS * W))
    L = J * THREADS * W
    t = np.arange(THREADS)
    cta = []
    for c in range(TAIL_CTAS):
        acc = np.zeros(THREADS, dtype=dt)
        for j in range(J):
            for e in range(W):
                idx = c * L + (j * THREADS + t) * W + e
                vals = np.where(idx < n, run[np.minimum(idx, n - 1)],
                                dt.type(0)).astype(dt)
                acc = (acc + vals).astype(dt)
        warps = acc.reshape(THREADS // 32, 32)
        lane = np.arange(32)
        for h in (16, 8, 4, 2, 1):
            src = lane + h
            other = np.where(src < 32, warps[:, np.minimum(src, 31)], warps)
            warps = (warps + other).astype(dt)
        w = list(warps[:, 0])
        for h in (4, 2, 1):
            for i in range(h):
                w[i] = dt.type(w[i] + w[i + h])
        cta.append(w[0])
    total = cta[0]
    for c in range(1, TAIL_CTAS):
        total = dt.type(total + cta[c])
    return total


def _stride(npl: int, lanes: int) -> int:
    return npl if lanes == 1 else -(-npl // 128) * 128


def _runs(npl, lanes, dtype, seed=0, stride=None):
    """``lanes`` runs of ``npl`` random partials (both signs, several
    magnitudes) ``stride`` apart, garbage between the runs."""
    rng = np.random.default_rng(seed)
    stride = _stride(npl, lanes) if stride is None else stride
    buf = rng.standard_normal(lanes * stride) * 10.0 ** rng.integers(
        -3, 4, lanes * stride)
    return torch.as_tensor(buf).to(dtype), stride


# ---------------------------------------------------------------------------
# the plain tree against numpy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("npl", NPLS)
def test_plain_tree_is_the_numpy_tree(npl, lanes, dname):
    """``lane_tree_sums_plain`` is, bit for bit, the numpy model of the
    documented order, lane by lane, and each sum is within ``npl`` ulps
    (relative to the sum of magnitudes) of ``math.fsum``."""
    dtype = DTYPES[dname]
    part, stride = _runs(npl, lanes, dtype, seed=npl + lanes)
    got = lane_tree_sums_plain(part, npl, stride, lanes)
    assert got.shape == (lanes,) and got.dtype == dtype
    eps = torch.finfo(dtype).eps
    for lane in range(lanes):
        run = part[lane * stride:lane * stride + npl].numpy()
        want = np_tree(run)
        assert _same_bits(got[lane], torch.tensor(want))
        exact = math.fsum(float(v) for v in run)
        scale = math.fsum(abs(float(v)) for v in run)
        assert abs(float(got[lane]) - exact) <= npl * eps * scale


def test_tree_reads_only_each_lanes_run():
    """An unaligned stride and garbage (NaN) between the runs: each lane
    sums its own ``npl`` values, the same bits as that run alone."""
    for dtype in DTYPES.values():
        npl, lanes, stride = 4523, 3, 4523 + 5
        part, _ = _runs(npl, lanes, dtype, seed=3, stride=stride)
        for lane in range(lanes):
            part[lane * stride + npl:(lane + 1) * stride] = float("nan")
        got = lane_tree_sums_plain(part, npl, stride, lanes)
        for lane in range(lanes):
            run = part[lane * stride:lane * stride + npl].clone()
            assert _same_bits(got[lane], lane_tree_sums_plain(run, npl, npl,
                                                              1)[0])


def test_tree_of_one_partial_is_the_partial():
    """One partial a lane (the full mesh's sums): its bits, NaN and inf
    included; a -0.0 alone sums to +0.0 (a thread's sum starts at +0.0)."""
    vals = torch.tensor([3.25, -1e-300, float("inf"), float("nan"), -0.0],
                        dtype=torch.float64)
    got = lane_tree_sums_plain(vals, 1, 1, vals.numel())
    assert _same_bits(got[:3], vals[:3]) and math.isnan(float(got[3]))
    assert _same_bits(got[4], torch.tensor(0.0, dtype=torch.float64))


# ---------------------------------------------------------------------------
# the wrappers on the CPU and the guard
# ---------------------------------------------------------------------------

def _part(npl, lanes, dtype, seed=0):
    rz, stride = _runs(npl, lanes, dtype, seed)
    rr, _ = _runs(npl, lanes, dtype, seed + 1)
    dot, _ = _runs(npl, lanes, dtype, seed + 2)
    return {"dot": dot, "rz": rz, "rr": rr.abs(), "npl": npl,
            "stride": stride}


@pytest.mark.parametrize("dname", DTYPES)
def test_tail_writes_the_tree_sums(dname):
    """``cg_alpha`` (and its plain version) writes ``pAp`` = the tree sums
    and ``alpha = gamma / pAp``; ``partials_sum`` is one run's tree sum;
    ``cg_advance`` given the partials writes ``gamma_new`` and ``rr_new``
    = the tree sums before the carry moves.  Nothing is counted on the
    CPU."""
    dtype = DTYPES[dname]
    lanes, npl = 3, 4523
    part = _part(npl, lanes, dtype)
    sums = {k: torch.tensor([np_tree(part[k][lane * part["stride"]:][:npl]
                                     .numpy()) for lane in range(lanes)])
            for k in ("dot", "rz", "rr")}
    gamma = torch.tensor([0.5, 2.0, 3.0], dtype=dtype)
    for fn in (cg_alpha, cg_alpha_plain):
        pAp, alpha = torch.empty(lanes, dtype=dtype), torch.empty(
            lanes, dtype=dtype)
        fn(part["dot"], npl, part["stride"], pAp, gamma, alpha)
        assert _same_bits(pAp, sums["dot"])
        assert _same_bits(alpha, gamma / sums["dot"])
    run = part["dot"][:npl]
    assert _same_bits(partials_sum(run), sums["dot"][0])
    for fn in (cg_advance, cg_advance_plain):
        g_new, rr_new = (torch.full((lanes,), 7.0, dtype=dtype)
                         for _ in "ab")
        g, rr = gamma.clone(), torch.ones(lanes, dtype=dtype)
        k = torch.zeros(lanes, dtype=torch.int32)
        active = torch.ones(lanes, dtype=torch.bool)
        fn(g, g_new, rr, rr_new, k, active, torch.zeros(lanes, dtype=dtype),
           10, part=part)
        assert _same_bits(g_new, sums["rz"]) and _same_bits(rr_new,
                                                            sums["rr"])
        assert _same_bits(g, sums["rz"]) and _same_bits(rr, sums["rr"])
    assert all(fn.launches == 0 for fn in WRAPPERS.values())


STATES = ("running", "converging", "capped", "nan_pAp", "nan_rr", "frozen")


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("state", STATES)
def test_guard_gives_todays_carry_from_the_same_sums(state, dname):
    """Lane 1 in ``state`` between two running lanes: ``cg_alpha`` then
    ``cg_advance`` with the partials give exactly what today's
    ``cg_advance_plain`` gives from the same sums (``gamma_new``,
    ``rr_new`` preset to them), ``alpha = gamma / pAp`` where a lane
    runs, and a lane whose flag is down keeps every value (``pAp``,
    ``alpha``, ``gamma_new``, ``rr_new`` included)."""
    dtype = DTYPES[dname]
    lanes, npl, maxiter = 3, 777, 9
    part = _part(npl, lanes, dtype, seed=5)
    stride = part["stride"]
    if state in ("nan_pAp", "nan_rr"):
        key = "dot" if state == "nan_pAp" else "rr"
        part[key][stride + 17] = float("nan")
    sums = lane_tree_sums_plain(part["rr"], npl, stride, lanes)
    thr = 0.5 * sums
    k0 = torch.tensor([2, 2, 2], dtype=torch.int32)
    flags = torch.ones(lanes, dtype=torch.bool)
    if state == "converging":
        thr[1] = sums[1]
    elif state == "capped":
        k0[1] = maxiter - 1
    elif state == "frozen":
        flags[1] = False
    gamma = torch.tensor([0.75, 1.5, 2.25], dtype=dtype)
    start = dict(pAp=7.0, alpha=7.0, g_new=7.0, rr_new=7.0, rr=5.0,
                 beta=-9.0)

    def carry():
        c = {n: torch.full((lanes,), v, dtype=dtype)
             for n, v in start.items()}
        c.update(g=gamma.clone(), k=k0.clone(), active=flags.clone())
        return c

    runs = []
    for fn_a, fn_b in ((cg_alpha, cg_advance),
                       (cg_alpha_plain, cg_advance_plain)):
        new = carry()
        fn_a(part["dot"], npl, stride, new["pAp"], new["g"], new["alpha"],
             new["active"])
        fn_b(new["g"], new["g_new"], new["rr"], new["rr_new"], new["k"],
             new["active"], thr, maxiter, beta=new["beta"], part=part)
        runs.append(new)
    assert all(_same_bits(runs[0][n], runs[1][n]) for n in runs[0])
    old = carry()
    on = flags
    for name, key in (("g_new", "rz"), ("rr_new", "rr")):
        s = lane_tree_sums_plain(part[key], npl, stride, lanes)
        old[name] = torch.where(on, s, old[name])
    cg_advance_plain(old["g"], old["g_new"], old["rr"], old["rr_new"],
                     old["k"], old["active"], thr, maxiter, beta=old["beta"])
    for name in ("g", "g_new", "rr", "rr_new", "beta", "k", "active"):
        assert _same_bits(new[name], old[name]), name
    dots = lane_tree_sums_plain(part["dot"], npl, stride, lanes)
    assert _same_bits(new["pAp"], torch.where(on, dots, 7.0))
    assert _same_bits(new["alpha"], torch.where(on, gamma / dots, 7.0))
    want_active = {"running": True, "converging": False, "capped": False,
                   "nan_pAp": True, "nan_rr": False, "frozen": False}
    assert new["active"].tolist() == [True, want_active[state], True]
    if state == "frozen":
        for name, v in start.items():
            assert float(new[name][1]) == v
        assert int(new["k"][1]) == 2 and float(new["g"][1]) == 1.5


def test_counters_and_costs():
    """``cg_alpha`` has a slot of its own, ``cg_advance`` a run of
    per-lane counters whose most counted lane is its launches; the costs
    count the partials read."""
    assert "cg_alpha" in SLOTS and PER_LANE == "cg_advance"
    read = [0] * len(SLOTS) + [3, 5, 4] + [0] * (MAX_LANES - 3)
    read[SLOTS.index("cg_alpha")] = 5
    got = launched(read, 3)
    assert got["cg_alpha"] == 5 and got["cg_advance"] == 5
    assert cg_alpha_cost(36176, 1, 8)["bytes_accessed"] == 36179 * 8
    assert cg_advance_cost(36176, 1, 8)["bytes_accessed"] == (
        (2 * 36176 + 7) * 8 + 10)
    assert cg_advance_cost(1206, 30, 4)["bytes_accessed"] == 30 * (
        (2 * 1206 + 7) * 4 + 10)


# ---------------------------------------------------------------------------
# the CG loop on the new body against JAX
# ---------------------------------------------------------------------------

def _cavity(n: int, parts: int, alpha: int, lanes: int = 1):
    """``lanes`` cavity pressure Laplacians on ``cube(n, parts)`` fused by
    ``alpha`` (lane ``l``'s diagonal raised by ``4 l``), each with a
    random right-hand side: per lane the JAX reference ops, the port's
    bands, diagonal and ``b``; and the offsets, plane and the port's
    plan."""
    mesh = JaxMesh.cube(n, parts)
    layout, buffers, diag = laplacian_buffers(mesh)
    buffers, diag = np.array(buffers), np.array(diag)
    n_c = mesh.n_parts // alpha
    plan_j = jax_plan_for_mesh(mesh, alpha)
    offsets = tuple(int(o) for o in plan_j.dia_offsets)
    plan = plan_for_mesh(CavityMesh.cube(n, parts), alpha)
    rng = np.random.default_rng(27)
    out = []
    for lane in range(lanes):
        buf, dg = buffers.copy(), diag + 4.0 * lane
        buf[:, layout.segments()["diag"]] += 4.0 * lane
        bands_j = jax_update(plan_j, jnp.asarray(buf).reshape(n_c, alpha,
                                                              -1))
        ops_j = jax_reference_ops(
            lambda v, bj=bands_j: jax_spmv_dia(bj, v, offsets=offsets,
                                               plane=plan_j.plane),
            jax_jacobi(jnp.asarray(dg).reshape(n_c, -1)))
        out.append({
            "ops_j": ops_j,
            "bands": update_device_direct(
                plan, torch.as_tensor(buf).reshape(n_c, alpha, -1)),
            "diag": torch.as_tensor(dg).reshape(n_c, -1),
            "b": rng.standard_normal(mesh.n_cells_global).reshape(n_c, -1)})
    return out, offsets, plan


@pytest.fixture
def spied(monkeypatch):
    """Counts the calls of the loop's four members' wrappers."""
    calls = {}

    def spy(mod, name):
        fn = getattr(mod, name)

        def counted(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, counted)

    spy(torch_kf, "spmv_dot_direction")
    spy(torch_kf, "axpy_precond_inplace")
    spy(torch_kl, "cg_alpha")
    spy(torch_kl, "cg_advance")
    return calls


def _check_against_jax(res, systems, lane_x, maxiter):
    for lane, s in enumerate(systems):
        b = jnp.asarray(s["b"])
        res_j = jax_cg(s["ops_j"], b, jnp.zeros_like(b), tol=1e-10,
                       maxiter=maxiter)
        assert int(res.iters.reshape(-1)[lane]) == int(res_j.iters)
        assert bool(res.converged.reshape(-1)[lane]) == bool(
            res_j.converged)
        assert bool(res.hit_cap.reshape(-1)[lane]) == bool(res_j.hit_cap)
        np.testing.assert_allclose(lane_x(lane).numpy(), np.asarray(res_j.x),
                                   rtol=0, atol=PARITY)


@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("system", ["one", "cohort3", "full_mesh"])
def test_cg_on_the_tail_matches_jax(system, K, monkeypatch, spied):
    """The CG loop through the new body on the CPU, on the fused bundle:
    JAX's counts and flags with ``x`` within 1e-10 of JAX's ``cg`` on a
    small cavity pressure system — one system, a cohort of three lanes,
    and the full mesh's shards as the lanes of its kernels — with the
    fold, ``cg_alpha``, the axpy and ``cg_advance`` each called once an
    iteration of the block runner."""
    monkeypatch.setitem(device_loop.K, "cg", K)
    lanes = 3 if system == "cohort3" else 1
    systems, offsets, plan = _cavity(8, 4, 2, lanes)
    bands = torch.cat([s["bands"] for s in systems])
    diag = torch.cat([s["diag"] for s in systems])
    b = torch.cat([torch.as_tensor(s["b"]) for s in systems])
    if system == "full_mesh":
        n_c = bands.shape[0]
        ops = make_fused_ops_full_mesh(
            make_cfd_mesh(n_c, 2, devices=["cpu"] * (2 * n_c)), bands, diag,
            offsets=offsets, plane=plan.plane, n_coarse=n_c, alpha=2,
            m_coarse=plan.m_coarse)
    else:
        ops = fused_stacked_ops(bands, diag, offsets=offsets,
                                plane=plan.plane,
                                lanes=None if lanes == 1 else lanes)
    device_loop.reset_loop_records()
    res = cg(ops, b, torch.zeros_like(b), tol=1e-10, maxiter=500)
    rows = b.shape[0] // lanes
    _check_against_jax(res, systems,
                       lambda lane: res.x[lane * rows:(lane + 1) * rows],
                       500)
    (rec,) = device_loop.loop_records()
    members = ("spmv_dot_direction", "cg_alpha", "axpy_precond_inplace",
               "cg_advance")
    assert {spied[m] for m in members} == {rec.blocks * K}
