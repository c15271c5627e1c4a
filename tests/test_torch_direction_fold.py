"""The CG direction update folded into the SpMV+dot, on the CPU.

``spmv_dot_direction`` forms ``p' = z + beta p`` (``p' = z`` at the loop's
first iteration) from a pair of direction buffers chosen by each lane's
count ``k`` and then computes ``(A p', partials)``.  Its plain version
must be, bit for bit, ``cg_direction_plain`` followed by the guarded
SpMV+dot, so every Krylov count repeats; the CG loop built on it must keep
JAX's counts, flags and solutions (within 1e-10) and the former host loop's
bits, for one system and for a cohort whose lanes stop at different
iterations (each lane bitwise its solo run).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.repartition import plan_for_mesh as jax_plan_for_mesh
from repro.core.update import update_device_direct as jax_update
from repro.fvm.mesh import CavityMesh as JaxMesh
from repro.solvers.cg import cg as jax_cg
from repro.solvers.jacobi import jacobi_preconditioner as jax_jacobi
from repro.solvers.ops import reference_ops as jax_reference_ops
from repro.sparse.distributed import spmv_dia as jax_spmv_dia

from repro_torch.core.repartition import plan_for_mesh
from repro_torch.core.update import update_device_direct
from repro_torch.fvm.mesh import CavityMesh
from repro_torch.kernels.krylov_fused import krylov_fused as torch_kf
from repro_torch.kernels.krylov_fused.krylov_fused import (
    axpy_precond_inplace, axpy_precond_partials_plain,
    fused_matvec_dot_direction_into, lane_partials, partials_buffers,
    spmv_dot_direction, spmv_dot_direction_cost, spmv_dot_direction_plain,
    spmv_dot_partials)
from repro_torch.kernels.krylov_loop import krylov_loop as torch_kl
from repro_torch.kernels.krylov_loop.krylov_loop import (
    cg_advance, cg_advance_plain, cg_direction_plain, current_direction,
    direction_pair, next_direction_plain)
from repro_torch.solvers import cg as cg_mod
from repro_torch.solvers import device_loop
from repro_torch.solvers.cg import cg
from repro_torch.solvers.jacobi import jacobi_preconditioner
from repro_torch.solvers.ops import fused_stacked_ops, reference_ops
from repro_torch.sparse.distributed import spmv_dia

from test_solvers import laplacian_buffers
from test_torch_solvers import PARITY

PAIRS = [(torch.float64, torch.float64), (torch.float32, torch.float32),
         (torch.bfloat16, torch.float32)]
PAIR_IDS = ["f64", "f32", "bf16"]
# (P, m, nx, plane) per lane: a block-aligned part, a ragged part, and
# stacked ragged parts whose shifts cross into the neighbours' halos
SHAPES = [(1, 512, 8, 64), (1, 777, 4, 16), (3, 777, 4, 16)]
KS = (1, 3, 8, 64)
BITS = {torch.float64: torch.int64, torch.float32: torch.int32,
        torch.bfloat16: torch.int16}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal, NaN payloads and signed zeros included."""
    if a.dtype in BITS:
        return torch.equal(a.contiguous().view(BITS[a.dtype]),
                           b.contiguous().view(BITS[b.dtype]))
    return torch.equal(a, b)


def _inputs(P, m, nx, plane, storage, accum, lanes, ks, seed=0):
    """Operands of ``lanes`` lanes of (P, m) each, made with numpy: bands,
    ``z``, a direction pair with both buffers filled, one ``gamma_new``,
    ``gamma`` and ``beta = gamma_new / gamma`` (accum) and one count per
    lane (``ks``)."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape)).to(storage)

    d = {"bands": t(lanes * P, 7, m), "z": t(lanes * P, m),
         "pair": direction_pair(t(lanes * P, m)),
         "offsets": (-plane, -nx, -1, 0, 1, nx, plane), "plane": plane}
    d["pair"].copy_(t(2, lanes * P, m))
    g = torch.as_tensor(rng.random(lanes) + 0.5).to(accum)
    g_new = torch.as_tensor(rng.random(lanes) + 0.5).to(accum)
    d.update(g=g, g_new=g_new, beta=g_new / g,
             k=torch.tensor(ks, dtype=torch.int32))
    return d


def _unfused(d, storage, accum, lanes, active):
    """``cg_direction_plain`` (``z`` itself at ``k == 0``) into the pair's
    buffer ``(k + 1) % 2`` of each lane whose flag is set, then the
    guarded SpMV+dot of the new direction: the pair the fold replaces."""
    pair = d["pair"].clone()
    rows = d["z"].numel() // lanes
    new = torch.empty_like(d["z"])
    for lane, k in enumerate(d["k"].tolist()):
        sl = slice(lane * rows, (lane + 1) * rows)
        z = d["z"].reshape(-1)[sl]
        if k == 0:
            p = z.clone()
        else:
            p = cg_direction_plain(pair[k % 2].reshape(-1)[sl].clone(), z,
                                   d["g_new"][lane], d["g"][lane])
        new.reshape(-1)[sl] = p
        if active is None or bool(active.reshape(-1)[lane]):
            pair[(k + 1) % 2].reshape(-1)[sl] = p
    y, part = _outputs(d, accum, lanes)
    spmv_dot_partials(d["bands"], new, offsets=d["offsets"], plane=d["plane"],
                      accum_dtype=accum, out=(y, part), active=active,
                      lanes=lanes)
    return pair, y, part, new


def _outputs(d, accum, lanes):
    npl, stride = lane_partials(d["z"].numel(), lanes)
    n_part = lanes * stride if lanes > 1 else npl
    return (torch.full_like(d["z"], 7.0),
            torch.full((n_part,), 7.0, dtype=accum))


@pytest.mark.parametrize("flag", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=["aligned", "ragged",
                                               "stacked"])
@pytest.mark.parametrize("storage,accum", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("lanes,ks", [(1, (0,)), (1, (1,)), (1, (4,)),
                                      (3, (0, 1, 2)), (3, (5, 0, 2))],
                         ids=["k0", "k1", "k4", "lanes012", "lanes502"])
def test_fold_is_the_unfused_pair_bitwise(lanes, ks, storage, accum, shape,
                                          flag):
    """The wrapper on CPU tensors (its plain version, stored as the kernel
    stores) against ``cg_direction_plain`` then the guarded SpMV+dot: the
    pair's buffers, ``A p'`` and the partials bit for bit; under a False
    flag nothing is written."""
    P, m, nx, plane = shape
    d = _inputs(P, m, nx, plane, storage, accum, lanes, ks)
    active = torch.full((lanes,) if lanes > 1 else (), flag)
    pair_u, y_u, part_u, _ = _unfused(d, storage, accum, lanes, active)
    pair0 = d["pair"].clone()
    y, part = _outputs(d, accum, lanes)
    spmv_dot_direction(d["bands"], d["z"], d["pair"], d["beta"], d["k"],
                       offsets=d["offsets"], plane=plane, accum_dtype=accum,
                       out=(y, part), active=active, lanes=lanes)
    assert _same_bits(d["pair"], pair_u)
    assert _same_bits(y, y_u) and _same_bits(part, part_u)
    if not flag:
        assert _same_bits(d["pair"], pair0)
        assert bool((y == 7.0).all()) and bool((part == 7.0).all())


@pytest.mark.parametrize("storage,accum", PAIRS, ids=PAIR_IDS)
def test_first_direction_is_z_bit_for_bit(storage, accum):
    """At ``k == 0`` the new direction is ``z`` itself, even where ``z``
    holds -0.0, inf or NaN (``z + 0 * p`` would turn inf into NaN) and
    whatever ``beta`` and the old buffers hold; the SpMV+dot then reads
    those bits, as it would read them stored."""
    P, m, nx, plane = SHAPES[1]
    d = _inputs(P, m, nx, plane, storage, accum, 1, (0,))
    z = d["z"].reshape(-1)
    z[:6] = torch.tensor([-0.0, float("inf"), float("-inf"), float("nan"),
                          0.0, -0.0]).to(storage)
    d["pair"][0].reshape(-1)[:4] = float("inf")
    d["beta"] = torch.tensor(float("nan"), dtype=accum)
    new, y_w, part_w = spmv_dot_direction_plain(
        d["bands"], d["z"], d["pair"], d["beta"], d["k"],
        offsets=d["offsets"], plane=plane, accum_dtype=accum)
    assert _same_bits(new, d["z"])
    pair_u, y_u, part_u, _ = _unfused(d, storage, accum, 1, None)
    y, part = spmv_dot_direction(d["bands"], d["z"], d["pair"], d["beta"],
                                 d["k"], offsets=d["offsets"], plane=plane,
                                 accum_dtype=accum)
    assert _same_bits(d["pair"][1], d["z"])
    assert _same_bits(d["pair"], pair_u)
    assert _same_bits(y, y_u) and _same_bits(part, part_u)
    assert _same_bits(y, y_w) and _same_bits(part, part_w)


@pytest.mark.parametrize("storage,accum", PAIRS, ids=PAIR_IDS)
def test_loop_form_sums_the_partials_of_the_new_direction(storage, accum):
    """``fused_matvec_dot_direction_into`` on the CPU: the new direction in
    the pair, ``A p'`` and the ``p'.Ap'`` partials per lane as
    ``spmv_dot_partials_plain`` of that direction, under per-lane flags
    (lane 1 off: nothing of it written); ``cg_alpha``, the loop's next
    launch, sums each lane's partials in the tail kernels' tree."""
    P, m, nx, plane = SHAPES[2]
    lanes = 3
    d = _inputs(P, m, nx, plane, storage, accum, lanes, (1, 2, 0))
    active = torch.tensor([True, False, True])
    pair_u, _, _, new = _unfused(d, storage, accum, lanes, active)
    Ap = torch.full_like(d["z"], 7.0)
    pAp = torch.full((lanes,), 7.0, dtype=accum)
    part = partials_buffers(d["z"].numel(), accum, torch.device("cpu"),
                            lanes=lanes)
    part["dot"].fill_(7.0)
    fused_matvec_dot_direction_into(
        d["bands"], d["z"], d["pair"], d["beta"], d["k"], Ap, part,
        offsets=d["offsets"], plane=plane, accum_dtype=accum, active=active,
        lanes=lanes)
    npl, stride = part["npl"], part["stride"]
    torch_kl.cg_alpha(part["dot"], npl, stride, pAp, active=active)
    y_w, part_w = torch_kf.spmv_dot_partials_plain(
        d["bands"], new, offsets=d["offsets"], plane=plane,
        accum_dtype=accum, lanes=lanes)
    sums = torch_kl.lane_tree_sums_plain(part_w, npl, stride, lanes)
    assert _same_bits(d["pair"], pair_u)
    for lane in range(lanes):
        sl = slice(lane * P, (lane + 1) * P)
        run = slice(lane * stride, lane * stride + npl)
        on = bool(active[lane])
        assert _same_bits(Ap[sl], y_w[sl] if on
                          else torch.full_like(Ap[sl], 7.0))
        assert _same_bits(part["dot"][run], part_w[run] if on
                          else torch.full((npl,), 7.0, dtype=accum))
        assert _same_bits(pAp[lane], sums[lane] if on
                          else torch.tensor(7.0, dtype=accum))


@pytest.mark.parametrize("storage,accum", PAIRS, ids=PAIR_IDS)
def test_axpy_reads_the_direction_the_fold_wrote(storage, accum):
    """Given the counts ``k``, the in-place axpy reads each lane's buffer
    ``(k + 1) % 2`` of the pair: bitwise the axpy on that buffer."""
    P, m, nx, plane = SHAPES[2]
    lanes = 3
    d = _inputs(P, m, nx, plane, storage, accum, lanes, (0, 1, 6))
    rng = np.random.default_rng(4)

    def t():
        return torch.as_tensor(rng.standard_normal((lanes * P, m))).to(
            storage)

    x, r, Ap, inv = t(), t(), t(), t()
    alpha = torch.as_tensor(rng.random(lanes) + 0.1).to(accum)
    cur = current_direction(d["pair"], d["k"])
    for lane, k in enumerate(d["k"].tolist()):
        sl = slice(lane * P, (lane + 1) * P)
        assert torch.equal(cur[sl], d["pair"][(k + 1) % 2][sl])
    want = axpy_precond_partials_plain(x, r, cur, Ap, inv, alpha,
                                       accum_dtype=accum)
    _, stride = lane_partials(x.numel(), lanes)
    z = torch.empty_like(x)
    rz, rr = (torch.zeros(lanes * stride, dtype=accum) for _ in "ab")
    axpy_precond_inplace(x, r, d["pair"], Ap, inv, alpha, z, rz, rr,
                         accum_dtype=accum, lanes=lanes, k=d["k"])
    for got, w in zip((x, r, z, rz, rr), want):
        assert _same_bits(got, w)


def test_cg_advance_keeps_beta_only_while_active():
    """``beta <- gamma_new / gamma`` (before ``gamma`` moves) in the lanes
    whose flag is set; a stopped lane keeps its ``beta``.  The wrapper on
    CPU tensors is the plain version; without ``beta`` nothing else
    changes."""
    for fn in (cg_advance, cg_advance_plain):
        gamma = torch.tensor([2.0, 3.0, 5.0], dtype=torch.float64)
        gamma_new = torch.tensor([1.0, 4.0, 7.0], dtype=torch.float64)
        rr, rr_new = gamma.clone(), gamma_new.clone()
        k = torch.tensor([0, 3, 1], dtype=torch.int32)
        active = torch.tensor([True, False, True])
        beta = torch.full((3,), -9.0, dtype=torch.float64)
        thr = torch.full((3,), 0.5, dtype=torch.float64)
        fn(gamma, gamma_new, rr, rr_new, k, active, thr, 10, beta=beta)
        assert beta.tolist() == [0.5, -9.0, 7.0 / 5.0]
        assert gamma.tolist() == [1.0, 3.0, 7.0]
        assert k.tolist() == [1, 3, 2]
    sc = [torch.tensor(v, dtype=torch.float64) for v in (2.0, 1.0, 3.0, 4.0)]
    k, flag = torch.zeros((), dtype=torch.int32), torch.tensor(True)
    cg_advance(*sc, k, flag, torch.tensor(0.5, dtype=torch.float64), 9)
    assert [float(v) for v in sc] == [1.0, 1.0, 4.0, 4.0] and int(k) == 1


def test_direction_pair_buffers_start_on_16_bytes():
    """Each buffer of the pair is contiguous and 16-byte aligned, also for
    a row count whose bytes are not a multiple of 16."""
    for dtype, n in ((torch.float64, 777), (torch.float32, 2331),
                     (torch.bfloat16, 2331)):
        pair = direction_pair(torch.empty((3, n // 3), dtype=dtype))
        assert pair.shape == (2, 3, n // 3)
        for buf in pair:
            assert buf.is_contiguous() and buf.data_ptr() % 16 == 0


def test_fold_cost_counts_eleven_values_a_row():
    """88 / 44 / 22 B a row in f64 / f32 / bf16 at 7 bands, plus one
    partial per 256 rows."""
    n = 9_261_000
    for size, acc, per_row in ((8, 8, 88), (4, 4, 44), (2, 4, 22)):
        cost = spmv_dot_direction_cost(7, n, size, acc)
        assert cost["bytes_accessed"] == per_row * n + -(-n // 256) * acc


# ---------------------------------------------------------------------------
# the CG loop on the fold: one system and cohorts, against JAX and the host
# loop
# ---------------------------------------------------------------------------

def _lane_systems(lanes: int, rhs: tuple):
    """``lanes`` Laplacian systems on cube(4, 4) fused by 2 (lane ``l``'s
    diagonal raised by ``4 l``, so the lanes converge at different
    counts), each with its right-hand side kind in
    ``rhs`` ("rand", "point": one nonzero entry, "nan" or "zero"): per lane the JAX reference ops, the
    port's bands, diagonal and ``b``; and the offsets and plane."""
    mesh = JaxMesh.cube(4, 4)
    layout, buffers, diag = laplacian_buffers(mesh)
    buffers, diag = np.array(buffers), np.array(diag)
    n_c = mesh.n_parts // 2
    plan_j = jax_plan_for_mesh(mesh, 2)
    offsets = tuple(int(o) for o in plan_j.dia_offsets)
    plan = plan_for_mesh(CavityMesh.cube(4, 4), 2)
    rng = np.random.default_rng(11)
    out = []
    for lane in range(lanes):
        buf, dg = buffers.copy(), diag + 4.0 * lane
        buf[:, layout.segments()["diag"]] += 4.0 * lane
        bands_j = jax_update(plan_j, jnp.asarray(buf).reshape(n_c, 2, -1))
        diag_j = jnp.asarray(dg).reshape(n_c, -1)
        ops_j = jax_reference_ops(
            lambda v, bj=bands_j: jax_spmv_dia(bj, v, offsets=offsets,
                                               plane=plan_j.plane),
            jax_jacobi(diag_j))
        point = np.zeros(mesh.n_cells_global)
        point[5] = 1.0
        b = {"rand": rng.standard_normal(mesh.n_cells_global),
             "point": point,
             "nan": np.full(mesh.n_cells_global, np.nan),
             "zero": np.zeros(mesh.n_cells_global)}[rhs[lane]]
        bands = update_device_direct(
            plan, torch.as_tensor(buf).reshape(n_c, 2, -1))
        out.append({"ops_j": ops_j, "bands": bands,
                    "diag": torch.as_tensor(dg).reshape(n_c, -1),
                    "b": b.reshape(n_c, -1)})
    return out, offsets, plan.plane


def _ops(backend, bands, diag, offsets, plane, lanes=None):
    if backend == "fused":
        return fused_stacked_ops(bands, diag, offsets=offsets, plane=plane,
                                 lanes=lanes)
    return reference_ops(
        lambda v: spmv_dia(bands, v, offsets=offsets, plane=plane,
                           lanes=lanes or 1),
        jacobi_preconditioner(diag), lanes=lanes)


@pytest.fixture
def no_unfused_direction(monkeypatch):
    """The CG loop must not run the unfused direction update: its kernel
    wrapper and plain version raise."""
    def refuse(*args, **kwargs):
        raise AssertionError("the unfused cg_direction ran")
    monkeypatch.setattr(torch_kl, "cg_direction", refuse)
    monkeypatch.setattr(torch_kl, "cg_direction_plain", refuse)


@pytest.mark.parametrize("maxiter", [500, 5], ids=["converge", "cap"])
@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_cohort_cg_on_the_fold_matches_jax_and_solo_runs(
        backend, K, maxiter, monkeypatch, no_unfused_direction):
    """A cohort of four lanes (two right-hand sides that stop at different
    iterations, a NaN start and a converged start; every lane capped at 5
    iterations in the second case) on the block runner:
    each lane JAX's count and flags with ``x`` within 1e-10, bitwise its
    solo run, and the solo run bitwise the host loop.  Lanes freeze at
    different counts, so each keeps its own parity of the pair."""
    rhs = ("rand", "point", "nan", "zero")
    systems, offsets, plane = _lane_systems(len(rhs), rhs)
    monkeypatch.setattr(device_loop, "K", {"cg": K, "bicgstab": K})
    B = len(rhs)
    cohort = _ops(backend, torch.cat([s["bands"] for s in systems]),
                  torch.cat([s["diag"] for s in systems]), offsets, plane,
                  lanes=B)
    b_all = torch.cat([torch.as_tensor(s["b"]) for s in systems])
    res = cg(cohort, b_all, torch.zeros_like(b_all), tol=1e-10,
             maxiter=maxiter)
    rows = b_all.shape[0] // B
    for lane, s in enumerate(systems):
        sl = slice(lane * rows, (lane + 1) * rows)
        b = torch.as_tensor(s["b"])
        solo_ops = _ops(backend, s["bands"], s["diag"], offsets, plane)
        solo = cg(solo_ops, b, torch.zeros_like(b), tol=1e-10,
                  maxiter=maxiter)
        assert _same_bits(res.x[sl], solo.x)
        for f in ("iters", "converged", "hit_cap"):
            assert bool(getattr(res, f)[lane] == getattr(solo, f)), f
        res_j = jax_cg(s["ops_j"], jnp.asarray(s["b"]),
                       jnp.zeros_like(jnp.asarray(s["b"])), tol=1e-10,
                       maxiter=maxiter)
        assert int(solo.iters) == int(res_j.iters)
        assert bool(solo.converged) == bool(res_j.converged)
        assert bool(solo.hit_cap) == bool(res_j.hit_cap)
        if rhs[lane] == "nan":
            assert int(solo.iters) == 0 and not bool(solo.converged)
            continue
        np.testing.assert_allclose(solo.x.numpy(), np.asarray(res_j.x),
                                   rtol=0, atol=PARITY)
        with monkeypatch.context() as m:
            m.setattr(cg_mod, "_cg_sweep", cg_mod._cg_sweep_host)
            host = cg(_ops(backend, s["bands"], s["diag"], offsets, plane),
                      b, torch.zeros_like(b), tol=1e-10, maxiter=maxiter)
        assert _same_bits(solo.x, host.x)
        assert int(solo.iters) == int(host.iters)
    its = [int(i) for i in res.iters]
    if maxiter == 500:
        assert its[0] != its[1] and its[2:] == [0, 0]


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_loop_writes_both_buffers_and_never_the_unfused_update(
        backend, no_unfused_direction):
    """One sweep of three iterations: the body calls the fold's member once
    an iteration at the counts 0, 1, 2 (and the unfused update never); the
    pair ends holding the host loop's second and third directions, the
    newest in buffer ``k % 2``, and the carried ``beta`` is the one the
    host loop forms the fourth with."""
    (s,), offsets, plane = _lane_systems(1, ("rand",))
    ops = _ops(backend, s["bands"], s["diag"], offsets, plane)
    calls = []

    def counting(*args, member=ops.matvec_dot_direction_into):
        calls.append(int(args[3]))
        return member(*args)

    ops = dataclasses.replace(ops, matvec_dot_direction_into=counting)
    b = torch.as_tensor(s["b"])
    thr = torch.tensor(1e-30, dtype=torch.float64)
    _, _, k = cg_mod._cg_sweep(ops, b, torch.zeros_like(b), thr, 3)
    (st,) = ops.loops.values()
    assert int(k) == 3 and calls[:4] == [0, 1, 2, 3]
    # the host loop's directions, one per iteration
    r = b - ops.matvec(torch.zeros_like(b))
    p = ops.precond(r)
    (gamma,) = ops.dots((r, p))
    x, dirs = torch.zeros_like(b), [p]
    for _ in range(3):
        Ap, pAp = ops.matvec_dot(p)
        x, r, z, gamma_new, _ = ops.fused_step(x, r, p, Ap, gamma / pAp)
        beta = gamma_new / gamma
        p = z + beta.to(z.dtype) * p
        gamma = gamma_new
        dirs.append(p)
    assert _same_bits(st.p[0], dirs[1]) and _same_bits(st.p[1], dirs[2])
    assert _same_bits(st.beta, beta)


@pytest.mark.parametrize("cap", [5, 40])
@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_capped_refined_solve_on_the_fold_is_the_host_loop(backend, cap,
                                                           monkeypatch):
    """The whole ``f32_ir`` pressure solve of the cavity's first step
    (12³, 4 parts, alpha 2) with every inner sweep capped, so that passes
    restart the loop over the pair left by a capped sweep: counts, flags
    and ``x`` bitwise the host loop's."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.launch.case import build_parser, build_solver

    args = build_parser().parse_args(["--n", "12", "--parts", "4", "--alpha",
                                      "2", "--device", "cpu"])
    solver = build_solver(args)
    solver.solver_backend = backend
    bands, b, x0, diag = chip_smoke.pressure_system(
        solver, solver.initial_state(), 0.5 * solver.mesh.h)
    solver.precision = "f32_ir"
    ops = solver._solver_ops(solver.plan_p, bands, diag)
    res = cg(ops, b, x0, tol=1e-10, maxiter=cap)
    monkeypatch.setattr(cg_mod, "_cg_sweep", cg_mod._cg_sweep_host)
    host = cg(ops, b, x0, tol=1e-10, maxiter=cap)
    assert int(res.outer_iters) > 1 and bool(res.hit_cap) == (cap == 5)
    assert _same_bits(res.x, host.x)
    for f in ("iters", "outer_iters", "converged", "hit_cap"):
        assert int(getattr(res, f)) == int(getattr(host, f)), f
