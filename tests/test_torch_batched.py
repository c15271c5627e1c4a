"""Cohort-batched stepping in the port, on the CPU.

A cohort of lanes (same binding, per-lane dt and extras) through the
batched executors against each lane's solo run (bitwise: the same
operations per lane) and against JAX's ``BatchedExecutor`` (1e-10,
identical per-step counts); ``stack_states``/``unstack_states``;
``timed_step``'s rows; a NaN lane leaving its mates bitwise; a filler lane
(``n_active=0``); an ``f32_ir`` cohort's outer and inner counts against
solo solves; SIMPLE's ``run_converged`` per lane; and the plain lane
versions of the guarded kernels against one launch per lane.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.fvm.mesh import CavityMesh as JaxMesh
from repro.fvm.piso import PisoSolver as JaxPisoSolver
from repro.fvm.piso import stack_states as jax_stack_states

from repro_torch.core.cost_model import PhaseBreakdown
from repro_torch.fvm.mesh import CavityMesh, PaddedCavityMesh
from repro_torch.fvm.piso import (PisoSolver, PisoState, SimpleSolver,
                                  stack_states, unstack_states)
from repro_torch.fvm.step_program import (BatchedExecutor,
                                         BatchedPipelinedExecutor)
from repro_torch.interop import cohort_from_numpy, state_to_numpy
from repro_torch.kernels.krylov_fused.krylov_fused import (
    axpy_precond_partials_plain, fused_axpy_precond_plain, lane_partials,
    spmv_dot_partials_plain, spmv_dot_plain)
from repro_torch.kernels.krylov_loop.krylov_loop import (cg_advance_plain,
                                                         cg_direction_plain)
from repro_torch.kernels.spmv_dia.spmv_dia import (guarded_store,
                                                   spmv_dia_plain)
from repro_torch.solvers.bicgstab import bicgstab
from repro_torch.solvers.cg import cg
from repro_torch.solvers.device_loop import loop_records, reset_loop_records

PARITY = 1e-10
DTS = (2e-3, 2.2e-3, 2.4e-3)


def _dts(dts=DTS):
    return torch.tensor(dts, dtype=torch.float64)


def _solo(solver, dts=DTS, n=2, states=None):
    out = []
    for i, dt in enumerate(dts):
        st = solver.initial_state() if states is None else states[i]
        out.append(solver.run_steps(st, dt, n))
    return out


def _equal_states(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_stack_and_unstack():
    solver = PisoSolver(CavityMesh.cube(4, 2), alpha=2, device="cpu")
    s0 = solver.initial_state()
    s1 = PisoState(*(t + 1.0 for t in s0))
    st = stack_states([s0, s1])
    assert st.U.shape == (2,) + tuple(s0.U.shape)
    back = unstack_states(st)
    assert _equal_states(back[0], s0) and _equal_states(back[1], s1)
    padded = stack_states([s0, s1], pad_to=4)
    assert padded.p.shape[0] == 4 and not padded.U[2:].any()
    assert len(unstack_states(padded, 2)) == 2
    for bad in (lambda: stack_states([]),
                lambda: stack_states([s0, s1], pad_to=1),
                lambda: unstack_states(st, 3)):
        with pytest.raises(ValueError):
            bad()
    np_st = state_to_numpy(st)
    assert _equal_states(cohort_from_numpy(np_st, device="cpu"), st)
    with pytest.raises(ValueError):
        cohort_from_numpy(state_to_numpy(s0), device="cpu")


@pytest.fixture(scope="module")
def jax_cohort():
    jsolver = JaxPisoSolver(JaxMesh.cube(4, 2), alpha=2,
                            solver_backend="reference", pipeline="off")
    exe = jsolver.batched_executor(3)
    states = jax_stack_states([jsolver.initial_state() for _ in DTS])
    states, stats = exe.run_steps(states, jnp.asarray(DTS), 2)
    return ({f: np.asarray(getattr(states, f)) for f in states._fields},
            {f: np.asarray(getattr(stats, f)) for f in stats._fields})


def test_batched_matches_solo_and_jax(jax_cohort):
    state_j, stats_j = jax_cohort
    solver = PisoSolver(CavityMesh.cube(4, 2), alpha=2, device="cpu",
                        pipeline="off")
    exe = solver.batched_executor(3)
    assert isinstance(exe, BatchedExecutor)
    assert solver.batched_executor(3) is exe
    reset_loop_records()
    states = stack_states([solver.initial_state() for _ in DTS])
    states, stats = exe.run_steps(states, _dts(), 2)
    assert exe.dispatches == 1
    assert {r.lanes for r in loop_records()} == {3}
    assert stats.p_iters.shape == (2, 3, 2) and stats.mom_iters.shape == (
        2, 3)
    solo = _solo(solver)
    for i, (st, sst) in enumerate(solo):
        assert _equal_states(unstack_states(states)[i], st)
        for f in sst._fields:
            assert torch.equal(getattr(stats, f)[:, i], getattr(sst, f)), f
    got = state_to_numpy(states)
    for f, b in state_j.items():
        a = got[f]
        assert a.shape == b.shape
        assert float(np.abs(a - b).max()) <= PARITY * max(
            float(np.abs(b).max()), 1e-300), f
    for f in ("mom_iters", "p_iters", "converged", "diverged", "hit_cap"):
        np.testing.assert_array_equal(getattr(stats, f).numpy(), stats_j[f])


def test_pipelined_cohort_is_each_lanes_pipelined_run():
    solver = PisoSolver(CavityMesh.cube(4, 2), alpha=2, device="cpu")
    exe = solver.batched_executor(3)
    assert isinstance(exe, BatchedPipelinedExecutor)
    states = stack_states([solver.initial_state() for _ in DTS])
    out, stats = exe.run_steps(states, _dts(), 2)
    for i, (st, sst) in enumerate(_solo(solver)):
        assert _equal_states(unstack_states(out)[i], st)
        assert torch.equal(stats.p_iters[:, i], sst.p_iters)
    one, one_stats = exe.step(stack_states([solver.initial_state()] * 3),
                              _dts())
    assert one_stats.mom_iters.shape == (3,)


def test_timed_step_rows():
    solver = PisoSolver(CavityMesh.cube(4, 2), alpha=2, device="cpu")
    exe = solver.batched_executor(3)
    states = stack_states([solver.initial_state() for _ in DTS])
    st, stats, rows = exe.timed_step(states, _dts())
    assert exe.samples == 1 and len(rows) == 3
    assert all(isinstance(r, PhaseBreakdown) and not r.overlapped
               for r in rows)
    assert rows[0] == rows[1] == rows[2] and rows[0].total > 0
    ref, ref_stats = exe.step(stack_states([solver.initial_state()] * 3),
                              _dts())
    assert _equal_states(st, ref)
    assert torch.equal(stats.p_iters, ref_stats.p_iters)


def test_a_nan_lane_leaves_its_mates_bitwise():
    solver = PisoSolver(CavityMesh.cube(4, 2), alpha=2, device="cpu")
    starts, _ = zip(*_solo(solver, n=1))
    starts = list(starts)
    poisoned = PisoState(*(t.clone() for t in starts[1]))
    poisoned.U[0, 0, 0] = float("nan")
    states = stack_states([starts[0], poisoned, starts[2]])
    out, stats = solver.batched_executor(3).run_steps(states, _dts(), 2)
    solo = _solo(solver, states=starts)
    for i in (0, 2):
        assert _equal_states(unstack_states(out)[i], solo[i][0])
        assert torch.equal(stats.p_iters[:, i], solo[i][1].p_iters)
    assert bool(stats.diverged[-1, 1]) and not bool(stats.converged[-1, 1])
    assert not bool(stats.diverged[:, 0].any())


def test_a_filler_lane_changes_nothing():
    mesh = PaddedCavityMesh.pad(CavityMesh(nx=4, ny=4, nz=4, n_parts=2,
                                           h=0.025), 4)
    solver = PisoSolver(mesh, alpha=1, device="cpu")
    exe = solver.batched_executor(3)
    states = stack_states([solver.initial_state()] * 2, pad_to=3)
    extras = solver.lane_extras([solver._extras()] * 2
                                + [solver._filler_extras()])
    assert extras[0].tolist() == [2, 2, 0]
    dts = (2e-3, 2.2e-3, 2e-3)
    out, stats = exe.run_steps(states, _dts(dts), 2, *extras)
    for i, (st, sst) in enumerate(_solo(solver, dts[:2])):
        assert _equal_states(unstack_states(out)[i], st)
        assert torch.equal(stats.p_iters[:, i], sst.p_iters)
    assert not any(t[2].any() for t in out)
    assert not stats.p_iters[:, 2].any() and not stats.mom_iters[:, 2].any()
    assert bool(stats.converged[:, 2].all())


def test_cohort_shape_errors():
    solver = PisoSolver(CavityMesh.cube(4, 2), alpha=2, device="cpu")
    exe = solver.batched_executor(3)
    states = stack_states([solver.initial_state()] * 2)
    with pytest.raises(ValueError, match="cohort shape"):
        exe.run_steps(states, _dts(DTS[:2]), 1)
    with pytest.raises(ValueError, match="cohort shape"):
        exe.step(stack_states([solver.initial_state()] * 3), _dts(DTS[:2]))
    with pytest.raises(ValueError, match="batch"):
        BatchedExecutor(solver.program, 0)
    padded = PisoSolver(PaddedCavityMesh.pad(CavityMesh.cube(4, 2), 4),
                        alpha=1, device="cpu")
    with pytest.raises(ValueError, match="session axis"):
        padded.batched_executor(3).step(
            stack_states([padded.initial_state()] * 3), _dts(),
            torch.tensor(2, dtype=torch.int32))


def _system(seed, lanes, policy="f64"):
    """A stacked SPD pressure-like system of the 4^3 cavity per lane."""
    solver = PisoSolver(CavityMesh.cube(4, 2), alpha=2, device="cpu",
                        precision=policy)
    rng = np.random.default_rng(seed)
    st = solver.initial_state()
    U = torch.tensor(rng.standard_normal(tuple(st.U.shape)) * 0.1)
    sysM = solver.asm.assemble_momentum(U, st.phi, st.phi_if, st.p, 2e-3)
    bands = solver._bands(solver.plan_mom, sysM.diag, sysM.upper,
                          sysM.lower, sysM.iface)
    return solver, bands, sysM.diag, torch.tensor(
        rng.standard_normal(tuple(st.p.shape)))


@pytest.mark.parametrize("policy", ["f32_ir", "bf16_ir"])
def test_refined_cohort_counts_are_the_solo_counts(policy):
    """Under a refined policy each lane's outer and inner counts (and
    iterate) are its solo solve's, also when the lanes end at different
    outer passes."""
    systems = [_system(s, 1, policy) for s in range(3)]
    solver = systems[0][0]
    bands = torch.cat([s[1] for s in systems])
    diag = torch.cat([s[2] for s in systems])
    b = torch.cat([s[3] * (10.0 ** -i) for i, s in enumerate(systems)])
    ops = solver._solver_ops(solver.plan_mom, bands, diag, lanes=3)
    for solve, tol in ((bicgstab, 1e-9), (cg, 1e-9)):
        res = solve(ops, b, torch.zeros_like(b), tol=tol, maxiter=300)
        assert res.iters.shape == res.outer_iters.shape == (3,)
        P = b.shape[0] // 3
        for i, (s, bb, dg, _) in enumerate(systems):
            ops1 = s._solver_ops(s.plan_mom, bb, dg)
            bi = b[i * P:(i + 1) * P]
            one = solve(ops1, bi, torch.zeros_like(bi), tol=tol, maxiter=300)
            assert int(res.outer_iters[i]) == int(one.outer_iters)
            assert int(res.iters[i]) == int(one.iters)
            assert bool(res.converged[i]) == bool(one.converged)
            assert torch.equal(res.x[i * P:(i + 1) * P], one.x)


def test_f32_ir_piso_cohort_is_each_lanes_run():
    solver = PisoSolver(CavityMesh.cube(4, 2), alpha=2, device="cpu",
                        precision="f32_ir")
    states = stack_states([solver.initial_state() for _ in DTS])
    out, stats = solver.batched_executor(3).run_steps(states, _dts(), 2)
    for i, (st, sst) in enumerate(_solo(solver)):
        assert _equal_states(unstack_states(out)[i], st)
        assert torch.equal(stats.p_iters[:, i], sst.p_iters)
        assert torch.equal(stats.mom_iters[:, i], sst.mom_iters)


def test_simple_cohort_converges_each_lane_as_alone():
    mesh = CavityMesh.cube(4, 2)
    relax = [(0.7, 0.3), (0.5, 0.2)]
    solos = []
    for ru, rp in relax:
        s = SimpleSolver(mesh, alpha=2, device="cpu", relax_u=ru, relax_p=rp,
                         tol_continuity=1e-4, tol_u=1e-4)
        solos.append(s.run_steady(max_outer=40))
    solver = SimpleSolver(mesh, alpha=2, device="cpu", tol_continuity=1e-4,
                          tol_u=1e-4)
    exe = solver.batched_executor(2)
    states = stack_states([solver.initial_state()] * 2)
    extras = solver.lane_extras(relax)
    out, stats, n_outer = exe.run_converged(states, _dts(DTS[:2]), 40,
                                            *extras)
    for i, (st, sst, n) in enumerate(solos):
        assert int(n_outer[i]) == n
        assert _equal_states(unstack_states(out)[i], st)
        assert torch.equal(stats.p_iters[i], sst.p_iters)


def _lane_data(lanes, P=2, m=40, plane=8, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.tensor(rng.random(shape) + 0.5)

    return {"bands": t(lanes * P, 7, m), "x": t(lanes * P, m),
            "r": t(lanes * P, m), "p": t(lanes * P, m),
            "Ap": t(lanes * P, m), "inv": t(lanes * P, m),
            "alpha": t(lanes), "g": t(lanes), "g_new": t(lanes),
            "offsets": (-plane, -4, -1, 0, 1, 4, plane), "plane": plane,
            "P": P}


def _lane(d, i, lanes):
    P = d["P"]
    return {k: (v[i * P:(i + 1) * P] if torch.is_tensor(v) and v.dim() > 1
                else v[i:i + 1] if torch.is_tensor(v) else v)
            for k, v in d.items()}


def test_plain_lane_versions_are_one_launch_per_lane():
    B = 3
    d = _lane_data(B)
    kw = dict(offsets=d["offsets"], plane=d["plane"])
    y = spmv_dia_plain(d["bands"], d["x"], lanes=B, **kw)
    yd, part = spmv_dot_partials_plain(d["bands"], d["x"], lanes=B, **kw)
    _, dots = spmv_dot_plain(d["bands"], d["x"], lanes=B, **kw)
    ax = axpy_precond_partials_plain(d["x"], d["r"], d["p"], d["Ap"],
                                     d["inv"], d["alpha"])
    axd = fused_axpy_precond_plain(d["x"], d["r"], d["p"], d["Ap"],
                                   d["inv"], d["alpha"])
    pd = cg_direction_plain(d["p"].clone(), d["x"], d["g_new"], d["g"])
    npl, stride = lane_partials(d["x"].numel(), B)
    assert part.shape == (B * stride,) and dots.shape == (B,)
    for i in range(B):
        e = _lane(d, i, B)
        sl = slice(i * d["P"], (i + 1) * d["P"])
        assert torch.equal(y[sl], spmv_dia_plain(e["bands"], e["x"], **kw))
        one_y, one_part = spmv_dot_partials_plain(e["bands"], e["x"], **kw)
        assert torch.equal(yd[sl], one_y)
        assert torch.equal(part[i * stride:i * stride + npl], one_part)
        assert torch.equal(dots[i], spmv_dot_plain(e["bands"], e["x"],
                                                   **kw)[1])
        one = axpy_precond_partials_plain(e["x"], e["r"], e["p"], e["Ap"],
                                          e["inv"], e["alpha"][0])
        for k in range(3):
            assert torch.equal(ax[k][sl], one[k])
        for k in (3, 4):
            assert torch.equal(ax[k][i * stride:i * stride + npl], one[k])
        onedots = fused_axpy_precond_plain(e["x"], e["r"], e["p"], e["Ap"],
                                           e["inv"], e["alpha"][0])
        assert torch.equal(axd[3][i], onedots[3])
        assert torch.equal(axd[4][i], onedots[4])
        assert torch.equal(pd[sl], cg_direction_plain(
            e["p"].clone(), e["x"], e["g_new"], e["g"]))
    # per-lane guards: lane 1 off is left as it was
    flags = torch.tensor([True, False, True])
    out = torch.full_like(d["x"], 7.0)
    guarded_store(out, y, flags)
    assert torch.equal(out[2:4], torch.full_like(out[2:4], 7.0))
    assert torch.equal(out[:2], y[:2]) and torch.equal(out[4:], y[4:])
    sc = [d["g"].clone(), d["g_new"].clone(), d["g"] * 3, d["g_new"].clone(),
          torch.zeros(B, dtype=torch.int32), flags.clone(), d["g"] * 0.1]
    cg_advance_plain(*sc, 5)
    assert sc[4].tolist() == [1, 0, 1]
    assert torch.equal(sc[0][1], d["g"][1]) and torch.equal(sc[0][0],
                                                             d["g_new"][0])


def test_loop_records_count_the_longest_lane():
    systems = [_system(s, 1) for s in range(2)]
    solver = systems[0][0]
    bands = torch.cat([s[1] for s in systems])
    diag = torch.cat([s[2] for s in systems])
    b = torch.cat([systems[0][3], systems[1][3] * 0])
    ops = solver._solver_ops(solver.plan_mom, bands, diag, lanes=2)
    reset_loop_records()
    res = cg(ops, b, torch.zeros_like(b), tol=1e-10, maxiter=200)
    (rec,) = loop_records()
    assert rec.lanes == 2 and rec.iters == int(res.iters.max())
    assert int(res.iters[1]) == 0 and bool(res.converged[1])
    dataclasses.replace(rec)  # a record is a plain frozen dataclass
