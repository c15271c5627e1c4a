"""The instrumented executor, the rolled ``run`` and the device-side step
statistics of the port, on the CPU against the JAX package.

``SegregatedSolver.timed_step`` walks the serial phase list with a
timestamp at every phase boundary and returns ``(state, stats,
PhaseBreakdown)``: the state and stats must be the ones ``step`` gives,
bit for bit, with one breakdown per step billed to the phases' tags.
``run(n, dt, scan_steps=...)`` windows the run by ``roll_schedule``.  The
PISO runs on ``cube(8, 4)`` for alpha in {1, 2, 4} go through the device
loop and are held to JAX's serial run: within 1e-10, identical counts.
"""
import numpy as np
import pytest
import torch

from repro.core.cost_model import PhaseBreakdown as JaxPhaseBreakdown
from repro.fvm.mesh import CavityMesh as JaxMesh
from repro.fvm.piso import PisoSolver as JaxPisoSolver

from repro_torch.core.cost_model import PhaseBreakdown
from repro_torch.fvm.mesh import CavityMesh
from repro_torch.fvm.piso import PisoSolver, PisoState, make_solver
from repro_torch.fvm.step_program import PHASE_TAGS
from repro_torch.solvers import device_loop

PARITY = 1e-10
DT = 2e-4
ALPHAS = (1, 2, 4)


def _bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("program,case", [("piso", "cavity"),
                                          ("piso", "channel"),
                                          ("simple", "channel")])
def test_timed_step_is_step_bitwise(program, case):
    """Two steps by ``timed_step`` and by ``step`` from the same state: the
    same states and stats, one breakdown per step, every phase billed."""
    solver = make_solver(program, CavityMesh.cube(8, 4), alpha=2, case=case,
                         device="cpu")
    st_a = st_b = solver.initial_state()
    for _ in range(2):
        st_a, stats_a, pb = solver.timed_step(st_a, DT)
        st_b, stats_b = solver.step(st_b, DT)
        assert _bitwise(st_a, st_b) and _bitwise(stats_a, stats_b)
        assert isinstance(pb, PhaseBreakdown) and not pb.overlapped
        assert pb.halo == 0.0
        assert pb.assembly > 0 and pb.update > 0 and pb.solve > 0
        assert pb.total == pytest.approx(
            sum(getattr(pb, f) for f in PhaseBreakdown.TIME_FIELDS))
    assert solver._instrumented.calls == 2


def test_phase_breakdown_is_the_references():
    """The port's own copy: the same fields, total and imbalance as JAX's."""
    times = dict(assembly=0.3, update=0.02, halo=0.01, solve=1.7)
    ours, theirs = PhaseBreakdown(**times), JaxPhaseBreakdown(**times)
    assert PhaseBreakdown.TIME_FIELDS == JaxPhaseBreakdown.TIME_FIELDS
    assert PhaseBreakdown.TIME_FIELDS == PHASE_TAGS
    assert ours.total == theirs.total
    assert ours.imbalance == theirs.imbalance
    assert PhaseBreakdown(0, 0, 0, 0).imbalance == 0.0


def test_step_stats_stay_device_tensors():
    """The solvers' and the step's counts and flags are tensors (nothing
    in a step reads the device for them)."""
    solver = PisoSolver(CavityMesh.cube(8, 4), alpha=2, device="cpu")
    _, stats = solver.step(solver.initial_state(), DT)
    for f in stats._fields:
        assert isinstance(getattr(stats, f), torch.Tensor), f
    assert stats.mom_iters.dtype == stats.p_iters.dtype == torch.int32
    assert stats.converged.dtype == torch.bool


@pytest.fixture(scope="module")
def jax_runs():
    """{alpha: (final state, stats)} of JAX's serial 4-step run, numpy."""
    out = {}
    for alpha in ALPHAS:
        solver = JaxPisoSolver(JaxMesh.cube(8, 4), alpha=alpha,
                               solver_backend="reference", pipeline="off")
        state, stats = solver.run(4, DT, scan_steps=3)
        out[alpha] = tuple({f: np.asarray(getattr(t, f)) for f in t._fields}
                           for t in (state, stats))
    return out


@pytest.mark.parametrize("K", (3, 8))
@pytest.mark.parametrize("backend", ("reference", "fused"))
@pytest.mark.parametrize("alpha", ALPHAS)
def test_windowed_run_matches_jax(alpha, backend, K, jax_runs, monkeypatch):
    """``run(4, dt, scan_steps=3)`` (windows of 3 and 1 steps) through the
    device loop at K 3 and 8: within 1e-10 of JAX, identical counts and
    flags, and bitwise the one-window run."""
    monkeypatch.setattr(device_loop, "K", {"cg": K, "bicgstab": K})
    solver = PisoSolver(CavityMesh.cube(8, 4), alpha=alpha,
                        solver_backend=backend, device="cpu")
    state, stats = solver.run(4, DT, scan_steps=3)
    state1, stats1 = solver.run(4, DT)
    assert _bitwise(state, state1) and _bitwise(stats, stats1)
    state_j, stats_j = jax_runs[alpha]
    for f in PisoState._fields:
        a, b = getattr(state, f).numpy(), state_j[f]
        scale = max(float(np.abs(b).max()), 1e-300)
        assert float(np.abs(a - b).max()) <= PARITY * scale, f
    for f in ("mom_iters", "p_iters", "converged", "diverged", "hit_cap"):
        np.testing.assert_array_equal(getattr(stats, f).numpy(), stats_j[f],
                                      err_msg=f)
