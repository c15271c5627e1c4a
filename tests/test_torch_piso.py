"""The port's main path end to end against the JAX package, on the CPU.

JAX runs ``PisoSolver(solver_backend="reference", pipeline="off")`` — the
serial schedule the port implements — once per alpha (module-scoped
fixtures); the port runs both its backends from the same initial state.
The bar: states within 1e-10, identical Krylov counts and flags.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.repartition import plan_for_mesh as jax_plan_for_mesh
from repro.fvm.mesh import CavityMesh as JaxMesh
from repro.fvm.piso import PisoSolver as JaxPisoSolver

from repro_torch.core.repartition import plan_for_mesh
from repro_torch.fvm.mesh import CavityMesh
from repro_torch.fvm.piso import PisoSolver, PisoState
from repro_torch.interop import (plan_from_numpy, state_from_numpy,
                                 state_to_numpy)
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch.case import main as launch_main

PARITY = 1e-10
DT = 2e-4
N_STEPS = 3
ALPHAS = (1, 2, 4)


def _jax_solver(alpha):
    return JaxPisoSolver(JaxMesh.cube(8, 4), alpha=alpha,
                         solver_backend="reference", pipeline="off")


def _jax_numpy(tree):
    return {f: np.asarray(getattr(tree, f)) for f in tree._fields}


@pytest.fixture(scope="module")
def jax_runs():
    """{alpha: (solver, final state, stats)} as numpy — one JAX run each."""
    out = {}
    for alpha in ALPHAS:
        solver = _jax_solver(alpha)
        state, stats = solver.run(N_STEPS, DT)
        out[alpha] = (solver, _jax_numpy(state), _jax_numpy(stats))
    return out


@pytest.fixture(scope="module")
def jax_continued(jax_runs):
    """Two more JAX steps from the alpha=2 run's final state (numpy)."""
    solver, state, _ = jax_runs[2]
    start = type(solver.initial_state())(
        *(jnp.asarray(state[f]) for f in solver.initial_state()._fields))
    state2, stats2 = solver.run_steps(start, DT, 2)
    return _jax_numpy(state2), _jax_numpy(stats2)


def _assert_states_close(state_t: PisoState, state_j: dict):
    for f in PisoState._fields:
        a, b = getattr(state_t, f).numpy(), state_j[f]
        assert a.shape == b.shape, f
        scale = max(float(np.abs(b).max()), 1e-300)
        assert float(np.abs(a - b).max()) <= PARITY * scale, f


def _assert_stats_equal(stats_t, stats_j: dict):
    for f in ("mom_iters", "p_iters", "converged", "diverged", "hit_cap"):
        np.testing.assert_array_equal(getattr(stats_t, f).numpy(),
                                      stats_j[f], err_msg=f)
    np.testing.assert_allclose(stats_t.continuity_err.numpy(),
                               stats_j["continuity_err"], rtol=1e-6,
                               atol=1e-12)


@pytest.mark.parametrize("alpha", ALPHAS)
def test_plan_matches_jax(alpha):
    mesh = CavityMesh.cube(8, 4)
    plan = plan_for_mesh(mesh, alpha)
    plan_j = jax_plan_for_mesh(JaxMesh.cube(8, 4), alpha)
    np.testing.assert_array_equal(plan.dia_offsets, plan_j.dia_offsets)
    np.testing.assert_array_equal(plan.dia_src, plan_j.dia_src)
    np.testing.assert_array_equal(plan.ell_src, plan_j.ell_src)
    np.testing.assert_array_equal(plan.ell_cols, plan_j.ell_cols)
    for f in ("alpha", "m_fine", "m_coarse", "plane", "buffer_len", "K",
              "nnz_local", "nnz_localized", "nnz_halo"):
        assert getattr(plan, f) == getattr(plan_j, f), f
    # the same plan rebuilt from the JAX plan's arrays
    ints = ("alpha", "m_fine", "m_coarse", "plane", "buffer_len",
            "nnz_local", "nnz_localized", "nnz_halo")
    rebuilt = plan_from_numpy({f: getattr(plan_j, f)
                               for f in ints + ("dia_offsets", "dia_src")})
    assert all(getattr(rebuilt, f) == getattr(plan, f) for f in ints)
    np.testing.assert_array_equal(rebuilt.dia_src, plan.dia_src)
    np.testing.assert_array_equal(rebuilt.dia_offsets, plan.dia_offsets)


@pytest.mark.parametrize("alpha", ALPHAS)
def test_bands_match_jax(alpha, jax_runs):
    """``_bands`` (buffer_from_parts + the dia_src gather) on random LDU
    coefficients."""
    solver_j = jax_runs[alpha][0]
    solver = PisoSolver(CavityMesh.cube(8, 4), alpha=alpha, device="cpu")
    mesh = solver.mesh
    rng = np.random.default_rng(alpha)
    P, m, F, B = mesh.n_parts, mesh.n_cells, mesh.n_faces, mesh.plane
    ldu = [rng.standard_normal(s) for s in ((P, m), (P, F), (P, F),
                                            (P, 2, B))]
    staged = PisoSolver(CavityMesh.cube(8, 4), alpha=alpha, device="cpu",
                        update_schedule="host_buffer")
    for plan, plan_j in ((solver.plan_mom, solver_j.plan_mom),
                         (solver.plan_p, solver_j.plan_p)):
        got = solver._bands(plan, *(torch.as_tensor(a) for a in ldu))
        want = np.asarray(solver_j._bands(plan_j,
                                          *(jnp.asarray(a) for a in ldu)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    # the staged (host-buffer) schedule moves the same values
    got = staged._bands(staged.plan_p, *(torch.as_tensor(a) for a in ldu))
    assert torch.equal(got, solver._bands(solver.plan_p,
                                          *(torch.as_tensor(a) for a in ldu)))


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("alpha", ALPHAS)
def test_piso_steps_match_jax(alpha, backend, jax_runs):
    _, state_j, stats_j = jax_runs[alpha]
    solver = PisoSolver(CavityMesh.cube(8, 4), alpha=alpha,
                        solver_backend=backend, device="cpu")
    reset_launch_counts()
    state, stats = solver.run(N_STEPS, DT)
    # on the CPU the fused backend runs the kernels' plain versions
    assert set(launch_counts().values()) == {0}
    assert stats.p_iters.shape == (N_STEPS, solver.n_correctors)
    assert bool(stats.converged.all()) and not bool(stats.diverged.any())
    _assert_states_close(state, state_j)
    _assert_stats_equal(stats, stats_j)


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_steps_from_a_jax_developed_state(backend, jax_runs, jax_continued):
    """Carry JAX's state after 3 steps into the port and step both on."""
    state_j = jax_runs[2][1]
    state_j2, stats_j2 = jax_continued
    solver = PisoSolver(CavityMesh.cube(8, 4), alpha=2,
                        solver_backend=backend, device="cpu")
    start = state_from_numpy(state_j, device="cpu")
    assert all(t.dtype == torch.float64 for t in start)
    state, stats = solver.run_steps(start, DT, 2)
    _assert_states_close(state, state_j2)
    _assert_stats_equal(stats, stats_j2)
    back = state_to_numpy(state)
    assert set(back) == set(PisoState._fields)
    assert all(isinstance(v, np.ndarray) for v in back.values())


def test_non_finite_state_is_flagged_diverged():
    solver = PisoSolver(CavityMesh.cube(4, 2), alpha=2, device="cpu")
    state = solver.initial_state()
    U = state.U.clone()
    U[0, 0, 0] = float("nan")
    state, stats = solver.step(state._replace(U=U), DT)
    assert bool(stats.diverged) and not bool(stats.converged)
    assert not bool(stats.hit_cap)


def test_launcher_runs_on_the_cpu(capsys):
    state, stats = launch_main(["--n", "4", "--parts", "2", "--alpha", "2",
                                "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 0:" in out and "step 1:" in out and "2 steps in" in out
    assert state.U.shape == (2, 32, 3) and state.U.device.type == "cpu"
    assert bool(stats.converged.all())
    assert float(stats.continuity_err.max()) < 1e-6


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal needs its absence")
    with pytest.raises(RuntimeError, match="cuda"):
        PisoSolver(CavityMesh.cube(4, 2), alpha=2)
    with pytest.raises(RuntimeError, match="cuda"):
        state_from_numpy({f: np.zeros(1) for f in PisoState._fields})
