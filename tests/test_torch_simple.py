"""The port's SIMPLE program, program registry and inlet/outlet cases against
the JAX package, on the CPU.

JAX runs ``solver_backend="reference"`` and ``pipeline="off"`` (the serial
schedule the port implements); the port runs its reference backend unless a
test says otherwise.  The bar: states within 1e-10 of each field's max,
identical outer and Krylov counts, equal flags.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.fvm.assembly import CavityAssembly as JaxAssembly
from repro.fvm.cases import case_names as jax_case_names
from repro.fvm.mesh import CavityMesh as JaxMesh
from repro.fvm.piso import PisoSolver as JaxPisoSolver
from repro.fvm.piso import SimpleSolver as JaxSimpleSolver
from repro.fvm.step_program import get_program as jax_get_program
from repro.fvm.step_program import program_names as jax_program_names

from repro_torch.fvm.assembly import CavityAssembly
from repro_torch.fvm.cases import case_names
from repro_torch.fvm.mesh import CavityMesh
from repro_torch.fvm.piso import (PisoSolver, PisoState, SimpleSolver,
                                  make_solver)
from repro_torch.fvm.simple import SimpleStats
from repro_torch.fvm.step_program import (Phase, SerialExecutor,
                                          StepProgram, get_program,
                                          program_names)
from repro_torch.launch.case import main as launch_main

PARITY = 1e-10
DT = 2e-4
IO_CASES = ("channel", "backstep")


def _jax_numpy(tree):
    return {f: np.asarray(getattr(tree, f)) for f in tree._fields}


def _assert_states_close(state, state_j: dict, bar=PARITY):
    for f in PisoState._fields:
        a, b = getattr(state, f).numpy(), state_j[f]
        assert a.shape == b.shape, f
        scale = max(float(np.abs(b).max()), 1e-300)
        assert float(np.abs(a - b).max()) <= bar * scale, f


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

def test_registry_names_match_jax():
    assert program_names() == jax_program_names()
    assert case_names() == tuple(jax_case_names())
    for name in program_names():
        assert get_program(name).transient == jax_get_program(name).transient
    with pytest.raises(KeyError, match="nope"):
        get_program("nope")
    with pytest.raises(KeyError, match="nope"):
        make_solver("nope", CavityMesh.cube(4, 2), device="cpu")
    assert isinstance(make_solver("simple", CavityMesh.cube(4, 2), alpha=2,
                                  device="cpu"), SimpleSolver)


def test_run_converged_semantics():
    """The first step always runs; then the loop steps while under the
    cap and unconverged.  A program without a predicate is refused."""
    def seed(state, dt, target):
        return {"x": state, "target": target}

    def finalize(env):
        return env["x"], env["x"]

    prog = StepProgram(
        phases=(Phase("inc", "assembly", ("x",), ("x",), lambda x: x + 1),),
        seed=seed, finalize=finalize, seed_keys=("x", "target"),
        extra_keys=("target",), converged=lambda x: x >= 3)
    ex = SerialExecutor(prog)
    assert ex.run_converged(torch.tensor(0), 1.0, 10, 3)[2] == 3
    assert ex.run_converged(torch.tensor(0), 1.0, 2, 3)[2] == 2
    assert ex.run_converged(torch.tensor(7), 1.0, 10, 3)[2] == 1
    with pytest.raises(ValueError, match="max_iters"):
        ex.run_converged(torch.tensor(0), 1.0, 0, 3)
    no_pred = StepProgram(phases=prog.phases, seed=seed, finalize=finalize,
                          seed_keys=("x", "target"))
    with pytest.raises(ValueError, match="converg"):
        SerialExecutor(no_pred).run_converged(torch.tensor(0), 1.0, 5, 3)


def test_piso_refuses_run_steady():
    solver = PisoSolver(CavityMesh.cube(4, 2), alpha=2, device="cpu")
    assert solver.program.converged is None
    assert solver.program.extra_keys == ()
    with pytest.raises(ValueError):
        solver.run_steady()


# ---------------------------------------------------------------------------
# the inlet/outlet assembly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ("cavity",) + IO_CASES)
def test_case_assembly_matches_jax(case):
    """Every boundary branch on random fields, against JAX's assembly."""
    asm_j = JaxAssembly(JaxMesh.cube(8, 4), case=case)
    asm = CavityAssembly(CavityMesh.cube(8, 4), case=case, device="cpu")
    rng = np.random.default_rng(3)
    P, m = 4, 128
    U, p = rng.standard_normal((P, m, 3)), rng.standard_normal((P, m))
    rAU = 1.0 + rng.random((P, m))
    U_j, p_j, rAU_j = (jnp.asarray(a) for a in (U, p, rAU))
    U_t, p_t, rAU_t = (torch.as_tensor(a) for a in (U, p, rAU))
    pairs = {}
    phi_j, phi_if_j = asm_j.face_flux(U_j)
    phi_b_j = asm_j.boundary_flux(U_j)
    phi_t, phi_if_t = asm.face_flux(U_t)
    phi_b_t = asm.boundary_flux(U_t)
    pairs["phi_b"] = (phi_b_t, phi_b_j)
    pairs["grad"] = (asm.grad(p_t), asm_j.grad(p_j))
    M_j = asm_j.assemble_momentum(U_j, phi_j, phi_if_j, p_j, DT,
                                  phi_b=phi_b_j)
    M_t = asm.assemble_momentum(U_t, phi_t, phi_if_t, p_t, DT, phi_b=phi_b_t)
    for f in ("diag", "upper", "lower", "iface", "source"):
        pairs[f"mom.{f}"] = (getattr(M_t, f), getattr(M_j, f))
    S_j = asm_j.assemble_pressure(rAU_j, phi_j, phi_if_j, phi_b_j)
    S_t = asm.assemble_pressure(rAU_t, phi_t, phi_if_t, phi_b_t)
    for f in ("diag", "upper", "lower", "iface", "source", "g_b"):
        pairs[f"p.{f}"] = (getattr(S_t, f), getattr(S_j, f))
    pairs["phi_b corrected"] = (asm.correct_boundary_flux(S_t, phi_b_t, p_t),
                                asm_j.correct_boundary_flux(S_j, phi_b_j,
                                                            p_j))
    for name, (a, b) in pairs.items():
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13,
                                   atol=0, err_msg=name)
    has_outlet = case != "cavity"
    assert bool((S_t.g_b != 0).any()) == has_outlet
    assert bool((phi_b_t != 0).any()) == has_outlet


# ---------------------------------------------------------------------------
# PISO on the inlet/outlet cases
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_io_runs():
    """{(case, alpha): (state, stats)} of JAX's PISO, 3 steps at tolerances
    1e-12 (so that the parity is not the solver tolerance)."""
    out = {}
    for case in IO_CASES:
        for alpha in (1, 2, 4):
            solver = JaxPisoSolver(JaxMesh.cube(8, 4), alpha=alpha,
                                   case=case, mom_tol=1e-12, p_tol=1e-12,
                                   solver_backend="reference",
                                   pipeline="off")
            state, stats = solver.run(3, DT)
            out[case, alpha] = (_jax_numpy(state), _jax_numpy(stats))
    return out


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("alpha", [1, 2, 4])
@pytest.mark.parametrize("case", IO_CASES)
def test_io_case_piso_matches_jax(case, alpha, backend, jax_io_runs):
    state_j, stats_j = jax_io_runs[case, alpha]
    solver = PisoSolver(CavityMesh.cube(8, 4), alpha=alpha, case=case,
                        mom_tol=1e-12, p_tol=1e-12, solver_backend=backend,
                        device="cpu")
    state, stats = solver.run(3, DT)
    assert bool(stats.converged.all())
    _assert_states_close(state, state_j)
    for f in ("mom_iters", "p_iters", "converged", "diverged", "hit_cap"):
        np.testing.assert_array_equal(getattr(stats, f).numpy(), stats_j[f],
                                      err_msg=f)


# ---------------------------------------------------------------------------
# SIMPLE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_steady():
    """{case: (state, stats, n_outer)} of JAX's SimpleSolver on cube(4, 2),
    alpha 2, to convergence."""
    out = {}
    for case in ("cavity", "channel"):
        solver = JaxSimpleSolver(JaxMesh.cube(4, 2), alpha=2, nu=0.01,
                                 case=case, solver_backend="reference",
                                 pipeline="off")
        state, stats, n = solver.run_steady()
        out[case] = (_jax_numpy(state), _jax_numpy(stats), int(n))
    return out


@pytest.fixture(scope="module")
def port_steady():
    out = {}
    for case in ("cavity", "channel"):
        solver = SimpleSolver(CavityMesh.cube(4, 2), alpha=2, nu=0.01,
                              case=case, device="cpu")
        out[case] = (solver, *solver.run_steady())
    return out


@pytest.mark.parametrize("case", ["cavity", "channel"])
def test_run_steady_matches_jax(case, jax_steady, port_steady):
    state_j, stats_j, n_j = jax_steady[case]
    solver, state, stats, n = port_steady[case]
    assert isinstance(stats, SimpleStats)
    assert n == n_j and 1 < n < solver.max_outer
    assert bool(solver.program.converged(stats))
    assert float(stats.continuity_err) < solver.tol_continuity
    assert float(stats.u_delta) < solver.tol_u
    _assert_states_close(state, state_j)
    for f in ("mom_iters", "p_iters", "converged", "diverged", "hit_cap"):
        np.testing.assert_array_equal(getattr(stats, f).numpy(), stats_j[f],
                                      err_msg=f)


def test_run_steady_respects_the_cap(port_steady):
    solver = port_steady["cavity"][0]
    _, stats5, n5 = solver.run_steady(max_outer=5)
    assert n5 == 5
    assert not bool(solver.program.converged(stats5))
    assert bool(stats5.converged)  # every Krylov solve met its tolerance


def test_simple_channel_conserves_mass(port_steady):
    """At convergence the outlet carries the prescribed inflow: the net
    boundary flux vanishes to the pressure solve's residual scale."""
    solver, state = port_steady["channel"][:2]
    net = float(state.phi_b.sum())
    inflow = 4 * 4 * solver.mesh.h ** 2
    assert abs(net) < 1e-8 * inflow
    assert float(state.phi_b.clamp_min(0.0).sum()) > 0.5 * inflow


def test_simple_steps_on_the_fused_backend_as_on_the_reference():
    """Two outer iterations of the channel on each backend from one
    state: within 1e-10, identical counts."""
    runs = {}
    for backend in ("reference", "fused"):
        solver = SimpleSolver(CavityMesh.cube(8, 4), alpha=2, case="channel",
                              solver_backend=backend, device="cpu")
        runs[backend] = solver.run_steady(max_outer=2)
    (s_r, t_r, n_r), (s_f, t_f, n_f) = runs["reference"], runs["fused"]
    assert n_r == n_f == 2
    for f in PisoState._fields:
        a, b = getattr(s_f, f), getattr(s_r, f)
        assert float((a - b).abs().max()) <= PARITY * max(
            float(b.abs().max()), 1e-300), f
    assert torch.equal(t_r.p_iters, t_f.p_iters)
    assert torch.equal(t_r.mom_iters, t_f.mom_iters)


def test_launcher_runs_simple_on_the_cpu(capsys):
    state, stats = launch_main(["--program", "simple", "--case", "channel",
                                "--n", "4", "--parts", "2", "--alpha", "2",
                                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "channel/simple: converged after" in out
    assert "relax_u=0.7" in out
    assert state.U.device.type == "cpu" and state.U.shape == (2, 32, 3)
    assert float(stats.continuity_err) < 1e-5


def test_launcher_derives_nu_from_re(capsys):
    launch_main(["--case", "backstep", "--re", "50", "--n", "4", "--parts",
                 "2", "--alpha", "2", "--steps", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Re=50: derived nu=2.000e-03" in out and "step 0:" in out
