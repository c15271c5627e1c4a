"""The software-pipelined executor against the JAX package, on the CPU.

The pipelined form's schedule, dependence levels and overlap frontier equal
JAX's label for label (the PISO program, plain and padded, and a toy phase
list through both schedulers); the port's pipelined run is bitwise its
serial run and within 1e-10 of JAX's pipelined ``run_steps`` with
identical counts and flags; the ``pipeline`` knob and the form's
validation raise where JAX's do.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.fvm.mesh import CavityMesh as JaxMesh
from repro.fvm.mesh import PaddedCavityMesh as JaxPadded
from repro.fvm.piso import PisoSolver as JaxPisoSolver
from repro.fvm.piso import SimpleSolver as JaxSimpleSolver
from repro.fvm.step_program import Phase as JaxPhase
from repro.fvm.step_program import _pipeline_schedule as jax_schedule

from repro_torch.fvm.mesh import CavityMesh, PaddedCavityMesh
from repro_torch.fvm.piso import PisoSolver, SimpleSolver
from repro_torch.fvm.step_program import (Phase, PipelinedExecutor,
                                         PipelineForm, StepProgram,
                                         _pipeline_schedule)
from repro_torch.launch.case import main as launch_main

PARITY = 1e-10
DT = 2e-3


def _meshes(padded):
    if padded:
        return (PaddedCavityMesh.pad(CavityMesh(nx=4, ny=4, nz=4, n_parts=2,
                                                h=0.025), 4),
                JaxPadded.pad(JaxMesh(nx=4, ny=4, nz=4, n_parts=2, h=0.025),
                              4))
    return CavityMesh.cube(4, 2), JaxMesh.cube(4, 2)


def _labels(phases):
    return [p.label for p in phases]


@pytest.mark.parametrize("padded", [False, True])
def test_schedule_and_frontier_match_jax(padded):
    mesh, jmesh = _meshes(padded)
    solver = PisoSolver(mesh, alpha=2, device="cpu", pipeline="on")
    jsolver = JaxPisoSolver(jmesh, alpha=2, solver_backend="reference",
                            pipeline="on")
    exe, jexe = solver._stepper, jsolver._stepper
    assert isinstance(exe, PipelinedExecutor)
    assert _labels(exe.schedule) == _labels(jexe.schedule)
    assert exe.levels == jexe.levels
    assert exe.frontier == jexe.frontier
    form, jform = solver.program.pipeline, jsolver.program.pipeline
    assert _labels(form.phases) == _labels(jform.phases)
    for a, b in zip(form.phases, jform.phases):
        assert (a.inputs, a.outputs, a.tag, a.blocking) == (
            b.inputs, b.outputs, b.tag, b.blocking), a.label
    assert form.ring == jform.ring == ("gradp",)
    # the frontier phases issued ahead of the momentum solve
    labels = _labels(exe.schedule)
    ahead = set(labels[:labels.index("solve_mom")])
    assert ahead.intersection(exe.frontier["solve_mom"]) == {
        "assemble_p_mat", "update_p"}


def _toy(phase_cls):
    f = lambda *a: a[0]  # noqa: E731
    return (phase_cls("a", "assembly", ("x",), ("y",), f),
            phase_cls("b", "solve", ("y",), ("z",), f, blocking=True),
            phase_cls("c", "assembly", ("x",), ("w",), f),
            phase_cls("d", "update", ("w",), ("v",), f),
            phase_cls("e", "solve", ("z", "v"), ("u",), f, blocking=True),
            phase_cls("f", "assembly", ("x",), ("t",), f),
            phase_cls("g", "assembly", ("u",), ("x2",), f))


def test_toy_schedule_matches_jax():
    got = _pipeline_schedule(_toy(Phase))
    want = jax_schedule(_toy(JaxPhase))
    assert _labels(got[0]) == _labels(want[0])
    assert got[1] == want[1] and got[2] == want[2]


@pytest.fixture(scope="module")
def jax_pipelined_run():
    mesh, jmesh = _meshes(False)
    jsolver = JaxPisoSolver(jmesh, alpha=2, solver_backend="reference",
                            pipeline="on")
    state, stats = jsolver.run_steps(jsolver.initial_state(), DT, 3)
    return ({f: np.asarray(getattr(state, f)) for f in state._fields},
            {f: np.asarray(getattr(stats, f)) for f in stats._fields})


def test_pipelined_is_the_serial_run_and_jax_pipelined(jax_pipelined_run):
    state_j, stats_j = jax_pipelined_run
    mesh, _ = _meshes(False)
    runs = {}
    for mode in ("on", "off"):
        solver = PisoSolver(mesh, alpha=2, device="cpu", pipeline=mode)
        assert solver.pipelined == (mode == "on")
        runs[mode] = solver.run_steps(solver.initial_state(), DT, 3)
    (st_on, sts_on), (st_off, sts_off) = runs["on"], runs["off"]
    for f in st_on._fields:
        assert torch.equal(getattr(st_on, f), getattr(st_off, f)), f
        a, b = getattr(st_on, f).numpy(), state_j[f]
        assert float(np.abs(a - b).max()) <= PARITY * max(
            float(np.abs(b).max()), 1e-300), f
    for f in sts_on._fields:
        assert torch.equal(getattr(sts_on, f), getattr(sts_off, f)), f
    for f in ("mom_iters", "p_iters", "converged", "diverged", "hit_cap"):
        np.testing.assert_array_equal(getattr(sts_on, f).numpy(), stats_j[f])


def test_a_window_is_its_steps():
    """The ring carried across a window's steps is what each step's prime
    computes: a window of 3 is bitwise 3 single steps."""
    mesh, _ = _meshes(True)
    solver = PisoSolver(mesh, alpha=1, device="cpu", pipeline="on")
    win, wstats = solver.run_steps(solver.initial_state(), DT, 3)
    state = solver.initial_state()
    for i in range(3):
        state, stats = solver.step(state, DT)
        assert torch.equal(stats.p_iters, wstats.p_iters[i])
    for f in state._fields:
        assert torch.equal(getattr(state, f), getattr(win, f)), f


def test_pipeline_knob_errors_follow_jax():
    mesh, jmesh = _meshes(False)
    for bad in ("sideways", "ON"):
        with pytest.raises(ValueError, match="pipeline mode"):
            PisoSolver(mesh, device="cpu", pipeline=bad)
        with pytest.raises(ValueError, match="pipeline mode"):
            JaxPisoSolver(jmesh, pipeline=bad)
    with pytest.raises(ValueError, match="no pipelined form"):
        SimpleSolver(mesh, alpha=2, device="cpu", pipeline="on")
    with pytest.raises(ValueError, match="no pipelined form"):
        JaxSimpleSolver(jmesh, alpha=2, pipeline="on")
    simple = SimpleSolver(mesh, alpha=2, device="cpu")
    assert not simple.pipelined
    assert not JaxSimpleSolver(jmesh, alpha=2).pipelined
    with pytest.raises(ValueError, match="PipelineForm"):
        PipelinedExecutor(simple.program)
    piso = PisoSolver(mesh, alpha=2, device="cpu")
    assert piso.pipelined
    with pytest.raises(ValueError, match="run_converged"):
        piso._stepper.run_converged(piso.initial_state(), DT, 3)
    with pytest.raises(ValueError, match="n_steps"):
        piso.run_steps(piso.initial_state(), DT, 0)


def test_pipeline_form_validation():
    f = lambda x: x  # noqa: E731
    phases = (Phase("a", "assembly", ("x",), ("y",), f),)

    def program(ring, prime):
        return StepProgram(phases=phases, seed=lambda s, dt: {"x": s},
                           finalize=lambda env: (env["y"], None),
                           seed_keys=("x",),
                           pipeline=PipelineForm(phases, ring, prime))

    with pytest.raises(ValueError, match="not produced"):
        program(("nope",), lambda env: {})
    with pytest.raises(ValueError, match="prime"):
        program(("y",), None)
    assert program(("y",), lambda env: {"y": env["x"]}).pipeline.ring == (
        "y",)


def test_launcher_pipeline_flag(capsys):
    argv = ["--n", "4", "--parts", "2", "--alpha", "2", "--steps", "2",
            "--device", "cpu"]
    on = launch_main(argv + ["--pipeline", "on"])
    off = launch_main(argv + ["--pipeline", "off"])
    out = capsys.readouterr().out
    assert "pipelined=True" in out and "pipelined=False" in out
    for a, b in zip(on[0], off[0]):
        assert torch.equal(a, b)
    adaptive = launch_main(argv + ["--adaptive", "--pipeline", "auto"])
    assert "controller start" in capsys.readouterr().out
    assert adaptive[1].p_iters.shape == (2, 2)
