"""The stacked solve over a ``(solve, assemble)`` mesh against the JAX
package's, on the CPU.

JAX's stacked solve over a mesh (``PisoSolver(spmd_mesh=m,
solve_mode="stacked")``) runs on a state laid out by ``assembly_sharding``
and pins the pressure operands to ``solve_sharding``; its own test
(``tests/test_distributed.py``) forces 8 host devices.  The JAX side here
runs once per module in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` and hands its
results back as an ``.npz``: PISO on the ``(2, 4)`` and ``(4, 2)`` meshes,
the ``(4, 2)`` solver again after ``rebind_alpha(4)`` (the mesh keeps its
shape), and 3 SIMPLE outer iterations.  The port's mesh names the CPU 8
times.  The bar: 1e-10 of JAX, identical counts and flags, and bitwise the
port's own run without a mesh.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core.comm import (ShardMesh, assembly_layout,
                                   assembly_sharding, make_cfd_mesh,
                                   solve_constraint, solve_sharding,
                                   stacked_layout)
from repro_torch.core.layout import (P, NamedSharding, Sharded, make_mesh,
                                     move_plan, shard, unshard)
from repro_torch.core.update import (MoveRecord, halo_moves, owner_moves,
                                     owner_positions, part_positions,
                                     update_moves)
from repro_torch.fvm.mesh import CavityMesh
from repro_torch.fvm.piso import PisoSolver, PisoState, SimpleSolver
from repro_torch.launch.case import main as launch_main
from repro_torch.serving.engine import SimulationEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY = 1e-10
DT = 2e-4
CPU8 = ["cpu"] * 8
MESHES = ((2, 4), (4, 2))
STATS = ("p_iters", "mom_iters", "converged", "diverged", "hit_cap")
FIELDS = ("U", "p", "phi", "phi_if")

JAX_SIDE = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    from repro.env import enable_x64; enable_x64()
    from repro.core.comm import assembly_sharding, make_cfd_mesh
    from repro.fvm.mesh import CavityMesh
    from repro.fvm.piso import PisoSolver, SimpleSolver

    out = {}
    mesh_cfd = CavityMesh.cube(8, 8)

    def laid_out(state, m):
        return jax.tree.map(lambda x: jax.device_put(
            x, assembly_sharding(m, extra_dims=x.ndim - 1)), state)

    def keep(tag, st, stats):
        for f in ("U", "p", "phi", "phi_if"):
            out[f"{tag}_{f}"] = np.asarray(getattr(st, f))
        for f in ("p_iters", "mom_iters", "converged", "diverged",
                  "hit_cap"):
            out[f"{tag}_{f}"] = np.asarray(getattr(stats, f))
        out[f"{tag}_spec"] = np.asarray([str(e) for e in st.U.sharding.spec])

    for n_c, alpha in ((2, 4), (4, 2)):
        m = make_cfd_mesh(n_c, alpha)
        solver = PisoSolver(mesh_cfd, alpha=alpha, spmd_mesh=m,
                            solve_mode="stacked")
        st, stats = solver.run(2, 2e-4,
                               laid_out(solver.initial_state(), m))
        keep(f"m{n_c}x{alpha}", st, stats)
        if alpha == 2:
            solver.rebind_alpha(4)
            out["rebind_mesh"] = np.asarray(solver.spmd_mesh.devices.shape)
            st, stats = solver.run(2, 2e-4,
                                   laid_out(solver.initial_state(), m))
            keep("rebind", st, stats)
    m = make_cfd_mesh(2, 4)
    simple = SimpleSolver(mesh_cfd, alpha=4, spmd_mesh=m,
                          solve_mode="stacked")
    st, stats, n = simple.run_steady(
        state=laid_out(simple.initial_state(), m), max_outer=3)
    keep("simple", st, stats)
    out["simple_n"] = np.asarray(n)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX results, run once on 8 forced host devices in a
    subprocess."""
    d = tmp_path_factory.mktemp("assembly_mesh")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, str(d / "out.npz")],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(d / "out.npz"))


def _cube():
    return CavityMesh.cube(8, 8)


def _laid_out(state, mesh):
    return PisoState(*(assembly_layout(t, mesh) for t in state))


def _unshard(state):
    return PisoState(*(unshard(t, "cpu") for t in state))


def _holds(tag, out, state, stats):
    """The port's run within 1e-10 of JAX's, counts and flags equal."""
    for f in FIELDS:
        got = unshard(getattr(state, f), "cpu").numpy()
        assert np.abs(got - out[f"{tag}_{f}"]).max() <= PARITY, f
    for f in STATS:
        assert np.array_equal(getattr(stats, f).numpy(),
                              out[f"{tag}_{f}"]), f


def _bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_c,alpha", MESHES)
def test_stacked_mesh_piso_matches_jax(ref, n_c, alpha):
    mesh = make_cfd_mesh(n_c, alpha, devices=CPU8)
    solver = PisoSolver(_cube(), alpha=alpha, spmd_mesh=mesh, device="cpu")
    st, stats = solver.run(2, DT, _laid_out(solver.initial_state(), mesh))
    _holds(f"m{n_c}x{alpha}", ref, st, stats)
    # the state comes back in the assembly layout, as JAX's does
    assert all(isinstance(t, Sharded) for t in st)
    assert [str(e) for e in st.U.sharding.spec] == \
        ref[f"m{n_c}x{alpha}_spec"].tolist()
    assert st.U.sharding == assembly_sharding(mesh, 2)


def test_rebind_alpha_keeps_the_stacked_mesh_shape(ref):
    mesh = make_cfd_mesh(4, 2, devices=CPU8)
    solver = PisoSolver(_cube(), alpha=2, spmd_mesh=mesh, device="cpu")
    solver.rebind_alpha(4)
    assert tuple(solver.spmd_mesh.shape) == tuple(ref["rebind_mesh"]) \
        == (4, 2)
    st, stats = solver.run(2, DT, _laid_out(solver.initial_state(), mesh))
    _holds("rebind", ref, st, stats)
    # 2 coarse parts on a solve axis of 4: JAX's block rule puts them on
    # rows 0 and 1, so every buffer of coarse part 1 moves
    assert owner_positions(mesh, 2) == [0, 2]
    L = solver.plan_p.buffer_len
    assert solver.moves.kinds["update_p"].positions == 7 * L * 8


def test_stacked_mesh_simple_matches_jax_and_its_run_without_mesh(ref):
    mesh = make_cfd_mesh(2, 4, devices=CPU8)
    solver = SimpleSolver(_cube(), alpha=4, spmd_mesh=mesh, device="cpu")
    st, stats, n = solver.run_steady(
        state=_laid_out(solver.initial_state(), mesh), max_outer=3)
    assert n == int(ref["simple_n"]) == 3
    _holds("simple", ref, st, stats)
    plain = SimpleSolver(_cube(), alpha=4, device="cpu")
    st_p, stats_p, _ = plain.run_steady(max_outer=3)
    assert _bitwise(_unshard(st), st_p) and _bitwise(stats, stats_p)
    # one pressure correction an outer iteration: one update, one solve
    m, L = _cube().n_cells, solver.plan_p.buffer_len
    assert solver.moves.kinds["update_p"].positions == 3 * 2 * L * 8
    assert solver.moves.kinds["x_back"].positions == 3 * 2 * m * 8


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipeline", ["auto", "off"])
@pytest.mark.parametrize("n_c,alpha", MESHES + ((1, 8), (8, 1)))
def test_stacked_mesh_is_bitwise_the_run_without_mesh(n_c, alpha, pipeline):
    mesh = make_cfd_mesh(n_c, alpha, devices=CPU8)
    kw = dict(alpha=alpha, device="cpu", pipeline=pipeline)
    plain = PisoSolver(_cube(), **kw)
    st_p, stats_p = plain.run(2, DT)
    solver = PisoSolver(_cube(), spmd_mesh=mesh, **kw)
    st, stats = solver.run(2, DT, _laid_out(solver.initial_state(), mesh))
    assert _bitwise(_unshard(st), st_p) and _bitwise(stats, stats_p)
    # a stacked state in, a stacked state out
    st2, stats2 = solver.run(2, DT)
    assert not isinstance(st2.U, Sharded)
    assert _bitwise(st2, st_p) and _bitwise(stats2, stats_p)


def test_assembly_layout_round_trip_is_bitwise():
    mesh = make_cfd_mesh(2, 4, devices=CPU8)
    state = PisoSolver(_cube(), alpha=4, device="cpu").run(1, DT)[0]
    laid = _laid_out(state, mesh)
    for t, s in zip(state, laid):
        assert s.sharding == assembly_sharding(mesh, t.dim() - 1)
        assert s.shards[0].shape == (1,) + tuple(t.shape[1:])
        # positions that share a device share its storage
        assert all(sh.data_ptr() == t[k].data_ptr()
                   for k, sh in enumerate(s.shards))
        assert torch.equal(stacked_layout(s, "cpu"), t)
        # a copy per position (shard) is the same layout
        assert torch.equal(stacked_layout(shard(t, s.sharding), "cpu"), t)
    # two fine parts a position on a mesh of 4
    small = make_cfd_mesh(2, 2, devices=CPU8[:4])
    s = assembly_layout(state.p, small)
    assert s.shards[1].shape == (2, state.p.shape[1])
    assert torch.equal(stacked_layout(s, "cpu"), state.p)


def test_shard_mesh_is_a_device_mesh_with_an_exact_converter():
    mesh = make_cfd_mesh(2, 4, devices=CPU8)
    dm = make_mesh((2, 4), ("solve", "assemble"), CPU8)
    assert ShardMesh.from_device_mesh(dm) == mesh == dm
    assert dict(zip(mesh.axis_names, mesh.shape)) == {"solve": 2,
                                                      "assemble": 4}
    assert mesh.flat() == dm.device_list() and mesh.n_shards == 8
    assert mesh.groups() == [(torch.device("cpu"), 0, 8)]
    with pytest.raises(ValueError, match="axes"):
        ShardMesh.from_device_mesh(make_mesh((2, 4), ("data", "model"),
                                             CPU8))
    # a solver takes the DeviceMesh as it is
    solver = PisoSolver(_cube(), alpha=4, spmd_mesh=dm, device="cpu")
    assert isinstance(solver.spmd_mesh, ShardMesh)


@pytest.mark.parametrize("full_mesh", [False, True])
@pytest.mark.parametrize("extra_dims", [1, 2, 3])
def test_comm_specs_equal_jax(extra_dims, full_mesh):
    from repro.core import comm as jcomm

    jm = jcomm.make_cfd_mesh(1, 1)
    tm = make_cfd_mesh(1, 1, devices=["cpu"])
    assert tuple(assembly_sharding(tm, extra_dims).spec) == tuple(
        jcomm.assembly_sharding(jm, extra_dims).spec)
    assert tuple(solve_sharding(tm, extra_dims, full_mesh).spec) == tuple(
        jcomm.solve_sharding(jm, extra_dims, full_mesh).spec)


def test_solve_constraint_pins_to_the_first_position():
    x = torch.zeros(2, 5)
    assert solve_constraint(None, x) is x
    assert solve_constraint(make_cfd_mesh(2, 4, devices=CPU8), x) is x
    with pytest.raises(ValueError, match="first position"):
        solve_constraint(make_cfd_mesh(2, 4, devices=["cpu:0"] * 8), x)


# ---------------------------------------------------------------------------
# the moves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["device_direct", "host_buffer"])
@pytest.mark.parametrize("n_c,alpha", MESHES + ((1, 8), (8, 1)))
def test_move_stats_equal_the_closed_forms(n_c, alpha, schedule):
    mesh = make_cfd_mesh(n_c, alpha, devices=CPU8)
    solver = PisoSolver(_cube(), alpha=alpha, spmd_mesh=mesh, device="cpu",
                        update_schedule=schedule, pipeline="off")
    plain = PisoSolver(_cube(), alpha=alpha, device="cpu",
                       update_schedule=schedule, pipeline="off")
    st, stats = solver.step(_laid_out(solver.initial_state(), mesh), DT)
    assert _bitwise(_unshard(st), plain.step(plain.initial_state(), DT)[0])
    rec, n_corr = solver.moves.kinds, solver.n_correctors
    L, Lm = solver.plan_p.buffer_len, solver.plan_mom.buffer_len
    m, Pf = _cube().n_cells, 8
    if schedule == "device_direct":
        per_update = (alpha - 1) * n_c * L * 8
        mom = 0
    else:   # both hops: every buffer to the host, then to its owner
        per_update = 2 * Pf * L * 8
        mom = 2 * Pf * Lm * 8
    assert rec["update_p"].positions == n_corr * per_update
    assert rec["update_mom"].positions == mom
    assert per_update >= (alpha - 1) * n_c * L * 8
    for kind in ("b_c", "x0_c", "diag_c", "x_back"):
        assert rec[kind].positions == n_corr * (alpha - 1) * n_c * m * 8
    assert rec["halo"].positions > 0
    assert all(v.devices == 0 for v in rec.values())
    assert solver.moves.total().positions == sum(v.positions
                                                 for v in rec.values())


@pytest.mark.parametrize("n_c,alpha", MESHES + ((1, 8), (8, 1)))
def test_owner_moves_are_the_move_plan_to_the_active_positions(n_c, alpha):
    """The update's count is what :func:`move_plan` carries from the
    assembly layout to the solve layout's active positions; JAX's
    replicated solve layout carries ``alpha`` times as much."""
    mesh = make_cfd_mesh(n_c, alpha, devices=CPU8)
    L = 13
    shape = (n_c, alpha, L)
    plan = move_plan(NamedSharding(mesh, P("solve", "assemble", None)),
                     NamedSharding(mesh, P("solve", None, None)), shape)
    pos = mesh.positions()

    def carried(pieces):
        return 8 * sum(np.prod([hi - lo for lo, hi in box])
                       for kd, ks, box in pieces if ks != kd)

    active = carried(p for p in plan if pos[p[0]][1] == 0)
    assert owner_moves(mesh, 8, alpha, L * 8).positions == active
    assert update_moves(mesh, 8, alpha, L * 8).positions == active
    assert carried(plan) == alpha * active


def test_move_counts_between_devices():
    """Counted where the two places' devices differ (the rules alone: a
    solver refuses a mesh over distinct devices)."""
    two = make_cfd_mesh(2, 2, devices=["cpu"] * 2 + ["cpu:0"] * 2)
    assert part_positions(two, 4) == [0, 1, 2, 3]
    assert owner_positions(two, 2) == [0, 2]
    assert update_moves(two, 4, 2, 10) == (20, 0)
    # the host (cpu) is a place of its own: cpu:0's hops cross devices
    assert update_moves(two, 4, 2, 10, "host_buffer") == (80, 40)
    assert halo_moves(two, 4, 5) == (30, 10)
    assert owner_moves(make_cfd_mesh(1, 4, devices=two.flat()), 4, 4,
                       10) == (30, 20)
    rec = MoveRecord()
    rec.add("a", update_moves(two, 4, 2, 10))
    rec.add("a", halo_moves(two, 4, 5))
    assert rec.as_dict() == {"a": {"positions": 50, "devices": 10},
                             "total": {"positions": 50, "devices": 10}}


def test_timed_step_records_the_step_moves():
    mesh = make_cfd_mesh(2, 4, devices=CPU8)
    solver = PisoSolver(_cube(), alpha=4, spmd_mesh=mesh, device="cpu")
    state = _laid_out(solver.initial_state(), mesh)
    st, stats, row = solver.timed_step(state, DT)
    moves = solver._instrumented.last_moves
    assert moves == solver.moves.kinds and moves["update_p"].positions > 0
    st2, stats2 = solver.step(state, DT)
    assert _bitwise(_unshard(st), _unshard(st2)) and _bitwise(stats, stats2)


# ---------------------------------------------------------------------------
# the entry points and the errors
# ---------------------------------------------------------------------------

def test_launcher_stacked_mesh_repeats_the_counts(capsys):
    base = ["--n", "8", "--parts", "4", "--alpha", "2", "--steps", "2",
            "--device", "cpu"]
    _, stats_p = launch_main(base)
    plain = capsys.readouterr().out
    _, stats = launch_main(base + ["--solve-mode", "stacked",
                                   "--mesh-devices", "cpu,cpu,cpu,cpu"])
    out = capsys.readouterr().out
    assert _bitwise(stats, stats_p)

    def counts(text):
        return [ln.split(" (")[0] for ln in text.splitlines()
                if ln.startswith("step ")]

    assert counts(out) == counts(plain) and len(counts(out)) == 2
    assert "mesh=(2, 2), moved " in out and "mesh=" not in plain


def test_errors():
    cube = _cube()
    with pytest.raises(ValueError, match="first position"):
        PisoSolver(cube, alpha=4, device="cpu",
                   spmd_mesh=make_cfd_mesh(2, 4, devices=["cpu:0"] * 8))
    with pytest.raises(ValueError, match="not ported"):
        PisoSolver(cube, alpha=4, device="cpu", spmd_mesh=make_cfd_mesh(
            2, 4, devices=["cpu"] * 4 + ["cpu:0"] * 4))
    with pytest.raises(ValueError, match="do not lay out"):
        PisoSolver(cube, alpha=4, device="cpu",
                   spmd_mesh=make_cfd_mesh(1, 3, devices=["cpu"] * 3))
    mesh = make_cfd_mesh(2, 4, devices=CPU8)
    solver = PisoSolver(cube, alpha=4, device="cpu", spmd_mesh=mesh)
    state = solver.initial_state()
    # another layout, a half-laid-out state, another mesh
    wrong = PisoState(*(shard(t, NamedSharding(
        mesh, P("solve", *(None,) * (t.dim() - 1)))) for t in state))
    with pytest.raises(ValueError, match="assembly layout"):
        solver.step(wrong, DT)
    with pytest.raises(ValueError, match="every leaf"):
        solver.step(state._replace(U=assembly_layout(state.U, mesh)), DT)
    other = make_cfd_mesh(4, 2, devices=CPU8)
    with pytest.raises(ValueError, match="laid out over"):
        solver.step(_laid_out(state, other), DT)
    # a mesh binding steps alone; the engine takes no stacked mesh
    with pytest.raises(ValueError, match="cohort form"):
        solver.batched_executor(2)
    with pytest.raises(ValueError, match="no spmd_mesh"):
        SimulationEngine(device="cpu").open_session(
            "a", cube, dt=DT, spmd_mesh=mesh)
