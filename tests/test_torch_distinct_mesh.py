"""The stacked solve over a mesh of distinct devices, on the CPU.

``cpu`` and ``cpu:0`` are two devices to a mesh (``canonical_device``), so
a mesh naming both runs the port's distinct-device path
(:mod:`repro_torch.fvm.distinct`): one rank a device, the fine phases on
each rank's parts with the neighbour planes copied between ranks, each
coarse part's value update and solve operands carried to its owner's
device, the solution carried back, and the solves whose parts span
devices summing their dots over the ranks.  The meshes have group
boundaries inside a coarse part and between coarse parts: on ``(2, 4)``
both owners are on ``cpu`` (the pressure solve stays on one device), on
``(4, 2)`` the owners alternate (the pressure CG spans both).

The bars: JAX's stacked mesh on 8 forced host devices (the fixture of
``tests/test_torch_assembly_mesh.py``) within 1e-10 with identical counts
and flags, under both update schedules; the port's one-device run within
1e-12 of each field's maximum with identical counts and flags, and bit for
bit once no solve sums its dots over devices (the momentum solve capped at
0 iterations on the ``(2, 4)`` mesh); the bytes every copy between
devices carried equal the move record's count between devices, kind by
kind, and those equal the closed forms.
"""
import threading

import numpy as np
import pytest
import torch
from test_torch_assembly_mesh import DT, FIELDS, PARITY, STATS, ref  # noqa: F401

from repro_torch.core.comm import (assembly_layout, assembly_sharding,
                                   make_cfd_mesh, stacked_layout)
from repro_torch.core.layout import Sharded, unshard
from repro_torch.core.ranks import MeshRanks, Ranks
from repro_torch.core.update import (halo_moves, owner_moves,
                                     owner_positions, part_positions,
                                     solve_halo_moves, update_moves)
from repro_torch.fvm.mesh import CavityMesh, PaddedCavityMesh
from repro_torch.fvm.piso import PisoSolver, PisoState, SimpleSolver
from repro_torch.launch.case import main as launch_main

A, B = "cpu", "cpu:0"
# (n_c, alpha) -> the devices of its positions: a boundary inside a coarse
# part and one between coarse parts on each
DEVICES = {(2, 4): [A, A, B, B, A, B, B, B],
           (4, 2): [A, B, B, B, A, A, B, A]}
MESHES = tuple(DEVICES)
SCHEDULES = ("device_direct", "host_buffer")
ONE_DEVICE = 1e-12   # of each field's maximum: the dots summed over ranks


def _cube():
    return CavityMesh.cube(8, 8)


def _mesh(n_c, alpha):
    return make_cfd_mesh(n_c, alpha, devices=DEVICES[(n_c, alpha)])


def _laid_out(state, mesh):
    return PisoState(*(assembly_layout(t, mesh) for t in state))


def _unshard(state):
    return PisoState(*(unshard(t, "cpu") for t in state))


def _bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _close(a, b, tol):
    return all(float((x - y).abs().max()) <= tol * max(float(y.abs().max()),
                                                       1e-300)
               for x, y in zip(a, b) if x.is_floating_point())


def _holds_jax(tag, out, state, stats):
    for f in FIELDS:
        got = unshard(getattr(state, f), "cpu").numpy()
        assert np.abs(got - out[f"{tag}_{f}"]).max() <= PARITY, f
    for f in STATS:
        assert np.array_equal(getattr(stats, f).numpy(),
                              out[f"{tag}_{f}"]), f


def _carried_is_counted(solver):
    """Every kind's bytes copied between devices equal its count between
    devices; the collectives' scalars are the only other copies."""
    rec = solver.moves
    carried = {k: v[0] for k, v in rec.carried.items() if k != "scalars"}
    counted = {k: v.devices for k, v in rec.kinds.items() if v.devices}
    assert carried == counted
    assert set(rec.carried) <= set(rec.kinds) | {"scalars"}


# ---------------------------------------------------------------------------
# against JAX and the one-device run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("n_c,alpha", MESHES)
def test_distinct_mesh_piso_matches_jax_and_the_one_device_run(
        ref, n_c, alpha, schedule):  # noqa: F811
    mesh = _mesh(n_c, alpha)
    kw = dict(alpha=alpha, device="cpu", update_schedule=schedule)
    solver = PisoSolver(_cube(), spmd_mesh=mesh, **kw)
    st, stats = solver.run(2, DT, _laid_out(solver.initial_state(), mesh))
    _holds_jax(f"m{n_c}x{alpha}", ref, st, stats)
    # the state comes back in the assembly layout of the same mesh
    assert all(isinstance(t, Sharded) and t.mesh == mesh
               and t.sharding == assembly_sharding(mesh, t.ndim - 1)
               for t in st)
    one = make_cfd_mesh(n_c, alpha, devices=["cpu"] * 8)
    ref_solver = PisoSolver(_cube(), spmd_mesh=one, **kw)
    st_1, stats_1 = ref_solver.run(2, DT, _laid_out(
        ref_solver.initial_state(), one))
    assert _close(_unshard(st), _unshard(st_1), ONE_DEVICE)
    assert all(torch.equal(a, b) for a, b in zip(stats[:2], stats_1[:2]))
    assert all(torch.equal(getattr(stats, f), getattr(stats_1, f))
               for f in ("converged", "diverged", "hit_cap"))
    _carried_is_counted(solver)


@pytest.mark.parametrize("pipeline", ["auto", "off"])
def test_distinct_mesh_is_bitwise_where_no_dot_spans_devices(pipeline):
    """On ``(2, 4)`` the pressure solve runs on one device (both owners on
    ``cpu``), as without a mesh; with the momentum solve capped at 0
    iterations no dot is summed over devices, and the step is the
    one-device step bit for bit: the fine phases over two devices, the
    planes, the updates, the operands and the solution carried."""
    kw = dict(alpha=4, device="cpu", pipeline=pipeline, mom_maxiter=0)
    plain = PisoSolver(_cube(), **kw)
    st_p, stats_p = plain.run(2, DT)
    mesh = _mesh(2, 4)
    solver = PisoSolver(_cube(), spmd_mesh=mesh, **kw)
    st, stats = solver.run(2, DT, _laid_out(solver.initial_state(), mesh))
    assert _bitwise(_unshard(st), st_p) and _bitwise(stats, stats_p)
    assert int(stats.p_iters.min()) > 0


@pytest.mark.parametrize("n_c,alpha", MESHES)
def test_fused_backend_ghost_parts(n_c, alpha):
    """The fused backend's product (a card's: the rank's rows between
    zero-band ghost parts holding the neighbours' planes, one launch of
    the stacked SpMV; here its plain version on CPU tensors) against the
    one-device fused run: 1e-12, the same counts and flags."""
    mesh = _mesh(n_c, alpha)
    kw = dict(alpha=alpha, device="cpu", solver_backend="fused")
    solver = PisoSolver(_cube(), spmd_mesh=mesh, **kw)
    st, stats = solver.run(2, DT, _laid_out(solver.initial_state(), mesh))
    plain = PisoSolver(_cube(), **kw)
    st_p, stats_p = plain.run(2, DT)
    assert _close(_unshard(st), st_p, ONE_DEVICE)
    for f in STATS:
        assert torch.equal(getattr(stats, f), getattr(stats_p, f)), f
    _carried_is_counted(solver)


def test_distinct_simple_matches_jax(ref):  # noqa: F811
    mesh = _mesh(2, 4)
    solver = SimpleSolver(_cube(), alpha=4, spmd_mesh=mesh, device="cpu")
    st, stats, n = solver.run_steady(
        state=_laid_out(solver.initial_state(), mesh), max_outer=3)
    assert n == int(ref["simple_n"]) == 3
    _holds_jax("simple", ref, st, stats)
    # one outer iteration: the one-device run's counts and flags
    one, stats1, n1 = SimpleSolver(_cube(), alpha=4, spmd_mesh=mesh,
                                   device="cpu").run_steady(max_outer=1)
    plain = SimpleSolver(_cube(), alpha=4, device="cpu")
    st_p, stats_p, _ = plain.run_steady(max_outer=1)
    assert n1 == 1 and not isinstance(one.U, Sharded)
    assert _close(one, st_p, ONE_DEVICE)
    for f in ("mom_iters", "p_iters", "converged", "diverged", "hit_cap"):
        assert torch.equal(getattr(stats1, f), getattr(stats_p, f)), f


def test_rebind_alpha_keeps_the_distinct_mesh(ref):  # noqa: F811
    mesh = _mesh(4, 2)
    solver = PisoSolver(_cube(), alpha=2, spmd_mesh=mesh, device="cpu")
    solver.rebind_alpha(4)
    assert solver.spmd_mesh is mesh and tuple(mesh.shape) == (4, 2)
    # 2 coarse parts on 4 solve rows: owners 0 and 2, on cpu and cpu:0
    assert owner_positions(mesh, 2) == [0, 2]
    st, stats = solver.run(2, DT, _laid_out(solver.initial_state(), mesh))
    _holds_jax("rebind", ref, st, stats)
    _carried_is_counted(solver)
    solver.rebind_alpha(2)
    st2, _ = solver.run(1, DT, _laid_out(solver.initial_state(), mesh))
    assert st2.U.mesh == mesh


# ---------------------------------------------------------------------------
# the moves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("n_c,alpha", MESHES)
def test_carried_bytes_equal_the_record_and_the_closed_forms(n_c, alpha,
                                                             schedule):
    mesh = _mesh(n_c, alpha)
    solver = PisoSolver(_cube(), alpha=alpha, spmd_mesh=mesh, device="cpu",
                        update_schedule=schedule, pipeline="off")
    _, stats = solver.step(_laid_out(solver.initial_state(), mesh), DT)
    _carried_is_counted(solver)
    rec, n_corr, P = solver.moves.kinds, solver.n_correctors, 8
    L, Lm = solver.plan_p.buffer_len, solver.plan_mom.buffer_len
    cube = _cube()
    m, plane = cube.n_cells, cube.plane
    assert rec["update_p"] == _times(n_corr, update_moves(
        mesh, P, alpha, L * 8, schedule))
    assert rec["update_mom"] == update_moves(mesh, P, 1, Lm * 8, schedule,
                                             solve_layout=False)
    for kind in ("b_c", "x0_c", "diag_c", "x_back"):
        assert rec[kind] == _times(n_corr, owner_moves(mesh, P, alpha,
                                                       m * 8)), kind
    # whole exchanges: the assembly's planes, the solves' products
    per_halo = halo_moves(mesh, P, plane * 8)
    assert rec["halo"].devices % per_halo.devices == 0
    assert rec["halo"].positions // per_halo.positions \
        == rec["halo"].devices // per_halo.devices > 0
    # a product's planes: the momentum's (each fine part its own owner)
    # three solves of 1 + 2 k products; the pressure CG's 1 + k where its
    # owners span devices (on (4, 2))
    mom = solve_halo_moves(mesh, part_positions(mesh, P), plane * 8)
    assert mom == per_halo
    pres = solve_halo_moves(mesh, owner_positions(mesh, n_c), plane * 8)
    n_p = int((stats.p_iters + 1).sum()) if pres.devices else 0
    rest = rec["solve_halo"].devices - n_p * pres.devices
    assert rest % mom.devices == 0 and (rest // mom.devices) % 2 == 1
    assert rest // mom.devices >= 3 + 2 * int(stats.mom_iters)
    if schedule == "device_direct":
        assert rec["update_mom"].devices == 0
    else:   # every buffer to the host and back: cpu:0's both ways
        assert rec["update_mom"].devices == 2 * Lm * 8 * sum(
            d == B for d in DEVICES[(n_c, alpha)])


def _times(n, stats):
    return type(stats)(n * stats.positions, n * stats.devices)


def test_distinct_state_round_trip():
    mesh = _mesh(2, 4)
    solver = PisoSolver(_cube(), alpha=4, spmd_mesh=mesh, device="cpu")
    state = solver.run(1, DT)[0]                 # a stacked state in ...
    assert not isinstance(state.U, Sharded)      # ... a stacked state out
    laid = _laid_out(state, mesh)
    st, _ = solver.step(laid, DT)
    for t, s in zip(st, laid):
        assert t.sharding == s.sharding and t.shape == s.shape
        assert [sh.shape for sh in t.shards] == [sh.shape for sh in s.shards]
    # each rank's positions are views of its block; the layout round trips
    assert torch.equal(stacked_layout(st.p, "cpu"),
                       torch.cat([sh for sh in st.p.shards]))
    st2, stats2 = solver.step(state, DT)
    assert _bitwise(_unshard(st), st2)
    # windows: run(scan_steps=) is run_steps window by window
    a, sa = solver.run(3, DT, laid, scan_steps=2)
    b, sb = solver.run_steps(laid, DT, 3)
    assert _bitwise(_unshard(a), _unshard(b)) and _bitwise(sa, sb)


def test_distinct_timed_step_is_the_step_and_times_each_rank():
    mesh = _mesh(2, 4)
    solver = PisoSolver(_cube(), alpha=4, spmd_mesh=mesh, device="cpu",
                        pipeline="off")
    laid = _laid_out(solver.initial_state(), mesh)
    st, stats, row = solver.timed_step(laid, DT)
    st2, stats2 = solver.step(laid, DT)
    assert _bitwise(_unshard(st), _unshard(st2)) and _bitwise(stats, stats2)
    assert row.total > 0 and row.solve > 0
    ranks = solver._distinct.last_ranks
    assert [r["device"] for r in ranks] == ["cpu", "cpu:0"]
    assert [r["parts"] for r in ranks] == [3, 5]
    labels = [ph.label for ph in solver.program.phases]
    for r in ranks:
        assert [p[0] for p in r["phases"]] == labels
        assert all(s >= w >= 0 for _, _, s, w in r["phases"])
    assert solver._instrumented.last_moves == solver.moves.kinds


def test_launcher_over_distinct_devices_repeats_the_counts(capsys):
    base = ["--n", "8", "--parts", "4", "--alpha", "2", "--steps", "2",
            "--device", "cpu"]
    _, stats_p = launch_main(base)
    plain = capsys.readouterr().out
    _, stats = launch_main(base + ["--solve-mode", "stacked",
                                   "--mesh-devices", "cpu,cpu:0,cpu,cpu:0"])
    out = capsys.readouterr().out
    for f in ("mom_iters", "p_iters", "converged"):
        assert torch.equal(getattr(stats, f), getattr(stats_p, f)), f

    def counts(text):
        return [ln.split(" (")[0].split(" continuity")[0]
                for ln in text.splitlines() if ln.startswith("step ")]

    assert counts(out) == counts(plain) and len(counts(out)) == 2
    moved = [ln for ln in out.splitlines() if "mesh=(2, 2), moved" in ln]
    assert moved and "0 B between devices" not in moved[0]


# ---------------------------------------------------------------------------
# the parts and the errors
# ---------------------------------------------------------------------------

def test_mesh_ranks_layout():
    g = MeshRanks(_mesh(4, 2), 8)
    assert g.devices == [torch.device("cpu"), torch.device("cpu", 0)]
    assert g.parts == [[0, 4, 5, 7], [1, 2, 3, 6]]
    assert g.positions == g.parts
    co = g.coarse(4)
    assert co["rank_of"] == [0, 1, 0, 1] and co["local"] is None
    assert g.coarse(2)["rank_of"] == [0, 1]
    assert MeshRanks(_mesh(2, 4), 8).coarse(2)["local"] == 0


def test_ranks_collectives_and_a_failing_rank():
    ranks = Ranks(["cpu", "cpu:0", "cpu:1"])
    x = [torch.tensor(v, dtype=torch.float64) for v in (0.1, 0.2, 0.3)]

    def work(r):
        (s,) = ranks.sum(r, (x[r],))
        mx = ranks.max(r, x[r])
        ok = ranks.all(r, torch.tensor(r != 2))
        (b,) = ranks.broadcast(r, 1, (x[r] * 10,))
        return float(s), float(mx), bool(ok), float(b)

    out = ranks.run(work)
    assert out == [((0.1 + 0.2) + 0.3, 0.3, False, 2.0)] * 3

    def bad(r):
        if r == 1:
            raise KeyError("rank 1 fails")
        ranks.exchange(r, r)

    with pytest.raises(KeyError, match="rank 1"):
        ranks.run(bad)
    assert not any(t.name.startswith("rank") for t in threading.enumerate())
    with pytest.raises(ValueError, match="distinct"):
        Ranks(["cpu", "cpu"])


def test_distinct_mesh_errors():
    mesh = _mesh(2, 4)
    with pytest.raises(ValueError, match="first position"):
        PisoSolver(_cube(), alpha=4, device="cpu", spmd_mesh=make_cfd_mesh(
            2, 4, devices=[B] + [A] * 7))
    # a refined policy and a padded mesh step over distinct devices, as
    # JAX's stacked mode runs them; their state comes back on the mesh
    refined = PisoSolver(_cube(), alpha=4, device="cpu", spmd_mesh=mesh,
                         precision="f32_ir")
    st, stats = refined.step(_laid_out(refined.initial_state(), mesh), DT)
    assert st.U.mesh == mesh and bool(stats.converged)
    padded = PisoSolver(PaddedCavityMesh.pad(CavityMesh.cube(4, 4), 8),
                        alpha=4, device="cpu", spmd_mesh=mesh)
    st, stats = padded.step(_laid_out(padded.initial_state(), mesh), DT)
    assert st.U.mesh == mesh and bool(stats.converged)
    assert not bool(unshard(st.U, "cpu")[4:].any())
    solver = PisoSolver(_cube(), alpha=4, device="cpu", spmd_mesh=mesh,
                        p_maxiter=20)
    state = solver.initial_state()
    solver.precision = "bf16_ir"   # set later: read at the next step
    st, stats = solver.step(_laid_out(state, mesh), DT)
    assert st.U.mesh == mesh and bool(stats.hit_cap)
    solver.precision = "f64"
    # the full mesh stays f64, as in JAX
    with pytest.raises(ValueError, match="mixed-precision"):
        PisoSolver(_cube(), alpha=4, device="cpu", spmd_mesh=mesh,
                   solve_mode="full_mesh", precision="f32_ir")
    with pytest.raises(ValueError, match="laid out over"):
        solver.step(_laid_out(state, _mesh(4, 2)), DT)
    with pytest.raises(ValueError, match="every leaf"):
        solver.step(state._replace(U=assembly_layout(state.U, mesh)), DT)
    with pytest.raises(ValueError, match="cohort form"):
        solver.batched_executor(2)
