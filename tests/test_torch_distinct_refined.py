"""The stacked solve over distinct devices in the refined policies and on
a padded mesh, on the CPU.

``cpu`` and ``cpu:0`` are two devices to a mesh, so a mesh naming both
runs :mod:`repro_torch.fvm.distinct` (the device maps of
``tests/test_torch_distinct_mesh.py``: on ``(2, 4)`` both pressure owners
are on ``cpu``, on ``(4, 2)`` they alternate, so the refined pressure CG
itself spans the ranks).  The momentum solve always spans them: its
refinement loop runs the host sweeps over :func:`~repro_torch.fvm.
distinct.rank_ops`'s refined bundle, every dot summed over the ranks.

JAX runs once per module in a subprocess with 8 forced host devices (as
the ``ref`` fixture of ``tests/test_torch_assembly_mesh.py``): ``f32_ir``
PISO on both meshes at tolerances 1e-12, its refinement passes recorded
on ``(4, 2)`` (JAX's two meshes give the same bits), and the padded
``cube(6, 6)`` -> 8 mesh in f64.  The bars: the fields within 1e-10 of
each field's maximum, the flags equal, the outer counts equal (each
solve's refinement passes, recorded around the port's and JAX's
refinement loops), the inner totals within ``tests/test_torch_precision.
py``'s slack (the f32 dots are summed in another order); the padded mesh
within 1e-10 with its counts and flags equal.  Against the port's own run
on the same mesh naming one device the same bars, the passes equal solve
for solve; ``bf16_ir`` (whose JAX run costs 18-73 s) against that run
only.
"""
import contextlib
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.comm import assembly_layout, make_cfd_mesh
from repro_torch.core.layout import unshard
from repro_torch.core.update import (owner_positions, part_positions,
                                     solve_halo_moves)
from repro_torch.fvm import distinct
from repro_torch.fvm.mesh import CavityMesh, PaddedCavityMesh
from repro_torch.fvm.piso import PisoSolver, PisoState, SimpleSolver
from repro_torch.solvers import bicgstab as bicgstab_mod
from repro_torch.solvers import cg as cg_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
A, B = "cpu", "cpu:0"
DEVICES = {(2, 4): [A, A, B, B, A, B, B, B],
           (4, 2): [A, B, B, B, A, A, B, A]}
MESHES = tuple(DEVICES)
SCHEDULES = ("device_direct", "host_buffer")
# the padded mesh: a rank holding padding parts only, and boundaries
# inside the real parts
PADDED_DEVICES = {"padding_rank": [A] * 6 + [B] * 2,
                  "inside_real": DEVICES[(2, 4)]}
PARITY = 1e-10
DT = 2e-4
TIGHT = dict(mom_tol=1e-12, p_tol=1e-12)
# tests/test_torch_precision.py's slack on the inner totals
INNER_SLACK = 2
P_ITERS_REL_SLACK = 0.25
FIELDS = ("U", "p", "phi", "phi_if")
CG, BICGSTAB = 0, 1

JAX_SIDE = textwrap.dedent("""
    import importlib
    import sys
    import numpy as np
    import jax
    from repro.env import enable_x64; enable_x64()
    from repro.core.comm import assembly_sharding, make_cfd_mesh
    from repro.fvm.mesh import CavityMesh, PaddedCavityMesh
    from repro.fvm.piso import PisoSolver

    out, passes = {}, []

    def record(mod, name, kind):
        # each refined solve's passes, handed to the host as it ends
        orig = getattr(importlib.import_module(mod), name)

        def wrapped(*a, **k):
            res = orig(*a, **k)
            if on[0]:
                jax.debug.callback(lambda o: passes.append((kind, int(o))),
                                   res.outer_iters)
            return res

        setattr(importlib.import_module(mod), name, wrapped)

    on = [False]
    record("repro.solvers.cg", "_cg_refined", 0)
    record("repro.solvers.bicgstab", "_bicgstab_refined", 1)

    def laid_out(state, m):
        return jax.tree.map(lambda x: jax.device_put(
            x, assembly_sharding(m, extra_dims=x.ndim - 1)), state)

    def keep(tag, st, stats):
        for f in ("U", "p", "phi", "phi_if"):
            out[f"{tag}_{f}"] = np.asarray(getattr(st, f))
        for f in ("p_iters", "mom_iters", "converged", "diverged",
                  "hit_cap"):
            out[f"{tag}_{f}"] = np.asarray(getattr(stats, f))

    for n_c, alpha in ((2, 4), (4, 2)):
        m = make_cfd_mesh(n_c, alpha)
        on[0] = (n_c, alpha) == (4, 2)
        solver = PisoSolver(CavityMesh.cube(8, 8), alpha=alpha, spmd_mesh=m,
                            solve_mode="stacked", precision="f32_ir",
                            mom_tol=1e-12, p_tol=1e-12)
        st, stats = solver.run(2, 2e-4, laid_out(solver.initial_state(), m))
        keep(f"f32_{n_c}x{alpha}", st, stats)
    jax.effects_barrier()
    out["passes"] = np.asarray(sorted(passes))
    m = make_cfd_mesh(2, 4)
    solver = PisoSolver(PaddedCavityMesh.pad(CavityMesh.cube(6, 6), 8),
                        alpha=4, spmd_mesh=m, solve_mode="stacked")
    st, stats = solver.run(2, 2e-4, laid_out(solver.initial_state(), m))
    keep("padded", st, stats)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    """The JAX results, run once on 8 forced host devices in a
    subprocess."""
    d = tmp_path_factory.mktemp("distinct_refined")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, str(d / "out.npz")],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(d / "out.npz"))


@contextlib.contextmanager
def refined_solves():
    """Each refined solve the port runs while the block is open, by
    thread (a rank's thread name, ``MainThread`` without ranks): ``(kind,
    passes, inner total, the final r.r's bits)``, ``kind`` 0 for CG and 1
    for BiCGStab."""
    got, lock, orig = {}, threading.Lock(), cg_mod.refine

    def recorded(ops, sweep, *a, **k):
        out = orig(ops, sweep, *a, **k)
        kind = CG if "_cg_" in sweep.__name__ else BICGSTAB
        row = (kind, int(out[5]), int(out[1]),
               out[2].reshape(1).view(torch.int64).item())
        with lock:
            got.setdefault(threading.current_thread().name, []).append(row)
        return out

    cg_mod.refine = bicgstab_mod.refine = recorded
    try:
        yield got
    finally:
        cg_mod.refine = bicgstab_mod.refine = orig


def _laid_out(state, mesh):
    return PisoState(*(assembly_layout(t, mesh) for t in state))


def _unshard(state):
    return PisoState(*(unshard(t, "cpu") for t in state))


def _max_err(got, want) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-300)


def _run(cfd, devices, n_c, alpha, steps=2, **kw):
    """``steps`` PISO steps of ``cfd`` over the ``(n_c, alpha)`` mesh of
    ``devices`` from rest, in the assembly layout; the state unsharded,
    the stats, the refined solves of rank 0 (``MainThread`` on one
    device) and the solver."""
    mesh = make_cfd_mesh(n_c, alpha, devices=devices)
    solver = PisoSolver(cfd, alpha=alpha, spmd_mesh=mesh, device="cpu", **kw)
    with refined_solves() as solves:
        st, stats = solver.run(steps, DT, _laid_out(solver.initial_state(),
                                                    mesh))
    return _unshard(st), stats, solves, solver


def _rank0(solves):
    return solves.get("rank0", solves.get("MainThread", []))


def _passes(solves):
    return [(kind, n) for kind, n, _, _ in _rank0(solves)]


def _within_slack(got, want):
    """Inner totals within the slack: BiCGStab's within ``INNER_SLACK``,
    a pressure solve's within ``P_ITERS_REL_SLACK`` of ``want``'s."""
    mom = np.abs(got.mom_iters.numpy() - np.asarray(want["mom_iters"]))
    p_w = np.asarray(want["p_iters"])
    p = np.abs(got.p_iters.numpy() - p_w)
    return bool((mom <= INNER_SLACK).all()
                and (p <= P_ITERS_REL_SLACK * p_w).all())


def _holds(st, stats, want_state, want_stats):
    """Fields within ``PARITY`` of each field's maximum, the flags equal
    (``want_*``: numpy or torch)."""
    for f in FIELDS:
        assert _max_err(getattr(st, f).numpy(),
                        np.asarray(want_state[f])) <= PARITY, f
    for f in ("converged", "diverged", "hit_cap"):
        assert np.array_equal(getattr(stats, f).numpy(),
                              np.asarray(want_stats[f])), f


def _jax(jref, tag):
    return ({f: jref[f"{tag}_{f}"] for f in FIELDS},
            {f: jref[f"{tag}_{f}"] for f in ("p_iters", "mom_iters",
                                             "converged", "diverged",
                                             "hit_cap")})


def _numpy_stats(stats):
    return {f: getattr(stats, f).numpy() for f in stats._fields}


def _numpy_state(st):
    return {f: getattr(st, f).numpy() for f in FIELDS}


# ---------------------------------------------------------------------------
# f32_ir against JAX and against the one-device run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("n_c,alpha", MESHES)
def test_f32_ir_piso_matches_jax(jref, n_c, alpha, schedule):
    st, stats, solves, _ = _run(CavityMesh.cube(8, 8), DEVICES[(n_c, alpha)],
                                n_c, alpha, precision="f32_ir",
                                update_schedule=schedule, **TIGHT)
    want_state, want_stats = _jax(jref, f"f32_{n_c}x{alpha}")
    _holds(st, stats, want_state, want_stats)
    assert bool(stats.converged.all())
    assert _within_slack(stats, want_stats), (stats, want_stats)
    # each solve's refinement passes: 3 mom + 2 p a step, two steps
    assert sorted(_passes(solves)) == [tuple(r) for r in
                                       jref["passes"].tolist()]


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("n_c,alpha", MESHES)
def test_f32_ir_piso_matches_the_one_device_run(n_c, alpha, schedule):
    kw = dict(precision="f32_ir", update_schedule=schedule, **TIGHT)
    st, stats, solves, _ = _run(CavityMesh.cube(8, 8), DEVICES[(n_c, alpha)],
                                n_c, alpha, **kw)
    st1, stats1, solves1, _ = _run(CavityMesh.cube(8, 8), [A] * 8, n_c,
                                   alpha, **kw)
    _holds(st, stats, _numpy_state(st1), _numpy_stats(stats1))
    assert _within_slack(stats, _numpy_stats(stats1))
    assert _passes(solves) == _passes(solves1) and len(_passes(solves)) == 10


@pytest.mark.parametrize("n_c,alpha", MESHES)
def test_refined_reductions_agree_over_the_ranks(n_c, alpha):
    """Every rank running a solve over the ranks sees the same final
    ``r.r`` bits, passes and inner total: the momentum's on both meshes,
    the pressure CG's too where its owners span devices."""
    _, _, solves, _ = _run(CavityMesh.cube(8, 8), DEVICES[(n_c, alpha)],
                           n_c, alpha, steps=1, precision="f32_ir", **TIGHT)
    r0, r1 = solves["rank0"], solves["rank1"]
    spans = owner_positions(make_cfd_mesh(n_c, alpha,
                                          devices=DEVICES[(n_c, alpha)]),
                            n_c)
    p_spans = len({DEVICES[(n_c, alpha)][k] for k in spans}) > 1
    assert p_spans == ((n_c, alpha) == (4, 2))
    assert r1 == ([row for row in r0 if row[0] == BICGSTAB or p_spans])
    assert sum(row[0] == BICGSTAB for row in r1) == 3
    assert all(row[1] > 0 for row in r0 if row[0] == CG)


@pytest.mark.parametrize("policy", ["f32_ir", "bf16_ir"])
def test_fused_backend_ghost_parts_refined(policy):
    """The card's route (ghost parts, one buffer a dtype; here the kernels'
    plain versions): ``f32_ir`` against the one-device fused run within
    the bars, ``bf16_ir`` (one step, the pressure capped at 20; with its
    SpMV rows accumulated in f32, as the kernel does, this cavity ends in
    NaN) with its verdict and passes equal."""
    if policy == "f32_ir":   # the pressure CG over the ranks too
        kw, steps, shape = dict(precision=policy, **TIGHT), 2, (4, 2)
    else:                     # the momentum's bf16 ghost buffers
        kw, steps, shape = dict(precision=policy, p_maxiter=20), 1, (2, 4)
    kw["solver_backend"] = "fused"
    st, stats, solves, _ = _run(CavityMesh.cube(8, 8), DEVICES[shape],
                                *shape, steps=steps, **kw)
    st1, stats1, solves1, _ = _run(CavityMesh.cube(8, 8), [A] * 8, *shape,
                                   steps=steps, **kw)
    assert _passes(solves) == _passes(solves1)
    for f in ("converged", "diverged", "hit_cap"):
        assert torch.equal(getattr(stats, f), getattr(stats1, f)), f
    assert bool(stats.converged.all()) == (policy == "f32_ir")
    if policy == "f32_ir":
        _holds(st, stats, _numpy_state(st1), _numpy_stats(stats1))
        assert _within_slack(stats, _numpy_stats(stats1))


def test_bf16_ir_matches_the_one_device_run():
    """``bf16_ir`` with the pressure capped at 20 iterations, one step: it
    ends at its cap (as JAX's does); the verdict and each solve's passes
    equal the one-device run's, the fields compared where both are
    finite."""
    kw = dict(precision="bf16_ir", p_maxiter=20)
    st, stats, solves, _ = _run(CavityMesh.cube(8, 8), DEVICES[(2, 4)], 2, 4,
                                steps=1, **kw)
    st1, stats1, solves1, _ = _run(CavityMesh.cube(8, 8), [A] * 8, 2, 4,
                                   steps=1, **kw)
    for f in ("converged", "diverged", "hit_cap"):
        assert torch.equal(getattr(stats, f), getattr(stats1, f)), f
    assert bool(stats.hit_cap.all()) and not bool(stats.diverged.any())
    assert _passes(solves) == _passes(solves1)
    assert [k for k, _ in _passes(solves)] == [BICGSTAB] * 3 + [CG] * 2
    for f in FIELDS:
        a, b = getattr(st, f), getattr(st1, f)
        both = torch.isfinite(a) & torch.isfinite(b)
        assert bool(both.any())


def test_simple_f32_ir_matches_the_one_device_run():
    kw = dict(alpha=4, device="cpu", precision="f32_ir", **TIGHT)
    mesh = make_cfd_mesh(2, 4, devices=DEVICES[(2, 4)])
    solver = SimpleSolver(CavityMesh.cube(8, 8), spmd_mesh=mesh, **kw)
    with refined_solves() as solves:
        st, stats, n = solver.run_steady(
            state=_laid_out(solver.initial_state(), mesh), max_outer=3)
    one = make_cfd_mesh(2, 4, devices=[A] * 8)
    plain = SimpleSolver(CavityMesh.cube(8, 8), spmd_mesh=one, **kw)
    with refined_solves() as solves1:
        st1, stats1, n1 = plain.run_steady(
            state=_laid_out(plain.initial_state(), one), max_outer=3)
    assert n == n1 == 3
    _holds(_unshard(st), stats, _numpy_state(_unshard(st1)),
           _numpy_stats(stats1))
    assert _within_slack(stats, _numpy_stats(stats1))
    assert _passes(solves) == _passes(solves1)
    assert len(_passes(solves)) == 3 * 4


# ---------------------------------------------------------------------------
# the moves at both itemsizes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_c,alpha", MESHES)
def test_solve_halo_counts_both_itemsizes(n_c, alpha, monkeypatch):
    """A refined solve over the ranks carries its inner products' planes
    at 4 B a value and its f64 replays' at 8 B: the bytes copied between
    devices equal the record's count, kind by kind, and ``solve_halo``
    equals the closed form of each product rank 0 ran, at the itemsize
    of its vector."""
    products, plain = [], distinct.spmv_dia

    def counted(bands, x, **kw):
        if threading.current_thread().name == "rank0":
            products.append((x.shape[-1], x.element_size()))
        return plain(bands, x, **kw)

    monkeypatch.setattr(distinct, "spmv_dia", counted)
    devices = DEVICES[(n_c, alpha)]
    _, stats, _, solver = _run(CavityMesh.cube(8, 8), devices, n_c, alpha,
                               steps=1, precision="f32_ir", pipeline="off",
                               **TIGHT)
    rec = solver.moves
    carried = {k: v[0] for k, v in rec.carried.items() if k != "scalars"}
    assert carried == {k: v.devices for k, v in rec.kinds.items()
                       if v.devices}
    mesh = solver.spmd_mesh
    cube = CavityMesh.cube(8, 8)
    owners = {cube.n_cells: part_positions(mesh, 8),
              cube.n_cells * alpha: owner_positions(mesh, n_c)}
    want = sum((solve_halo_moves(mesh, owners[m], cube.plane * size)
                for m, size in products), type(rec.kinds["halo"])())
    assert rec.kinds["solve_halo"] == want
    assert {size for _, size in products} == {4, 8}
    # the pressure CG's products over the ranks only where its owners
    # span devices
    assert any(m == cube.n_cells * alpha for m, _ in products) == (
        (n_c, alpha) == (4, 2))


# ---------------------------------------------------------------------------
# padded (size-class) meshes
# ---------------------------------------------------------------------------

def _padded():
    return PaddedCavityMesh.pad(CavityMesh.cube(6, 6), 8)


@pytest.mark.parametrize("where", sorted(PADDED_DEVICES))
def test_padded_mesh_matches_jax_and_the_one_device_run(jref, where):
    st, stats, _, solver = _run(_padded(), PADDED_DEVICES[where], 2, 4)
    want_state, want_stats = _jax(jref, "padded")
    _holds(st, stats, want_state, want_stats)
    for f in ("p_iters", "mom_iters"):
        assert np.array_equal(getattr(stats, f).numpy(), want_stats[f]), f
    assert bool(stats.converged.all())
    st1, stats1, _, _ = _run(_padded(), [A] * 8, 2, 4)
    _holds(st, stats, _numpy_state(st1), _numpy_stats(stats1))
    # the padding parts stay what the one-device run leaves there: zero
    for f in PisoState._fields:
        pad = getattr(st, f)[6:]
        assert torch.equal(pad, getattr(st1, f)[6:]), f
        assert not bool(pad.any()), f
    ranks = solver._distinct.group.parts
    if where == "padding_rank":
        assert ranks[1] == [6, 7]


def test_block_view_masks_follow_the_global_parts():
    """A rank's padded activity masks are the whole mesh's rows of its
    parts, for any real count."""
    solver = PisoSolver(_padded(), alpha=4, device="cpu")
    for parts in ([0, 1, 4], [2, 3, 5, 6, 7], [6, 7]):
        view = solver.asm.block_view(parts, "cpu:0", None)
        for n in (1, 5, 6, 8):
            whole = solver.asm.dynamic_masks(torch.tensor(n))
            got = view.dynamic_masks(torch.tensor(n))
            idx = torch.tensor(parts)
            for g, w in zip(got, whole):
                assert torch.equal(g, w.index_select(0, idx))
