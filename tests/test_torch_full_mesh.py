"""The full-mesh solve mode (``solve_mode="full_mesh"``) against the JAX
package's, on the CPU.

JAX's full mesh is one ``shard_map`` over a ``Mesh`` of devices; its own
tests force 8 host devices (``tests/test_distributed.py``).  The JAX side
here runs once per module in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` on inputs made with
``numpy.random.default_rng(0)``, and hands its results back as an
``.npz``.  The port's mesh names the CPU 8 times.  The bar: 1e-10,
identical iteration counts and flags.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core.comm import (from_shards, make_cfd_mesh, to_shards,
                                   visible_devices)
from repro_torch.core.controller import PlanCache
from repro_torch.core.repartition import plan_for_mesh
from repro_torch.fvm.mesh import CavityMesh, PaddedCavityMesh
from repro_torch.fvm.piso import PisoSolver
from repro_torch.launch.case import main as launch_main
from repro_torch.serving.engine import SimulationEngine
from repro_torch.solvers import cg as cg_mod
from repro_torch.solvers import device_loop
from repro_torch.solvers.jacobi import jacobi_preconditioner
from repro_torch.solvers.ops import reference_ops
from repro_torch.sparse.distributed import spmv_dia
from repro_torch.core.update import MoveRecord
from repro_torch.sparse.shardmap_spmv import (ShardRanks, halo_bands,
                                              make_fused_ops_full_mesh,
                                              make_jacobi_full_mesh,
                                              make_spmv_full_mesh)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY = 1e-10
DT = 2e-4
ALPHAS = (2, 4)
CPU8 = ["cpu"] * 8
# two distinct devices to a mesh (a tensor on either is a CPU tensor): the
# shards split into two runs, and alternating, one shard a run
LAYOUTS = {"contiguous": ["cpu"] * 5 + ["cpu:0"] * 3,
           "alternating": ["cpu", "cpu:0"] * 4}

JAX_SIDE = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    from repro.env import enable_x64; enable_x64()
    import jax.numpy as jnp
    from repro.core.comm import make_cfd_mesh, solve_sharding
    from repro.core.repartition import plan_for_mesh
    from repro.fvm.mesh import CavityMesh
    from repro.fvm.piso import PisoSolver
    from repro.solvers.cg import cg
    from repro.sparse.shardmap_spmv import (make_fused_ops_full_mesh,
                                            make_jacobi_full_mesh,
                                            make_spmv_full_mesh)

    inp, out = np.load(sys.argv[1]), {}
    mesh_cfd = CavityMesh.cube(8, 8)

    def setup(alpha):
        n_c = mesh_cfd.n_parts // alpha
        plan = plan_for_mesh(mesh_cfd, alpha)
        kw = dict(offsets=tuple(int(o) for o in plan.dia_offsets),
                  plane=plan.plane, n_coarse=n_c, alpha=alpha,
                  m_coarse=plan.m_coarse)
        m = make_cfd_mesh(n_coarse=n_c, alpha=alpha)
        put = lambda a, nd: jax.device_put(
            jnp.asarray(a), solve_sharding(m, extra_dims=nd, full_mesh=True))
        return m, kw, put

    for alpha in (2, 4):
        m, kw, put = setup(alpha)
        bands, x = put(inp[f"bands{alpha}"], 2), put(inp[f"x{alpha}"], 1)
        out[f"y{alpha}"] = np.asarray(
            jax.jit(make_spmv_full_mesh(m, **kw))(bands, x))
        y, dot = jax.jit(make_spmv_full_mesh(m, with_dot=True, **kw))(
            bands, x)
        out[f"yd{alpha}"], out[f"dot{alpha}"] = np.asarray(y), np.asarray(dot)
        out[f"jac{alpha}"] = np.asarray(make_jacobi_full_mesh(
            m, put(inp[f"diag{alpha}"], 1))(x))

    m, kw, put = setup(4)
    ops = make_fused_ops_full_mesh(m, put(inp["cg_bands"], 2),
                                   put(inp["cg_diag"], 1), **kw)
    b = put(inp["cg_b"], 1)
    res = cg(ops, b, put(np.zeros_like(inp["cg_b"]), 1), tol=1e-10,
             maxiter=500)
    out["cg_x"], out["cg_iters"] = np.asarray(res.x), np.asarray(res.iters)
    out["cg_flags"] = np.asarray([bool(res.converged), bool(res.hit_cap)])

    fm = PisoSolver(mesh_cfd, alpha=4, solve_mode="full_mesh")
    out["mesh4"] = np.asarray(fm.spmd_mesh.devices.shape)
    st, stats = fm.run(2, 2e-4)
    out["U"], out["p"] = np.asarray(st.U), np.asarray(st.p)
    out["p_iters"], out["mom_iters"] = (np.asarray(stats.p_iters),
                                        np.asarray(stats.mom_iters))
    fm.rebind_alpha(2)
    out["mesh2"] = np.asarray(fm.spmd_mesh.devices.shape)
    np.savez(sys.argv[2], **out)
""")


def _plan(alpha):
    plan = plan_for_mesh(CavityMesh.cube(8, 8), alpha)
    return plan, tuple(int(o) for o in plan.dia_offsets)


def _inputs() -> dict:
    """The inputs of every JAX case, from ``default_rng(0)``: random bands,
    vectors and diagonals per alpha, and the SPD system of
    ``tests/test_distributed.py``'s fused-backend case."""
    rng = np.random.default_rng(0)
    inp = {}
    for alpha in ALPHAS:
        plan, offsets = _plan(alpha)
        n_c = 8 // alpha
        inp[f"bands{alpha}"] = rng.standard_normal(
            (n_c, len(offsets), plan.m_coarse))
        inp[f"x{alpha}"] = rng.standard_normal((n_c, plan.m_coarse))
        inp[f"diag{alpha}"] = 1.0 + np.abs(
            rng.standard_normal((n_c, plan.m_coarse)))
    plan, offsets = _plan(4)
    bands = -np.abs(rng.standard_normal((2, len(offsets), plan.m_coarse))
                    * 0.1)
    diag = 1.0 + np.abs(bands).sum(1)
    bands[:, 3, :] = diag
    x_true = rng.standard_normal((2, plan.m_coarse))
    b = spmv_dia(torch.tensor(bands), torch.tensor(x_true), offsets=offsets,
                 plane=plan.plane).numpy()
    inp.update(cg_bands=bands, cg_diag=diag, cg_b=b)
    return inp


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """``(inputs, JAX results)``: the JAX side run once, on 8 forced host
    devices, in a subprocess."""
    d = tmp_path_factory.mktemp("full_mesh")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, str(d / "in.npz"),
                        str(d / "out.npz")], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return inp, dict(np.load(d / "out.npz"))


def _mesh(alpha, devices=CPU8):
    return make_cfd_mesh(8 // alpha, alpha, devices=devices)


def _err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


# ---------------------------------------------------------------------------
# against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [None, False])
@pytest.mark.parametrize("alpha", ALPHAS)
def test_spmv_and_jacobi_match_jax(ref, alpha, use_kernel):
    inp, out = ref
    plan, offsets = _plan(alpha)
    mesh = _mesh(alpha)
    kw = dict(offsets=offsets, plane=plan.plane, n_coarse=8 // alpha,
              alpha=alpha, m_coarse=plan.m_coarse, use_kernel=use_kernel)
    bands = torch.tensor(inp[f"bands{alpha}"])
    x = torch.tensor(inp[f"x{alpha}"])
    b_sh = to_shards(bands, alpha)
    y = make_spmv_full_mesh(mesh, **kw)(b_sh, x)
    yd, dot = make_spmv_full_mesh(mesh, with_dot=True, **kw)(b_sh, x)
    assert _err(y, out[f"y{alpha}"]) <= PARITY
    assert _err(yd, out[f"yd{alpha}"]) <= PARITY
    assert abs(float(dot) - float(out[f"dot{alpha}"])) <= PARITY * max(
        1.0, abs(float(out[f"dot{alpha}"])))
    jac = make_jacobi_full_mesh(mesh, torch.tensor(inp[f"diag{alpha}"]))(x)
    assert _err(jac, out[f"jac{alpha}"]) <= PARITY


def test_fused_cg_matches_jax(ref):
    inp, out = ref
    plan, offsets = _plan(4)
    ops = make_fused_ops_full_mesh(
        _mesh(4), torch.tensor(inp["cg_bands"]), torch.tensor(inp["cg_diag"]),
        offsets=offsets, plane=plan.plane, n_coarse=2, alpha=4,
        m_coarse=plan.m_coarse)
    b = torch.tensor(inp["cg_b"])
    res = cg_mod.cg(ops, b, torch.zeros_like(b), tol=1e-10, maxiter=500)
    assert int(res.iters) == int(out["cg_iters"])
    assert [bool(res.converged), bool(res.hit_cap)] == out["cg_flags"].tolist()
    assert _err(res.x, out["cg_x"]) <= PARITY


@pytest.fixture(scope="module")
def port_runs():
    """The port's full-mesh PISO (2 steps, alpha 4) on both backends, and
    its stacked run."""
    mesh = CavityMesh.cube(8, 8)
    runs = {}
    for backend in ("reference", "fused"):
        s = PisoSolver(mesh, alpha=4, solve_mode="full_mesh",
                       spmd_mesh=_mesh(4), solver_backend=backend,
                       device="cpu")
        runs[backend] = (s, *s.run(2, DT))
    s = PisoSolver(mesh, alpha=4, device="cpu")
    runs["stacked"] = (s, *s.run(2, DT))
    return runs


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_piso_matches_jax(ref, port_runs, backend):
    _, out = ref
    solver, st, stats = port_runs[backend]
    assert tuple(out["mesh4"]) == (2, 4)
    assert dict(zip(solver.spmd_mesh.axis_names, solver.spmd_mesh.shape)) \
        == {"solve": 2, "assemble": 4}
    assert _err(st.U, out["U"]) <= PARITY
    assert _err(st.p, out["p"]) <= PARITY
    assert stats.p_iters.tolist() == out["p_iters"].tolist()
    assert stats.mom_iters.tolist() == out["mom_iters"].tolist()
    assert bool(stats.converged.all())


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_rebind_alpha_reshapes_the_mesh(ref, port_runs, backend):
    _, out = ref
    solver, st, _ = port_runs[backend]
    solver.rebind_alpha(2)
    shape = dict(zip(solver.spmd_mesh.axis_names, solver.spmd_mesh.shape))
    assert shape == {"solve": 4, "assemble": 2}
    assert tuple(out["mesh2"]) == (4, 2)
    st2, _ = solver.run(1, DT, st)
    assert bool(torch.isfinite(st2.U).all())
    solver.rebind_alpha(4)


# ---------------------------------------------------------------------------
# the port on its own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_full_mesh_repeats_the_stacked_path(port_runs, backend):
    _, st_s, stats_s = port_runs["stacked"]
    _, st, stats = port_runs[backend]
    for f in ("U", "p", "phi"):
        assert _err(getattr(st, f), getattr(st_s, f)) <= PARITY
    for f in ("mom_iters", "p_iters", "converged", "hit_cap"):
        assert torch.equal(getattr(stats, f), getattr(stats_s, f))


def test_errors_as_jax_raises_them():
    mesh = CavityMesh.cube(8, 4)
    with pytest.raises(ValueError, match="unknown solve_mode"):
        PisoSolver(mesh, alpha=2, solve_mode="sharded", device="cpu")
    with pytest.raises(ValueError, match="f64-only"):
        PisoSolver(mesh, alpha=2, solve_mode="full_mesh", precision="f32_ir",
                   spmd_mesh=make_cfd_mesh(2, 2, devices=["cpu"] * 4),
                   device="cpu")
    with pytest.raises(ValueError, match="padded"):
        PisoSolver(PaddedCavityMesh.pad(mesh, 8), alpha=2,
                   solve_mode="full_mesh",
                   spmd_mesh=make_cfd_mesh(4, 2, devices=CPU8), device="cpu")
    # the default mesh takes the distinct visible devices: one CPU
    assert visible_devices("cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        PisoSolver(mesh, alpha=2, solve_mode="full_mesh", device="cpu")
    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        make_cfd_mesh(2, 2, devices=["cpu"] * 3)


def test_a_refined_policy_set_later_raises_at_the_solve():
    solver = PisoSolver(CavityMesh.cube(8, 4), alpha=2, device="cpu",
                        full_mesh_solve=True,
                        spmd_mesh=make_cfd_mesh(2, 2, devices=["cpu"] * 4))
    assert solver.solve_mode == "full_mesh"
    solver.precision = "f32_ir"
    with pytest.raises(ValueError, match="f64-only"):
        solver.step(solver.initial_state(), DT)
    solver.precision = "f64"
    _, stats = solver.step(solver.initial_state(), DT)
    assert bool(stats.converged)


def test_plan_cache_keeps_the_modes_apart():
    mesh = CavityMesh.cube(8, 4)
    cache = PlanCache()
    PisoSolver(mesh, alpha=2, device="cpu", plan_cache=cache)
    misses = cache.misses
    fm = PisoSolver(mesh, alpha=2, device="cpu", plan_cache=cache,
                    solve_mode="full_mesh",
                    spmd_mesh=make_cfd_mesh(2, 2, devices=["cpu"] * 4))
    assert cache.misses == misses + 2   # alpha 1 and 2 again, keyed apart
    keys = set(cache._entries)
    assert any(k[3:4] == ("full_mesh",) for k in keys)
    assert any(len(k) == 3 for k in keys)
    fm.rebind_alpha(4)
    fm.rebind_alpha(2)
    assert cache.misses == misses + 3


def test_the_cohort_executor_rejects_a_full_mesh_binding():
    solver = PisoSolver(CavityMesh.cube(8, 4), alpha=2, device="cpu",
                        solve_mode="full_mesh",
                        spmd_mesh=make_cfd_mesh(2, 2, devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="steps alone"):
        solver.batched_executor(2)


def test_engine_steps_full_mesh_alone_and_restores_it(tmp_path):
    mesh = CavityMesh.cube(8, 4)
    eng = SimulationEngine(device="cpu")
    fm = make_cfd_mesh(2, 2, devices=["cpu"] * 4)
    for sid in ("a", "b"):
        eng.open_session(sid, mesh, dt=0.01, alpha0=2, adaptive=False,
                         solve_mode="full_mesh", spmd_mesh=fm)
    eng.open_session("s", mesh, dt=0.01, alpha0=2, adaptive=False)
    keys = {sid: eng._cohort_key(s) for sid, s in eng.sessions.items()}
    assert keys["a"] == keys["b"] != keys["s"]
    eng.step_all(2)
    # two full-mesh tenants with one key still step alone
    assert eng.counters["cohort_dispatches"] == 0
    assert eng.counters["solo_dispatches"] == 3
    a, s = eng.sessions["a"].state, eng.sessions["s"].state
    assert _err(a.U, s.U) <= PARITY
    eng.snapshot(str(tmp_path / "snap"))
    back = SimulationEngine.restore(str(tmp_path / "snap"), device="cpu")
    rs = back.sessions["a"].solver
    assert rs.solve_mode == "full_mesh" and rs.spmd_mesh == fm
    eng.step_all(1)
    back.step_all(1)
    assert all(torch.equal(u, v) for u, v in zip(eng.sessions["a"].state,
                                                 back.sessions["a"].state))


def test_launcher_full_mesh_repeats_the_stacked_counts(capsys):
    base = ["--n", "8", "--parts", "4", "--alpha", "2", "--steps", "2",
            "--device", "cpu"]
    _, stats_s = launch_main(base)
    _, stats_f = launch_main(base + ["--solve-mode", "full_mesh",
                                     "--mesh-devices", "cpu,cpu,cpu,cpu"])
    assert stats_f.p_iters.tolist() == stats_s.p_iters.tolist()
    assert stats_f.mom_iters.tolist() == stats_s.mom_iters.tolist()
    assert "solve_mode=full_mesh" in capsys.readouterr().out
    with pytest.raises(ValueError, match="need 4 devices"):
        launch_main(base + ["--solve-mode", "full_mesh", "--mesh-devices",
                            "cpu,cpu"])


def _fused_system():
    plan, offsets = _plan(4)
    rng = np.random.default_rng(1)
    bands = -np.abs(rng.standard_normal((2, len(offsets), plan.m_coarse))
                    * 0.1)
    diag = 1.0 + np.abs(bands).sum(1)
    bands[:, 3, :] = diag
    bands, diag = torch.tensor(bands), torch.tensor(diag)
    ops = make_fused_ops_full_mesh(_mesh(4), bands, diag, offsets=offsets,
                                   plane=plan.plane, n_coarse=2, alpha=4,
                                   m_coarse=plan.m_coarse)
    b = torch.tensor(rng.standard_normal((2, plan.m_coarse)))
    return ops, bands, diag, offsets, plan, b


@pytest.mark.parametrize("k_len", [1, 3, 8, 64])
def test_device_loop_is_bitwise_the_host_loop(monkeypatch, k_len):
    ops, *_, b = _fused_system()
    monkeypatch.setitem(device_loop.K, "cg", k_len)
    (bb,) = ops.dots((b, b))
    thr = cg_mod.threshold_sq(bb, 1e-10, 0.0)
    x0 = torch.zeros_like(b)
    xd, rrd, kd = cg_mod._cg_sweep(ops, b, x0, thr, 500)
    xh, rrh, kh = cg_mod._cg_sweep_host(ops, b, x0, thr, 500)
    assert int(kd) == kh > 0
    assert torch.equal(xd, xh) and torch.equal(rrd.reshape(()), rrh)


def test_fused_cg_matches_the_stacked_reference():
    ops, bands, diag, offsets, plan, b = _fused_system()

    def A(v):
        return spmv_dia(bands, v, offsets=offsets, plane=plan.plane)

    ref = cg_mod.cg(reference_ops(A, jacobi_preconditioner(diag)), b,
                    torch.zeros_like(b), tol=1e-10, maxiter=500)
    res = cg_mod.cg(ops, b, torch.zeros_like(b), tol=1e-10, maxiter=500)
    assert int(res.iters) == int(ref.iters)
    assert _err(res.x, ref.x) <= PARITY


def test_loop_members_write_nothing_under_a_false_flag():
    ops, *_, b = _fused_system()
    off = torch.zeros((), dtype=torch.bool)
    n = b.numel()
    x, r, z, Ap = (torch.rand(b.shape, dtype=b.dtype) for _ in range(4))
    pair = torch.rand((2,) + tuple(b.shape), dtype=b.dtype)
    before = [t.clone() for t in (x, r, z, Ap, pair)]
    k = torch.zeros((), dtype=torch.int32)
    one = torch.ones((), dtype=b.dtype)
    ops.matvec_into(x, Ap, off)
    ops.matvec_dot_direction_into(pair, z, one, k, Ap, one.clone(), off)
    ops.fused_step_into(x, r, pair, Ap, one, z, one.clone(), one.clone(),
                        off, k)
    assert all(torch.equal(t, u) for t, u in zip((x, r, z, Ap, pair),
                                                  before))
    assert n == x.numel()


def test_several_devices_run_the_host_loop(port_runs, distinct_runs):
    """A mesh whose shards name two distinct devices (on the CPU, ``cpu``
    and ``cpu:0``): each rank's product over its own shards' rows, the
    planes copied between the ranks, is the stacked SpMV (the standalone
    shard SpMV runs that product over such a mesh), and the solve runs a
    host loop a device on either backend."""
    two = make_cfd_mesh(2, 4, devices=["cpu", "cpu:0"] * 4)
    assert len(two.groups()) == 8 and two.one_device is None
    plan, offsets = _plan(4)
    rng = np.random.default_rng(2)
    bands = torch.tensor(rng.standard_normal((2, 7, plan.m_coarse)))
    x = torch.tensor(rng.standard_normal((2, plan.m_coarse)))
    kw = dict(offsets=offsets, plane=plan.plane, n_coarse=2, alpha=4,
              m_coarse=plan.m_coarse)
    want = spmv_dia(bands, x, offsets=offsets, plane=plan.plane)
    for kernels in (True, False):
        sr = ShardRanks(two, bands, torch.ones_like(x), offsets=offsets,
                        plane=plan.plane, alpha=4, kernels=kernels)
        x_sh = x.reshape(8, -1)
        ys = sr.group.ranks.run(lambda r: sr.ops[r].matvec(x_sh[sr.sel[r]]))
        assert _err(sr.join(x, ys), want) <= 1e-13
    y, dot = make_spmv_full_mesh(two, with_dot=True, **kw)(
        to_shards(bands, 4), x)
    assert _err(y, want) <= 1e-13
    assert abs(float(dot) - float((x * want).sum())) <= 1e-10 * abs(
        float(dot))
    # both backends' PISO over the same two devices (two steps)
    _, st_ref, stats_ref = port_runs["reference"]
    for backend in ("reference", "alternating"):
        solver, st, stats = distinct_runs[backend]
        assert solver.spmd_mesh == two
        assert _err(st.p, st_ref.p) <= PARITY
        assert stats.p_iters.tolist() == stats_ref.p_iters.tolist()


@pytest.mark.parametrize("use_kernel", [None, False])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("alpha", ALPHAS)
def test_spmv_over_several_devices_is_the_one_device_operator(
        alpha, layout, use_kernel):
    """The standalone operator over a mesh of ``cpu`` and ``cpu:0``: ``A
    x`` and ``x . A x`` bitwise the one-device operator's, ``A x`` within
    1e-10 of the stacked ``spmv_dia`` (JAX's
    ``test_full_mesh_spmv_matches_stacked`` bar)."""
    plan, offsets = _plan(alpha)
    rng = np.random.default_rng(alpha)
    n_c = 8 // alpha
    bands = torch.tensor(rng.standard_normal((n_c, len(offsets),
                                              plan.m_coarse)))
    x = torch.tensor(rng.standard_normal((n_c, plan.m_coarse)))
    kw = dict(offsets=offsets, plane=plan.plane, n_coarse=n_c, alpha=alpha,
              m_coarse=plan.m_coarse, use_kernel=use_kernel)
    b_sh = to_shards(bands, alpha)
    want = spmv_dia(bands, x, offsets=offsets, plane=plan.plane)
    several = _mesh(alpha, LAYOUTS[layout])
    assert several.one_device is None
    for with_dot in (False, True):
        one = make_spmv_full_mesh(_mesh(alpha), with_dot=with_dot, **kw)
        got = make_spmv_full_mesh(several, with_dot=with_dot, **kw)(b_sh, x)
        ref = one(b_sh, x)
        if not with_dot:
            got, ref = (got,), (ref,)
        assert got[0].shape == x.shape
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
        assert _err(got[0], want) <= PARITY


def test_layout_helpers():
    t = torch.arange(2 * 7 * 12, dtype=torch.float64).reshape(2, 7, 12)
    sh = to_shards(t, 3)
    assert sh.shape == (6, 7, 4)
    assert torch.equal(sh[4, 2], t[1, 2, 4:8])
    assert torch.equal(from_shards(sh, 3), t)
    v = t[:, 0].contiguous()
    assert to_shards(v, 3).data_ptr() == v.data_ptr()
    one = to_shards(t[:1], 3)   # one coarse part: still a contiguous copy
    assert one.is_contiguous() and torch.equal(one[2], t[0, :, 8:])
    assert torch.equal(from_shards(to_shards(v, 3), 3), v)
    assert halo_bands((-16, -4, -1, 0, 1, 4, 16)) == (
        [(0, 16), (1, 4), (2, 1)], [(6, 16), (4, 1), (5, 4)])


def test_serial_instrumented_and_pipelined_executors_take_it():
    mesh = CavityMesh.cube(8, 4)
    kw = dict(alpha=2, device="cpu", solve_mode="full_mesh",
              spmd_mesh=make_cfd_mesh(2, 2, devices=["cpu"] * 4))
    serial = PisoSolver(mesh, pipeline="off", **kw)
    st0 = serial.initial_state()
    st, stats = serial.step(st0, DT)
    st_t, stats_t, pb = serial.timed_step(st0, DT)
    assert all(torch.equal(a, b) for a, b in zip(st, st_t))
    assert pb.solve > 0
    piped = PisoSolver(mesh, pipeline="on", **kw)
    st_p, stats_p = piped.step(st0, DT)
    assert _err(st_p.U, st.U) <= PARITY
    assert torch.equal(stats_p.p_iters, stats.p_iters)


def test_adaptive_launcher_carries_the_mode(capsys):
    _, stats = launch_main(["--n", "8", "--parts", "4", "--adaptive",
                            "--steps", "3", "--sample-every", "1",
                            "--device", "cpu", "--solve-mode", "full_mesh",
                            "--mesh-devices", "cpu,cpu,cpu,cpu"])
    out = capsys.readouterr().out
    assert "solve_mode=full_mesh" in out
    assert bool(stats.converged.all())


def test_controller_plans_and_stats_carry_the_mode():
    from repro_torch.core.controller import RepartitionController
    from repro_torch.core.cost_model import H100, CostModel

    mesh = CavityMesh.cube(8, 4)
    cache = PlanCache()
    ctl = RepartitionController(CostModel(H100, n_dofs=8 ** 3), n_cpu=4,
                                n_gpu=1, alpha0=2, cache=cache,
                                fixed_fine=True, solve_mode="full_mesh")
    plan = ctl.plan(mesh)
    assert plan.alpha == 2 and ctl.stats()["solve_mode"] == "full_mesh"
    assert [k[3:] for k in cache._entries] == [("full_mesh",)]


# ---------------------------------------------------------------------------
# over distinct devices: a rank a device, each holding its shards' rows
# ---------------------------------------------------------------------------

def _cg_bundles(inp, devices, moves=None):
    """JAX's CG system on the one-device fused bundle and on the fused
    bundle over ``devices``; ``(one, several, b, thr)``."""
    plan, offsets = _plan(4)
    kw = dict(offsets=offsets, plane=plan.plane, n_coarse=2, alpha=4,
              m_coarse=plan.m_coarse)
    bands, diag = torch.tensor(inp["cg_bands"]), torch.tensor(inp["cg_diag"])
    one = make_fused_ops_full_mesh(_mesh(4), bands, diag, **kw)
    several = make_fused_ops_full_mesh(_mesh(4, devices), bands, diag,
                                       moves=moves, **kw)
    b = torch.tensor(inp["cg_b"])
    (bb,) = one.dots((b, b))
    return one, several, b, cg_mod.threshold_sq(bb, 1e-10, 0.0)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_distinct_fused_cg_matches_jax(ref, layout):
    inp, out = ref
    _, several, b, _ = _cg_bundles(inp, LAYOUTS[layout])
    res = cg_mod.cg(several, b, torch.zeros_like(b), tol=1e-10, maxiter=500)
    assert int(res.iters) == int(out["cg_iters"])
    assert [bool(res.converged), bool(res.hit_cap)] == out["cg_flags"].tolist()
    assert _err(res.x, out["cg_x"]) <= PARITY


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_distinct_cg_is_bitwise_the_one_device_host_loop(ref, layout):
    """Each rank's dots hand their per-shard values to the host, which sums
    them in shard order: the one-device bundle's sums, bit for bit."""
    one, several, b, thr = _cg_bundles(ref[0], LAYOUTS[layout])
    x0 = torch.zeros_like(b)
    xh, rrh, kh = cg_mod._cg_sweep_host(one, b, x0, thr, 500)
    x, rr, k = cg_mod._cg_sweep_ranks(several.ranks, b, x0, thr, 500)
    assert k == kh > 0
    assert torch.equal(x, xh) and torch.equal(rr, rrh)
    assert torch.equal(x0, torch.zeros_like(b))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_distinct_cg_carries_the_closed_forms(ref, layout):
    """Each kind's bytes copied between devices: every shard off the first
    shard's device takes its bands, diagonal, b and x0 rows once and hands
    its solution back; a product moves one plane each way across each
    device boundary."""
    devices = LAYOUTS[layout]
    moves = MoveRecord()
    *_, several, b, thr = _cg_bundles(ref[0], devices, moves)
    _, _, k = cg_mod._cg_sweep_ranks(several.ranks, b, torch.zeros_like(b),
                                     thr, 500)
    plan, offsets = _plan(4)
    m_loc = plan.m_coarse // 4
    off = sum(d != devices[0] for d in devices)
    cuts = sum(a != c for a, c in zip(devices, devices[1:]))
    rows = 8 * m_loc * off
    want = {"bands_p": len(offsets) * rows, "diag_c": rows, "b_c": rows,
            "x0_c": rows, "x_back": rows,
            "solve_halo": (1 + k) * cuts * 2 * plan.plane * 8}
    got = {kind: v[0] for kind, v in moves.carried.items()
           if kind != "scalars"}
    assert got == want
    assert {kind: v.devices for kind, v in moves.kinds.items()} == want
    assert moves.carried["scalars"][0] > 0


def test_distinct_bundle_runs_the_host_loop_only(ref):
    one, several, b, _ = _cg_bundles(ref[0], LAYOUTS["alternating"])
    assert several.host_loop and not one.host_loop
    assert several.ranks is not None and one.ranks is None
    flag = torch.ones((), dtype=torch.bool)
    k = torch.zeros((), dtype=torch.int32)
    pair = torch.stack([b, b])
    calls = {"matvec_into": (b, b.clone(), flag),
             "matvec_dot_direction_into": (pair, b, k, k, b.clone(), k,
                                           flag),
             "alpha_into": (k, k, k, flag),
             "fused_step_into": (b, b, pair, b, k, b, k, k, flag, k),
             "advance": (k, k, k, k, k, flag, k, 5)}
    for name, args in calls.items():
        with pytest.raises(RuntimeError, match="ranks"):
            getattr(several, name)(*args)
    with pytest.raises(RuntimeError, match="ranks"):
        several.matvec(b)
    # the stacked dots (cg's threshold) are the one-device bundle's
    assert torch.equal(several.dots((b, b))[0], one.dots((b, b))[0])


@pytest.fixture(scope="module")
def distinct_runs():
    """Two full-mesh PISO steps (alpha 4) on the fused backend over each
    layout, and on the reference backend over the alternating one (key
    ``"reference"``)."""
    mesh = CavityMesh.cube(8, 8)
    runs = {}
    cases = [(layout, devices, "fused") for layout, devices in LAYOUTS.items()]
    for key, devices, backend in cases + [
            ("reference", LAYOUTS["alternating"], "reference")]:
        s = PisoSolver(mesh, alpha=4, solve_mode="full_mesh",
                       spmd_mesh=_mesh(4, devices), solver_backend=backend,
                       device="cpu")
        runs[key] = (s, *s.run(2, DT))
    return runs


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_distinct_piso_matches_jax(ref, distinct_runs, layout):
    _, out = ref
    _, st, stats = distinct_runs[layout]
    assert _err(st.U, out["U"]) <= PARITY
    assert _err(st.p, out["p"]) <= PARITY
    assert stats.p_iters.tolist() == out["p_iters"].tolist()
    assert stats.mom_iters.tolist() == out["mom_iters"].tolist()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_distinct_piso_is_bitwise_the_one_device_run(port_runs,
                                                     distinct_runs, layout):
    _, st1, stats1 = port_runs["fused"]
    solver, st, stats = distinct_runs[layout]
    assert all(torch.equal(a, c) for a, c in zip(st, st1))
    assert all(torch.equal(a, c) for a, c in zip(stats, stats1))
    # the step's record: the last step's two pressure solves
    halo = solver.moves.kinds["solve_halo"].devices
    assert halo == solver.moves.carried["solve_halo"][0] > 0


def test_distinct_reference_backend_matches_jax(ref, port_runs,
                                               distinct_runs):
    """The reference backend's rank form (the kernels' plain versions on
    every rank) against JAX and the one-device runs: its dots are summed
    per shard in shard order, as the one-device fused bundle sums them, so
    it is that run bit for bit; the one-device reference sums each dot
    over the whole vector, so it agrees with that one to rounding."""
    _, out = ref
    solver, st, stats = distinct_runs["reference"]
    assert solver.solver_backend == "reference"
    assert _err(st.U, out["U"]) <= PARITY
    assert _err(st.p, out["p"]) <= PARITY
    assert stats.p_iters.tolist() == out["p_iters"].tolist()
    assert stats.mom_iters.tolist() == out["mom_iters"].tolist()
    _, st1, stats1 = port_runs["reference"]
    for f in ("U", "p", "phi"):
        assert _err(getattr(st, f), getattr(st1, f)) <= PARITY
    for f in ("mom_iters", "p_iters", "converged", "hit_cap"):
        assert torch.equal(getattr(stats, f), getattr(stats1, f))
    _, st_f, stats_f = port_runs["fused"]
    assert all(torch.equal(a, c) for a, c in zip(st, st_f))
    assert all(torch.equal(a, c) for a, c in zip(stats, stats_f))
    # the rank form: each rank took its shards' bands once a solve, and a
    # product copies planes only
    carried = solver.moves.carried
    assert carried["bands_p"][0] > 0
    assert solver.moves.kinds["solve_halo"].devices \
        == carried["solve_halo"][0] > 0


def test_distinct_rebind_alpha_keeps_the_devices(port_runs, distinct_runs):
    solver, st, _ = distinct_runs["contiguous"]
    one, st1, _ = port_runs["fused"]
    solver.rebind_alpha(2)
    one.rebind_alpha(2)
    try:
        assert tuple(solver.spmd_mesh.shape) == (4, 2)
        assert solver.spmd_mesh.flat() == _mesh(2, LAYOUTS["contiguous"]) \
            .flat()
        st2, stats2 = solver.run(1, DT, st)
        st1b, stats1b = one.run(1, DT, st1)
        for f in ("U", "p", "phi"):
            assert _err(getattr(st2, f), getattr(st1b, f)) <= PARITY
        assert stats2.p_iters.tolist() == stats1b.p_iters.tolist()
    finally:
        solver.rebind_alpha(4)
        one.rebind_alpha(4)


def test_launcher_full_mesh_over_distinct_devices(capsys):
    base = ["--n", "8", "--parts", "4", "--alpha", "2", "--steps", "2",
            "--device", "cpu", "--solve-mode", "full_mesh"]
    _, stats1 = launch_main(base + ["--mesh-devices", "cpu,cpu,cpu,cpu"])
    _, stats2 = launch_main(base + ["--mesh-devices", "cpu,cpu,cpu:0,cpu:0",
                                    "--solver-backend", "fused"])
    assert stats2.p_iters.tolist() == stats1.p_iters.tolist()
    assert stats2.mom_iters.tolist() == stats1.mom_iters.tolist()
    out = capsys.readouterr().out
    assert "solve_mode=full_mesh" in out and "B between devices)" in out
