"""The port's repartitioning control plane on the CPU against the JAX
package: the cost model, the online calibration, the controller, the plan
cache, the fingerprints, the backend rule, the adaptive driver and the
launcher's ``--alpha 0``.

Every comparison feeds both packages the same inputs (made from a seed
with numpy): the cost model's methods agree to 1e-12 relative and
``optimal_alpha`` exactly; the controller's alpha after every sample, its
switch events and ``stats()`` agree (floats to 1e-12); the plan cache's
meters are identical.  The adaptive driver's alpha trajectory, replayed on
JAX's ``PisoSolver``, gives fields within 1e-10 and identical counts and
flags.
"""
import dataclasses
import contextlib
import io
import re

import numpy as np
import pytest
import torch

import repro.core.cost_model as jcm
import repro.launch.case as jax_case
from repro.core.controller import (ControllerConfig as JaxConfig,
                                   PlanCache as JaxPlanCache,
                                   RepartitionController as JaxController)
from repro.core.ldu import LDULayout as JaxLayout
from repro.core.repartition import (fuse_parts_coo as jax_fuse,
                                    layout_fingerprint as jax_layout_fp,
                                    mesh_fingerprint as jax_mesh_fp)
from repro.fvm.mesh import CavityMesh as JaxMesh
from repro.fvm.piso import PisoSolver as JaxPisoSolver
from repro.fvm.step_program import roll_schedule as jax_roll_schedule
from repro.solvers.ops import resolve_backend as jax_resolve_backend

import repro_torch.launch.case as case
from repro_torch.core import cost_model as tcm
from repro_torch.core.controller import (ControllerConfig, PlanCache,
                                         RepartitionController)
from repro_torch.core.ldu import LDULayout
from repro_torch.core.repartition import (fuse_parts_coo, layout_fingerprint,
                                          mesh_fingerprint, plan_for_mesh)
from repro_torch.core.update import update_device_direct
from repro_torch.fvm.mesh import CavityMesh
from repro_torch.fvm.piso import PisoSolver, PisoState
from repro_torch.solvers.ops import resolve_backend

REL = 1e-12
PARITY = 1e-10
DT = 2e-4
SPECS = {"tpu_v5e": dataclasses.asdict(jcm.TPU_V5E),
         "horeka_a100": dataclasses.asdict(jcm.HOREKA_A100),
         "h100": dataclasses.asdict(tcm.H100)}
PAIRS = ((30, 1), (30, 30), (30, 7), (4, 2), (64, 4))
DIVISORS_30 = (1, 2, 3, 5, 6, 10, 15, 30)


def _models(spec, **kw):
    return (jcm.CostModel(jcm.HardwareSpec(**SPECS[spec]), **kw),
            tcm.CostModel(tcm.HardwareSpec(**SPECS[spec]), **kw))


def _close(a, b, what=""):
    assert abs(a - b) <= REL * max(abs(a), abs(b), 1e-300), (what, a, b)


def _phases_close(a, b, what=""):
    for f in ("assembly", "update", "halo", "solve"):
        _close(getattr(a, f), getattr(b, f), f"{what}.{f}")
    assert a.overlapped == b.overlapped


def test_port_ships_no_tpu_spec():
    assert not hasattr(tcm, "TPU_V5E")
    assert tcm.HOREKA_A100 == tcm.HardwareSpec(**SPECS["horeka_a100"])
    assert tcm.H100.name == "h100"


@pytest.mark.parametrize("fused", (False, True))
@pytest.mark.parametrize("precision", ("f64", "f32_ir", "bf16_ir"))
@pytest.mark.parametrize("spec", tuple(SPECS))
def test_cost_model_methods_match_jax(spec, precision, fused):
    """Every method over n_dofs x (n_as, n_ls) x device_direct x
    steps_per_dispatch, to 1e-12 relative; ``optimal_alpha`` exactly."""
    rng = np.random.default_rng(0)
    for n_dofs in (512, 2e4, 210 ** 3):
        jm, tm = _models(spec, n_dofs=n_dofs, fused_solver=fused,
                         precision=precision)
        for a, b in ((jm, tm), (jm.with_scales(1.3, 0.7, 2.0),
                                tm.with_scales(1.3, 0.7, 2.0))):
            _close(a.solver_flops(), b.solver_flops(), "solver_flops")
            _close(a.solver_bytes(), b.solver_bytes(), "solver_bytes")
            for n_as, n_ls in PAIRS:
                for name, args in (
                        ("t_assembly", (n_as,)), ("t_solve_core", (n_ls,)),
                        ("t_solve_core", (n_ls, 3)), ("t_halo", (n_ls,)),
                        ("t_solver", (n_ls,)), ("t_solver_cpu", (n_as,)),
                        ("T_single", (n_as, n_ls))):
                    _close(getattr(a, name)(*args), getattr(b, name)(*args),
                           name)
                for dd in (True, False):
                    for name in ("t_repartition", "T_repartitioned",
                                 "T_pipelined"):
                        _close(getattr(a, name)(n_as, n_ls, dd),
                               getattr(b, name)(n_as, n_ls, dd), name)
                    for spd in (1, 8):
                        _close(a.t_dispatch(spd), b.t_dispatch(spd))
                        for name in ("T_step", "T_step_pipelined"):
                            _close(getattr(a, name)(n_as, n_ls, dd, spd),
                                   getattr(b, name)(n_as, n_ls, dd, spd),
                                   name)
                    _phases_close(a.predict_phases(n_as, n_ls, dd),
                                  b.predict_phases(n_as, n_ls, dd))
                    times = rng.lognormal(-3, 1, size=4)
                    meas_j = jcm.PhaseBreakdown(*times)
                    meas_t = tcm.PhaseBreakdown(*times)
                    for x, y in zip(
                            a.scales_from_measurement(meas_j, n_as, n_ls, dd),
                            b.scales_from_measurement(meas_t, n_as, n_ls,
                                                      dd)):
                        _close(x, y, "scales_from_measurement")
                _close(a.alpha_star(n_as, n_ls), b.alpha_star(n_as, n_ls),
                       "alpha_star")
            for n_cpu in (4, 6, 10, 30, 64):
                for n_gpu in (1, 4):
                    for cands in ((1, 2, 4, 8, 16, 32), DIVISORS_30):
                        for pipelined in (False, True):
                            assert (a.optimal_alpha(n_cpu, n_gpu, cands,
                                                    pipelined)
                                    == b.optimal_alpha(n_cpu, n_gpu, cands,
                                                       pipelined))
        assert (jm.with_fused_solver(not fused).solver_bytes()
                == tm.with_fused_solver(not fused).solver_bytes())
        assert (jm.with_precision("f32_ir", 7).solver_bytes()
                == tm.with_precision("f32_ir", 7).solver_bytes())
    with pytest.raises(ValueError):
        tm.with_precision("fp8_ir")


def test_optimal_alpha_non_divisor_pick():
    """The reference's paper parametrization never asks whether alpha
    divides the part count: 16 at (210^3, 30 parts) on JAX's TPU spec, in
    both packages."""
    for n, parts, want in ((210, 30, 16), (24, 6, 4), (64, 10, 8)):
        jm, tm = _models("tpu_v5e", n_dofs=n ** 3)
        assert jm.optimal_alpha(parts, 1) == tm.optimal_alpha(parts, 1) \
            == want
        assert parts % want != 0


# ---------------------------------------------------------------------------
# calibration and controller
# ---------------------------------------------------------------------------

def _sequence(kind, n, rng):
    """(assembly flops per dof, scales, noise sigma, overlapped) per sample."""
    out = []
    for k in range(n):
        flops, scales, sigma, over = 250.0, (1.5, 0.8, 1.2), 0.0, False
        if kind == "noise":
            sigma = 0.2
        elif kind == "step":
            scales = (1.5, 0.8, 1.2) if k < n // 2 else (6.0, 0.5, 3.0)
        elif kind == "drift":
            # fig10_adaptive: assembly cost ramps 40x (60 -> 2400)
            ramp = min(max((k - n // 3) / (n // 3), 0.0), 1.0)
            flops, sigma = 60.0 * 40.0 ** ramp, 0.15
        elif kind == "overlapped":
            sigma, over = 0.2, bool(rng.random() < 0.4)
        out.append((flops, scales, sigma, over))
    return out


def _stats_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "scales":
            for g in a[k]:
                _close(a[k][g], b[k][g], g)
        elif k == "switches":
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                _close(x.pop("predicted_gain"), y.pop("predicted_gain"))
                assert x == y
        else:
            assert a[k] == b[k], k


CONTROLLERS = {
    # fig10's paper parametrization: 4 devices, up to 64 assembly ranks
    "paper": dict(spec="horeka_a100", n_dofs=2e4, n_cpu=64, n_gpu=4,
                  alphas=(1, 2, 4, 8, 16), kw={}),
    # the launcher's: 30 fine parts, alpha fuses (from the main ratio)
    "fixed_fine": dict(spec="h100", n_dofs=210 ** 3, n_cpu=30, n_gpu=1,
                       alphas=DIVISORS_30,
                       kw=dict(fixed_fine=True, alpha0=30)),
    "fixed_fine_tpu": dict(spec="tpu_v5e", n_dofs=64 ** 3, n_cpu=16,
                           n_gpu=1, alphas=(1, 2, 4, 8, 16),
                           kw=dict(fixed_fine=True, alpha0=16)),
    "fused": dict(spec="horeka_a100", n_dofs=2e4, n_cpu=64, n_gpu=4,
                  alphas=(1, 2, 4, 8, 16), kw=dict(solver_backend="fused")),
    "f32_ir": dict(spec="h100", n_dofs=2e5, n_cpu=32, n_gpu=2,
                   alphas=(1, 2, 4, 8, 16),
                   kw=dict(precision="f32_ir", alpha0=1)),
    "pipelined": dict(spec="horeka_a100", n_dofs=2e4, n_cpu=64, n_gpu=4,
                      alphas=(1, 2, 4, 8, 16), kw=dict(pipelined=True)),
}


@pytest.mark.parametrize("kind", ("clean", "noise", "step", "drift",
                                  "overlapped"))
@pytest.mark.parametrize("setup", tuple(CONTROLLERS))
def test_controller_trajectory_matches_jax(setup, kind):
    """The same samples into both controllers: the same alpha after every
    sample, the same calibration scales, switch events and stats."""
    c = CONTROLLERS[setup]
    rng = np.random.default_rng(7)
    jm, tm = _models(c["spec"], n_dofs=c["n_dofs"])
    for hyst, patience, dwell in ((0.10, 3, 5), (0.0, 1, 1)):
        jcfg = JaxConfig(alphas=c["alphas"], hysteresis=hyst,
                         patience=patience, min_dwell=dwell, warmup=2)
        tcfg = ControllerConfig(alphas=c["alphas"], hysteresis=hyst,
                                patience=patience, min_dwell=dwell,
                                warmup=2)
        jc = JaxController(jm, c["n_cpu"], c["n_gpu"], config=jcfg,
                           **c["kw"])
        tc = RepartitionController(tm, c["n_cpu"], c["n_gpu"], config=tcfg,
                                   **c["kw"])
        assert jc.alpha == tc.alpha
        for flops, scales, sigma, over in _sequence(kind, 90, rng):
            truth = jcm.CostModel(
                jcm.HardwareSpec(**SPECS[c["spec"]]), n_dofs=c["n_dofs"],
                assembly_flops_per_dof=flops, assembly_scale=scales[0],
                solve_scale=scales[1], comm_scale=scales[2])
            n_as, n_ls = tc.partition_counts(tc.alpha)
            clean = truth.predict_phases(n_as, n_ls)
            noise = rng.lognormal(0.0, sigma, size=4) if sigma else np.ones(4)
            times = [getattr(clean, f) * x for f, x in
                     zip(jcm.PhaseBreakdown.TIME_FIELDS, noise)]
            a_j = jc.step(jcm.PhaseBreakdown(*times, overlapped=over))
            a_t = tc.step(tcm.PhaseBreakdown(*times, overlapped=over))
            assert a_j == a_t
            for x, y in zip(jc.calibration.scales, tc.calibration.scales):
                _close(x, y, "scales")
            _close(jc.predicted_total(), tc.predicted_total())
            assert jc.recommend() == tc.recommend()
        assert jc.feasible_alphas() == tc.feasible_alphas()
        _stats_equal(jc.stats(), tc.stats())


def test_controller_rejects_what_jax_rejects():
    _, tm = _models("h100", n_dofs=1e6)
    for kw in (dict(solve_mode="ring"), dict(solver_backend="pallas"),
               dict(precision="fp8_ir"),
               dict(config=ControllerConfig(sample_every=0))):
        with pytest.raises(ValueError):
            RepartitionController(tm, 30, 1, **kw)


# ---------------------------------------------------------------------------
# plan cache and fingerprints
# ---------------------------------------------------------------------------

MESHES = ((8, 8, 8, 4), (12, 12, 12, 3), (6, 4, 10, 5))


def _meshes(nx, ny, nz, parts):
    h = 0.1 / nx
    return (JaxMesh(nx=nx, ny=ny, nz=nz, n_parts=parts, h=h),
            CavityMesh(nx=nx, ny=ny, nz=nz, n_parts=parts, h=h))


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_fingerprints_match_jax(shape):
    jmesh, tmesh = _meshes(*shape)
    assert mesh_fingerprint(tmesh) == jax_mesh_fp(jmesh)
    jl, tl = JaxLayout.from_mesh(jmesh), LDULayout.from_mesh(tmesh)
    for f in ("owner", "neigh", "iface_rows", "iface_remote_rows",
              "iface_part_offset"):
        assert getattr(tl, f).dtype == np.asarray(getattr(jl, f)).dtype, f
    assert layout_fingerprint(tl) == jax_layout_fp(jl)


def test_fuse_parts_coo_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        alpha, m = int(rng.integers(1, 6)), int(rng.integers(1, 40))
        rows = [rng.integers(0, m, size=rng.integers(0, 60))
                for _ in range(alpha)]
        cols = [rng.integers(-m, (alpha + 1) * m, size=len(r)) for r in rows]
        for x, y in zip(fuse_parts_coo(rows, cols, m, alpha),
                        jax_fuse(rows, cols, m, alpha)):
            np.testing.assert_array_equal(x, np.asarray(y))
    with pytest.raises(ValueError):
        fuse_parts_coo([np.zeros(1)], [np.zeros(1)], 4, 2)


def test_plan_cache_meters_match_jax():
    """One sequence of lookups (revisits, evictions, key components,
    layouts) into both caches: identical meters after every call."""
    jc, tc = JaxPlanCache(capacity=3), PlanCache(capacity=3)
    meshes = [_meshes(*s) for s in MESHES[:2]]
    calls = [(0, 1, {}), (0, 2, {}), (0, 1, {}), (0, 4, {}),
             (0, 2, dict(backend="fused")), (0, 2, dict(precision="f32_ir")),
             (0, 2, dict(mode="full_mesh")), (0, 1, {}), (1, 3, {}),
             (1, 3, {}), (0, 4, {}), (1, 1, dict(backend="reference")),
             (0, 2, dict(backend="fused"))]
    for i, alpha, kw in calls:
        jmesh, tmesh = meshes[i]
        jp = jc.plan_for_mesh(jmesh, alpha, **kw)
        tp = tc.plan_for_mesh(tmesh, alpha, **kw)
        np.testing.assert_array_equal(tp.dia_src, np.asarray(jp.dia_src))
        assert tc.stats() == jc.stats()
    jl, tl = (JaxLayout.from_mesh(meshes[0][0]),
              LDULayout.from_mesh(meshes[0][1]))
    for alpha in (2, 2, 4):
        m = meshes[0][1]
        jc.plan_for_layout(jl, alpha, nx=m.nx, plane=m.plane)
        tc.plan_for_layout(tl, alpha, nx=m.nx, plane=m.plane)
        assert tc.stats() == jc.stats()
    assert len(tc) == len(jc) and tc.evictions > 0
    tc.reset_stats()
    jc.reset_stats()
    assert tc.stats() == jc.stats()
    with pytest.raises(KeyError):
        tc.updater("0" * 16, 2)
    with pytest.raises(ValueError):
        PlanCache(capacity=0)


def test_cached_plan_and_updater_are_the_direct_ones():
    """A cached plan is ``plan_for_mesh``'s bitwise; its cached updater
    gives the direct update's values bitwise, through the shared pool."""
    mesh = CavityMesh.cube(8, 4)
    cache = PlanCache()
    rng = np.random.default_rng(5)
    for alpha in (1, 2, 4):
        plan = cache.plan_for_mesh(mesh, alpha)
        direct = plan_for_mesh(mesh, alpha)
        for f in ("dia_offsets", "dia_src"):
            np.testing.assert_array_equal(getattr(plan, f),
                                          getattr(direct, f))
        assert (plan.alpha, plan.m_coarse, plan.buffer_len, plan.nnz_halo) \
            == (direct.alpha, direct.m_coarse, direct.buffer_len,
                direct.nnz_halo)
        L = plan.buffer_len
        buffers = torch.as_tensor(rng.standard_normal((4 // alpha, alpha, L)))
        fn = cache.updater(mesh_fingerprint(mesh), alpha)
        assert fn is cache.updater(mesh_fingerprint(mesh), alpha)
        assert torch.equal(fn(buffers), update_device_direct(direct, buffers))
    assert cache.stats()["pool_misses"] == 3


def test_solver_takes_plans_from_the_cache():
    """``plan_cache=``: plans from the cache under the controller's key
    convention; a revisited alpha is a hit and builds nothing."""
    mesh = CavityMesh.cube(8, 4)
    cache = PlanCache()
    solver = PisoSolver(mesh, alpha=4, device="cpu", plan_cache=cache)
    assert cache.stats()["misses"] == 2 and cache.stats()["hits"] == 0
    assert solver.plan_p is cache.plan_for_mesh(mesh, 4)
    assert solver.plan_mom is cache.plan_for_mesh(mesh, 1)
    solver.rebind_alpha(2)
    secs = solver.plan_seconds
    misses = cache.misses
    for alpha in (4, 1, 2, 4):
        solver.rebind_alpha(alpha)
    assert cache.misses == misses and solver.plan_seconds == secs
    other = PisoSolver(mesh, alpha=2, device="cpu", plan_cache=cache)
    assert other.plan_seconds == 0.0
    assert other.plan_p is cache.plan_for_mesh(mesh, 2)
    # without a cache the solver memoizes its own plans
    lone = PisoSolver(mesh, alpha=2, device="cpu")
    secs = lone.plan_seconds
    lone.rebind_alpha(1)
    lone.rebind_alpha(2)
    assert lone.plan_seconds == secs


@pytest.mark.parametrize("change", [dict(solver_backend="reference"),
                                    dict(precision="f32_ir")])
def test_rebind_after_a_key_change_binds_the_cache_plan(change):
    """The backend and the policy key the cache; a rebind after either
    changed binds the plan the cache returned for the new key (one build,
    counted in ``plan_seconds``), and going back reuses the old binding
    with a hit."""
    mesh = CavityMesh.cube(8, 4)
    cache = PlanCache()
    solver = PisoSolver(mesh, alpha=2, device="cpu", plan_cache=cache)
    first, secs = solver.plan_p, solver.plan_seconds
    for name, value in change.items():
        setattr(solver, name, value)
    solver.rebind_alpha(2)
    assert cache.misses == 3 and solver.plan_seconds > secs
    assert solver.plan_p is not first
    assert solver.plan_p is cache.plan_for_mesh(
        mesh, 2, "dia", mode="stacked", backend=solver.solver_backend,
        precision=solver.precision)
    for name in change:
        setattr(solver, name, getattr(PisoSolver, name))
    secs, misses = solver.plan_seconds, cache.misses
    solver.rebind_alpha(2)
    assert solver.plan_p is first
    assert cache.misses == misses and solver.plan_seconds == secs


# ---------------------------------------------------------------------------
# the backend rule
# ---------------------------------------------------------------------------

def test_resolve_backend_auto_is_fused_on_cuda_at_every_size():
    """The port's rule: an explicit request and the CPU as in JAX's rule;
    "auto" on a CUDA device is "fused" at every part size, where JAX's
    threshold would give "reference" below its FUSED_MIN_ROWS (the
    kernels win at every size measured on the card)."""
    for req in ("auto", "fused", "reference"):
        for m in (1, 99, 511, 512, 2047, 2048, 10 ** 6):
            assert resolve_backend(req, "cpu") == jax_resolve_backend(
                req, m, on_tpu=False)
            if req != "auto":
                assert resolve_backend(req, "cuda") == jax_resolve_backend(
                    req, m, on_tpu=True)
    assert jax_resolve_backend("auto", 99, on_tpu=True) == "reference"
    assert resolve_backend("auto", "cuda") == "fused"
    assert resolve_backend("auto", torch.device("cuda", 0)) == "fused"
    with pytest.raises(ValueError):
        resolve_backend("pallas", "cpu")


# ---------------------------------------------------------------------------
# the adaptive driver and the launcher
# ---------------------------------------------------------------------------

def test_run_adaptive_replays_on_jax():
    """``run_adaptive`` on cube(8, 4), sampling every 2nd step, windows of
    3, a controller that switches at once (4 -> 1): JAX's PisoSolver
    replaying the same trajectory gives the same fields (1e-10) and
    identical counts and flags, over JAX's roll_schedule stretches."""
    n_steps, every, scan = 6, 2, 3
    mesh = CavityMesh.cube(8, 4)
    cfg = ControllerConfig(alphas=(1, 2, 4), sample_every=every, warmup=1,
                           patience=1, min_dwell=1, hysteresis=0.0)
    cache = PlanCache()
    ctl = RepartitionController(tcm.CostModel(tcm.H100, n_dofs=512), 4, 1,
                                alpha0=4, config=cfg, cache=cache,
                                fixed_fine=True)
    solver = PisoSolver(mesh, alpha=2, device="cpu", plan_cache=cache)
    lines = []
    state, stats, windows = case.run_adaptive(solver, ctl, DT, n_steps,
                                              scan, log=lines.append)
    assert [(s, c) for _, s, c, _ in windows] == list(
        jax_roll_schedule(0, n_steps, every, cap=scan))
    assert windows[0][3] == 4 and windows[-1][3] == 1
    assert [(e.old_alpha, e.new_alpha) for e in ctl.switches] == [(4, 1)]
    assert any("controller switch alpha 4 -> 1" in ln for ln in lines)
    assert lines[-1].startswith(f"{n_steps} steps in ")
    assert stats.p_iters.shape[0] == n_steps
    assert cache.misses == 3  # momentum/alpha 1, alpha 2, alpha 4

    js = JaxPisoSolver(JaxMesh.cube(8, 4), alpha=4,
                       solver_backend="reference", pipeline="off")
    jstate, jstats = js.initial_state(), []
    for _, is_sample, chunk, alpha in windows:
        if alpha != js.alpha:
            js.rebind_alpha(alpha)
        if is_sample:
            jstate, st, _ = js.timed_step(jstate, DT)
            jstats.append({f: np.asarray(getattr(st, f))[None]
                           for f in st._fields})
        else:
            jstate, st = js.run_steps(jstate, DT, chunk)
            jstats.append({f: np.asarray(getattr(st, f))
                           for f in st._fields})
    for f in PisoState._fields:
        a, b = getattr(state, f).numpy(), np.asarray(getattr(jstate, f))
        scale = max(float(np.abs(b).max()), 1e-300)
        assert float(np.abs(a - b).max()) <= PARITY * scale, f
    for f in ("mom_iters", "p_iters", "converged", "diverged", "hit_cap"):
        np.testing.assert_array_equal(
            getattr(stats, f).numpy(),
            np.concatenate([w[f] for w in jstats]), err_msg=f)


# the continuity error is a residual of order p_tol: rounding that leaves
# the fields within 1e-10 of each other moves it by up to ~1e-4 relative
CONTINUITY_REL = 1e-3


def test_continuity_per_step_is_the_references_at_the_main_tolerance():
    """The main path's pressure settings (p_tol 1e-10, 6000 iterations,
    Courant 0.5) over 10 steps from rest on cube(16, 4): the port's
    continuity error after every step is JAX's (CONTINUITY_REL), with
    identical counts and flags."""
    n, steps = 16, 10
    kw = dict(alpha=4, p_tol=1e-10, p_maxiter=6000)
    js = JaxPisoSolver(JaxMesh.cube(n, 4), solver_backend="reference",
                       pipeline="off", **kw)
    dt = 0.5 * js.mesh.h
    _, jstats = js.run(steps, dt, scan_steps=steps)
    solver = PisoSolver(CavityMesh.cube(n, 4), device="cpu", **kw)
    _, stats = solver.run(steps, dt, scan_steps=steps)
    want = np.asarray(jstats.continuity_err)
    np.testing.assert_allclose(stats.continuity_err.numpy(), want,
                               rtol=CONTINUITY_REL, atol=0)
    for f in ("mom_iters", "p_iters", "converged", "diverged", "hit_cap"):
        np.testing.assert_array_equal(getattr(stats, f).numpy(),
                                      np.asarray(getattr(jstats, f)),
                                      err_msg=f)


def _run_main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        case.main(argv)
    return out.getvalue()


@pytest.mark.parametrize("n,parts", ((8, 4), (24, 6), (12, 6)))
@pytest.mark.parametrize("spec", ("h100", "tpu_v5e"))
def test_launcher_alpha0_picks_as_jax(spec, n, parts, monkeypatch):
    """``--alpha 0`` picks what JAX's ``optimal_alpha`` picks for the same
    spec; where the pick does not divide ``--parts`` both launchers fail
    the same way, at the solver build."""
    fields = SPECS[spec]
    monkeypatch.setattr(case, "H100", tcm.HardwareSpec(**fields))
    monkeypatch.setattr(jax_case, "TPU_V5E", jcm.HardwareSpec(**fields))
    want = jcm.CostModel(jcm.HardwareSpec(**fields),
                         n_dofs=n ** 3).optimal_alpha(parts, 1)
    argv = ["--n", str(n), "--parts", str(parts), "--alpha", "0",
            "--steps", "1"]
    if parts % want:
        with pytest.raises(ValueError, match="alpha must divide") as ours:
            _run_main(argv + ["--device", "cpu"])
        with pytest.raises(ValueError, match="alpha must divide") as theirs:
            _run_main_jax(argv + ["--pipeline", "off"])
        assert str(ours.value) == str(theirs.value)
    else:
        out = _run_main(argv + ["--device", "cpu"])
        assert re.search(r"cost model picked alpha=(\d+)", out)[1] \
            == str(want)


def _run_main_jax(argv):
    with contextlib.redirect_stdout(io.StringIO()):
        jax_case.main(argv)


def test_launcher_adaptive_on_cpu():
    """``--adaptive`` with the launcher's defaults: JAX's flag defaults,
    the static pick as the start, the final controller and cache line."""
    ap, jap = case.build_parser(), jax_case.build_parser()
    for flag in ("hysteresis", "sample_every", "scan_steps", "adaptive",
                 "alpha"):
        assert ap.get_default(flag) == jap.get_default(flag), flag
    out = _run_main(["--n", "8", "--parts", "4", "--adaptive", "--steps",
                     "6", "--device", "cpu"])
    start = int(re.search(r"controller start: alpha=(\d+)", out)[1])
    assert start == RepartitionController(
        case.cost_model(ap.parse_args(["--n", "8", "--parts", "4",
                                       "--device", "cpu"])),
        4, 1, fixed_fine=True).alpha
    assert re.search(r"6 steps in .*plan cache \d+ hits / \d+ misses", out)
