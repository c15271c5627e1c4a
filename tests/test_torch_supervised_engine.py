"""The port's supervised serving engine against the JAX package's, on the
CPU.

The same supervised sessions through both engines (the JAX side on its
CPU backend, where "auto" is the plain reference backend, as it is on the
port's CPU tensors): after every request the states within 1e-10 of each
field's max (1e-5 for windows under a refined policy: their Krylov solves
stop at 1e-8 / 1e-7, and the refined dots round differently in the two
libraries), identical counts and flags (f64), equal ``counters``,
``dispatch_paths``, cohort groupings, supervisor ``to_dict()`` (state,
``dt_scale``, budget, event log) and post-mortems.  Then exact
snapshot/restore: the port's own round trip bitwise, snapshots restored
across the two packages in both directions, the tolerances in the port's
manifest, ``EngineScheduler.snapshot``, and kill-and-resume through the
port's supervised launcher in process.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.core.controller import ControllerConfig as JaxConfig
from repro.faults import ChaosMonkey as JaxMonkey
from repro.fvm.mesh import CavityMesh as JaxMesh
from repro.serving.engine import SimulationEngine as JaxEngine
from repro.serving.supervisor import SupervisorConfig as JaxSupConfig

from repro_torch.core.controller import ControllerConfig
from repro_torch.faults import ChaosMonkey
from repro_torch.fvm.mesh import CavityMesh
from repro_torch.launch.serve import main as serve_main
from repro_torch.serving.engine import SimulationEngine
from repro_torch.serving.scheduler import EngineScheduler, SessionSpec
from repro_torch.serving.supervisor import (DEGRADED, HEALTHY, QUARANTINED,
                                            SupervisorConfig)

PARITY = 1e-10
REFINED = 1e-5   # 100x mom_tol, the refined bar of chip_smoke.py
DTS = (1e-3, 1.1e-3, 1.2e-3, 1.3e-3)
# no switch: the two engines price alpha with different specs, and a
# switch would follow wall-clock samples
NO_SWITCH = dict(sample_every=2, hysteresis=1e9)


def _engines(sup=None, **kw):
    port = SimulationEngine(config=ControllerConfig(**NO_SWITCH),
                            supervise=True, device="cpu",
                            supervisor_config=(None if sup is None else
                                               SupervisorConfig(**sup)),
                            **kw)
    jax_ = JaxEngine(config=JaxConfig(**NO_SWITCH), supervise=True,
                     supervisor_config=(None if sup is None else
                                        JaxSupConfig(**sup)), **kw)
    return port, jax_


def _open(engines, sid, cube, **kw):
    port, jax_ = engines
    port.open_session(sid, CavityMesh.cube(*cube), **kw)
    jax_.open_session(sid, JaxMesh.cube(*cube), **kw)


def _poison(engines, sid):
    """NaN into one velocity component, through each package's injector."""
    port, jax_ = engines
    ChaosMonkey._inject_nan(port.sessions[sid])
    JaxMonkey._inject_nan(jax_.sessions[sid])


def _groups(eng):
    return sorted(sorted(g) for g in eng.cohorts().values())


def _match(engines, last=None):
    """Hold the two engines to each other (module docstring)."""
    port, jax_ = engines
    assert port.counters == jax_.counters
    assert port.dispatch_paths == jax_.dispatch_paths
    assert _groups(port) == _groups(jax_)
    assert port.stats()["failed"] == jax_.stats()["failed"]
    for sid, post in port.failed.items():
        assert post["events"] == jax_.failed[sid]["events"]
        assert post["steps_done"] == jax_.failed[sid]["steps_done"]
    assert port.sessions.keys() == jax_.sessions.keys()
    for sid, sess in port.sessions.items():
        js = jax_.sessions[sid]
        assert sess.steps_done == js.steps_done, sid
        assert sess.supervisor.to_dict() == js.supervisor.to_dict(), sid
        assert sess.solver.precision == js.solver.precision
        assert sess.solver.solver_backend == js.solver.solver_backend
        refined = (sess.solver.precision != "f64"
                   or sess.supervisor.orig_precision is not None)
        bar = REFINED if refined else PARITY
        for f in sess.state._fields:
            a = getattr(sess.state, f).numpy()
            b = np.asarray(getattr(js.state, f))
            assert float(np.abs(a - b).max()) <= bar * max(
                float(np.abs(b).max()), 1e-300), (sid, f)
        if last is None or sid not in last[0]:
            continue
        fields = ("converged", "diverged", "hit_cap")
        if not refined:
            fields += ("mom_iters", "p_iters")
        for f in fields:
            np.testing.assert_array_equal(
                getattr(last[0][sid], f).numpy(),
                np.asarray(getattr(last[1][sid], f)), err_msg=f"{sid} {f}")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op torch thread: the suite runs several workers on few
    cores, whose threads would otherwise oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _step(engines, n):
    port, jax_ = engines
    last = (port.step_all(n), jax_.step_all(n))
    _match(engines, last)
    return last


def _kinds(sess):
    return [e.kind for e in sess.supervisor.events]


def test_nan_lane_is_rolled_back_and_rejoins_its_cohort():
    """JAX ``tests/test_serving.py:514-587``: a NaN lane of a 4-lane cohort
    is detected in its window, rolled back and retried solo at half dt
    while its mates stay in one cohort; after the recovery windows it
    rejoins.  Both engines, request by request."""
    engines = _engines(scan_window=4)
    for i, dt in enumerate(DTS):
        _open(engines, f"s{i}", (4, 4), dt=dt, alpha0=2, adaptive=False)
    port = engines[0]
    assert _groups(port) == [["s0", "s1", "s2", "s3"]]
    _step(engines, 4)
    _poison(engines, "s1")
    _step(engines, 4)
    s1 = port.sessions["s1"]
    assert _kinds(s1) == ["fault", "degrade"]
    assert s1.supervisor.events[0].detail == "diverged"
    assert (s1.supervisor.state, s1.supervisor.dt_scale) == (DEGRADED, 0.5)
    assert _groups(port) == [["s0", "s2", "s3"], ["s1"]]
    assert s1.steps_done == 8 and torch.isfinite(s1.state.U).all()
    assert port.counters["cohort_dispatches"] == 2
    assert port.counters["solo_dispatches"] == 1
    for _ in range(port.supervisor_config.recovery_windows):
        _step(engines, 4)
    assert s1.supervisor.state == HEALTHY and s1.supervisor.dt_scale == 1.0
    assert _kinds(s1)[-1] == "restore"
    assert _groups(port) == [["s0", "s1", "s2", "s3"]]
    _step(engines, 4)               # one cohort again
    assert port.stats()["sessions"]["s1"]["health"] == HEALTHY


def test_persistent_cap_fault_fails_cleanly():
    """JAX ``tests/test_supervision.py:188-211``: a cap fault that survives
    rollback burns the budget and FAILS; the mate is never disturbed."""
    engines = _engines(sup={"retry_budget": 2}, scan_window=4)
    _open(engines, "a", (4, 2), dt=1e-3, alpha0=2, adaptive=False)
    _open(engines, "b", (4, 2), dt=2e-3, alpha0=2, adaptive=False)
    _step(engines, 4)
    ChaosMonkey._inject_cap(engines[0].sessions["a"])
    JaxMonkey._inject_cap(engines[1].sessions["a"])
    _step(engines, 8)
    port = engines[0]
    assert "a" not in port.sessions and "a" in port.failed
    events = port.failed["a"]["events"]
    assert [e["kind"] for e in events] == ["fault", "degrade", "fault",
                                           "quarantine", "fault", "fail"]
    assert all(e["detail"] == "hit_cap" for e in events
               if e["kind"] == "fault")
    assert port.sessions["b"].steps_done == 12
    assert port.sessions["b"].supervisor.state == HEALTHY
    assert port.stats()["failed"] == ["a"]


def test_quarantine_falls_back_to_reference_then_recovers():
    """JAX ``tests/test_supervision.py:214-250``: the second fault
    quarantines on the configured fallback backend, recovery restores the
    original, and the session ends HEALTHY with all its steps."""
    engines = _engines(sup={"retry_budget": 10, "recovery_windows": 2,
                            "fallback_backend": "reference"}, scan_window=4)
    _open(engines, "a", (4, 2), dt=1e-3, alpha0=2, adaptive=False)
    _step(engines, 4)
    s = engines[0].sessions["a"]
    _poison(engines, "a")
    _step(engines, 4)
    assert s.supervisor.state == DEGRADED
    _poison(engines, "a")
    _step(engines, 4)
    assert s.supervisor.state == QUARANTINED
    assert s.solver.solver_backend == s.controller.solver_backend \
        == "reference"
    assert s.supervisor.orig_backend == "auto"
    _step(engines, 4)
    assert s.supervisor.state == DEGRADED
    assert s.solver.solver_backend == "auto"
    _step(engines, 4)
    _step(engines, 4)
    assert s.supervisor.state == HEALTHY
    assert (s.supervisor.dt_scale, s.supervisor.retries_used) == (1.0, 0)
    assert s.steps_done == 6 * 4 and torch.isfinite(s.state.U).all()


def test_nan_faults_climb_the_precision_ladder():
    """JAX ``tests/test_serving.py:718-747``: bf16_ir -> f32_ir -> f64, one
    rung per fault, before any backend rebind; full recovery restores the
    policy the tenant opened with."""
    engines = _engines(scan_window=4)
    _open(engines, "m", (4, 2), dt=1e-3, alpha0=2, adaptive=False,
          precision="bf16_ir")
    _step(engines, 4)
    s = engines[0].sessions["m"]
    _poison(engines, "m")
    _step(engines, 4)
    assert (s.solver.precision, s.supervisor.orig_precision) == \
        ("f32_ir", "bf16_ir")
    assert s.controller.precision == s.controller.base_model.precision \
        == "f32_ir"
    _poison(engines, "m")
    _step(engines, 4)
    assert s.solver.precision == "f64" and s.supervisor.state == QUARANTINED
    for _ in range(2 * engines[0].supervisor_config.recovery_windows):
        _step(engines, 4)
    assert s.supervisor.state == HEALTHY
    assert s.solver.precision == s.controller.precision == "bf16_ir"
    assert s.supervisor.orig_precision is None


def test_bf16_tenant_faults_by_itself_and_climbs():
    """A supervised bf16_ir tenant of the cube(8, 4) cavity (dt = 0.5 h,
    alpha 2, windows of 4) faults with no injection: bf16_ir does not
    converge there (ROADMAP C).  Six windows, event for event with JAX's:
    fault -> f32_ir, restored to bf16_ir after two clean windows, fault and
    climb again, restored again, then held for the last two windows.  In
    the sixth window the bf16_ir flow grows without a non-finite value or
    a capped solve (max |U| 7.7 here, 778 in JAX, from states 5e-9 apart),
    which the health flags do not see: there the states are held to be
    finite only."""
    engines = _engines(scan_window=4)
    mesh = CavityMesh.cube(8, 4)
    _open(engines, "b", (8, 4), dt=0.5 * mesh.h, alpha0=2, adaptive=False,
          precision="bf16_ir")
    port, jax_ = engines
    s = port.sessions["b"]
    precisions = []
    for window in range(6):
        if window < 5:
            _step(engines, 4)
        else:
            port.step_all(4)
            jax_.step_all(4)
            assert s.supervisor.to_dict() == \
                jax_.sessions["b"].supervisor.to_dict()
            assert port.counters == jax_.counters
            assert torch.isfinite(s.state.U).all()
            assert np.isfinite(np.asarray(jax_.sessions["b"].state.U)).all()
        precisions.append(s.solver.precision)
    assert _kinds(s) == ["fault", "degrade", "restore", "fault", "degrade",
                         "restore"]
    assert [e.detail for e in s.supervisor.events if e.kind == "fault"] == \
        ["diverged", "diverged"]
    assert precisions == ["f32_ir", "bf16_ir", "f32_ir", "bf16_ir",
                          "bf16_ir", "bf16_ir"]
    assert s.steps_done == 24 and s.supervisor.state == HEALTHY


# ---------------------------------------------------------------------------
# exact snapshot/restore
# ---------------------------------------------------------------------------

def _degraded_pair(eng_cls, mesh_cls, **kw):
    """JAX ``tests/test_supervision.py:253-267``'s engine: an adaptive and
    a non-adaptive session, 8 steps, then a NaN fault on "b"."""
    cfg = (ControllerConfig if eng_cls is SimulationEngine else JaxConfig)
    eng = eng_cls(config=cfg(**NO_SWITCH), scan_window=4, supervise=True,
                  **kw)
    mesh = mesh_cls.cube(4, 4)
    eng.open_session("a", mesh, dt=1e-3, alpha0=2, adaptive=True)
    eng.open_session("b", mesh, dt=2e-3, alpha0=2, adaptive=False)
    eng.step_all(8)
    monkey = ChaosMonkey if eng_cls is SimulationEngine else JaxMonkey
    monkey._inject_nan(eng.sessions["b"])
    eng.step_all(4)
    assert eng.sessions["b"].supervisor.state == DEGRADED
    return eng


def test_snapshot_restore_round_trip_is_bitwise(tmp_path):
    eng = _degraded_pair(SimulationEngine, CavityMesh, device="cpu")
    snap = tmp_path / "snap"
    eng.snapshot(snap)
    back = SimulationEngine.restore(snap, device="cpu")
    assert back.counters == eng.counters
    assert back.dispatch_paths == eng.dispatch_paths
    for sid in ("a", "b"):
        s1, s2 = eng.sessions[sid], back.sessions[sid]
        assert s2.steps_done == s1.steps_done
        assert s2.supervisor.to_dict() == s1.supervisor.to_dict()
        assert s2.controller.stats() == s1.controller.stats()
        assert s2.controller.calibration.n_obs == \
            s1.controller.calibration.n_obs
        assert all(torch.equal(x, y) for x, y in zip(
            s2.supervisor.last_good[0], s1.supervisor.last_good[0]))
        assert all(torch.equal(x, y) for x, y in zip(s2.state, s1.state))
    eng.step_all(4)
    back.step_all(4)
    for sid in ("a", "b"):
        for x, y in zip(back.sessions[sid].state, eng.sessions[sid].state):
            assert float((x - y).abs().max()) == 0.0
        assert back.sessions[sid].supervisor.to_dict() == \
            eng.sessions[sid].supervisor.to_dict()
    assert back.counters == eng.counters


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshots_restore_across_the_packages(tmp_path, direction):
    """One package's snapshot restored by the other, then one window on
    each side: within 1e-10 with identical counts, flags, supervisor
    state, counters and dispatch paths."""
    snap = tmp_path / "snap"
    if direction == "jax_to_port":
        src = _degraded_pair(JaxEngine, JaxMesh)
        src.snapshot(str(snap))
        engines = (SimulationEngine.restore(snap, device="cpu"), src)
    else:
        src = _degraded_pair(SimulationEngine, CavityMesh, device="cpu")
        src.snapshot(snap)
        engines = (src, JaxEngine.restore(str(snap)))
    _match(engines)
    _step(engines, 4)


def test_tolerances_round_trip_through_the_manifest(tmp_path):
    eng = SimulationEngine(device="cpu", supervise=True)
    eng.open_session("t", CavityMesh.cube(4, 2), dt=1e-3, alpha0=2,
                     adaptive=False, p_tol=1e-10, p_maxiter=6000,
                     mom_tol=1e-9, mom_maxiter=700)
    eng.open_session("d", CavityMesh.cube(4, 2), dt=1e-3, alpha0=2,
                     adaptive=False)
    snap = tmp_path / "snap"
    eng.snapshot(snap)
    manifest = json.loads((snap / "manifest.json").read_text())
    assert manifest["sessions"][0]["tols"] == {
        "mom_tol": 1e-9, "p_tol": 1e-10, "mom_maxiter": 700,
        "p_maxiter": 6000}
    back = SimulationEngine.restore(snap, device="cpu")
    s = back.sessions["t"].solver
    assert (s.mom_tol, s.p_tol, s.mom_maxiter, s.p_maxiter) == \
        (1e-9, 1e-10, 700, 6000)
    assert back.cohorts().keys() == eng.cohorts().keys()
    # a manifest the JAX package wrote carries no tols: the defaults
    for m in manifest["sessions"]:
        m.pop("tols")
    (snap / "manifest.json").write_text(json.dumps(manifest))
    s = SimulationEngine.restore(snap, device="cpu").sessions["t"].solver
    assert (s.p_tol, s.p_maxiter) == (1e-8, 2000)
    assert not os.path.exists(str(snap) + ".tmp")


def test_restore_missing_path_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        SimulationEngine.restore(tmp_path / "nope", device="cpu")


def test_engine_scheduler_snapshot_writes_its_bookkeeping(tmp_path):
    eng = SimulationEngine(device="cpu", supervise=True)
    sched = EngineScheduler(eng)
    mesh = CavityMesh(nx=4, ny=4, nz=2, n_parts=2, h=0.025)
    for i in range(3):
        sched.submit(SessionSpec(sid=f"t{i}", mesh=mesh, dt=1e-3,
                                 n_steps=4, arrival_t=0.0,
                                 open_kwargs={"alpha0": 1,
                                              "adaptive": False}))
    sched.round()
    snap = tmp_path / "snap"
    sched.snapshot(snap)
    manifest = json.loads((snap / "manifest.json").read_text())
    assert manifest["scheduler"] == json.loads(
        json.dumps(sched.bookkeeping()))
    assert [m["sid"] for m in manifest["sessions"]] == list(eng.sessions)


def _digests(out):
    return sorted(line.split()[1:] for line in out.splitlines()
                  if line.startswith("digest "))


def test_launcher_kill_and_resume_gives_equal_digests(tmp_path, capsys):
    """JAX ``tests/test_supervision.py:325-338`` through the port's
    launcher in process: an uninterrupted supervised run against one
    killed at a window-aligned snapshot and resumed from it."""
    base = ["--device", "cpu", "--cfd-n", "4", "--parts", "2",
            "--scan-steps", "4", "--adaptive"]
    full = serve_main(base + ["--sessions", "2", "--steps", "8",
                              "--supervise", "--snapshot-dir",
                              str(tmp_path / "full")])
    out_full = capsys.readouterr().out
    assert "supervision: healthy=2" in out_full
    serve_main(base + ["--sessions", "2", "--steps", "4", "--supervise",
                       "--snapshot-dir", str(tmp_path / "part")])
    capsys.readouterr()
    resumed = serve_main(base + ["--resume", "--steps", "8",
                                 "--snapshot-dir", str(tmp_path / "part")])
    out_res = capsys.readouterr().out
    assert "resumed 2 sessions" in out_res
    assert _digests(out_full) and _digests(out_full) == _digests(out_res)
    assert full["digests"] == resumed["digests"]
    with pytest.raises(SystemExit, match="needs --snapshot-dir"):
        serve_main(["--device", "cpu", "--resume"])
