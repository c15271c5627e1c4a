"""The port's serving engine against the JAX package's, on the CPU.

The same sessions through both engines' ``step_all``: states within 1e-10,
identical per-session counts and flags, equal ``counters`` and
``dispatch_paths`` (adaptive sessions, so sampled steps and windows mix);
cohort keys that split on program, case, precision, pipelining and
padding as JAX's do; ``advance_group``'s rejections; lane classes; the
accounting (``reset_stats``, a per-engine default config); and the
serving launcher on the CPU.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.controller import ControllerConfig as JaxConfig
from repro.fvm.mesh import CavityMesh as JaxMesh
from repro.serving.engine import SimulationEngine as JaxEngine

from repro_torch.core.controller import ControllerConfig
from repro_torch.fvm.mesh import CavityMesh
from repro_torch.launch.serve import main as serve_main
from repro_torch.serving.engine import SimulationEngine
from repro_torch.serving.supervisor import SupervisorConfig

PARITY = 1e-10
DTS = (2e-3, 2.2e-3, 2.4e-3)
# no switch: the two engines price alpha with different specs, and the
# switch would follow wall-clock samples
NO_SWITCH = dict(sample_every=2, hysteresis=1e9)


def _engines(**kw):
    port = SimulationEngine(config=ControllerConfig(**NO_SWITCH),
                            device="cpu", **kw)
    jax_ = JaxEngine(config=JaxConfig(**NO_SWITCH), **kw)
    return port, jax_


def _open(port, jax_, sid, *, cube=(4, 2), **kw):
    port.open_session(sid, CavityMesh.cube(*cube), **kw)
    jkw = dict(kw)
    jkw.setdefault("solver_backend", "reference")
    jax_.open_session(sid, JaxMesh.cube(*cube), **jkw)


@pytest.fixture(scope="module")
def engines_stepped():
    port, jax_ = _engines()
    for i, dt in enumerate(DTS):
        _open(port, jax_, f"s{i}", dt=dt, alpha0=2, adaptive=True,
              pipeline="off")
    last_p = port.step_all(4)
    last_j = jax_.step_all(4)
    return port, jax_, last_p, last_j


def test_step_all_matches_jax(engines_stepped):
    port, jax_, last_p, last_j = engines_stepped
    assert port.counters == jax_.counters
    assert port.dispatch_paths == jax_.dispatch_paths
    assert port.counters["sample_steps"] == 2
    assert port.counters["cohort_dispatches"] == 2
    for sid, sess in port.sessions.items():
        js = jax_.sessions[sid]
        assert sess.steps_done == js.steps_done == 4
        for f in sess.state._fields:
            a = getattr(sess.state, f).numpy()
            b = np.asarray(getattr(js.state, f))
            assert float(np.abs(a - b).max()) <= PARITY * max(
                float(np.abs(b).max()), 1e-300), (sid, f)
        for f in ("mom_iters", "p_iters", "converged", "diverged",
                  "hit_cap"):
            np.testing.assert_array_equal(
                getattr(last_p[sid], f).numpy(),
                np.asarray(getattr(last_j[sid], f)), err_msg=f)
        assert len(sess.controller.history) == len(js.controller.history)
    stats, jstats = port.stats(), jax_.stats()
    assert stats["cohorts"] == jstats["cohorts"] == [3]
    assert stats["sessions"].keys() == jstats["sessions"].keys()
    for sid, row in stats["sessions"].items():
        jrow = jstats["sessions"][sid]
        for k in ("steps", "alpha", "switches", "priority", "program",
                  "case", "pipelined", "precision"):
            assert row[k] == jrow[k], k


def test_step_session_is_the_cohort_lane():
    eng = SimulationEngine(device="cpu")
    solo = SimulationEngine(device="cpu")
    for i, dt in enumerate(DTS):
        for e in (eng, solo):
            e.open_session(f"s{i}", CavityMesh.cube(4, 2), dt=dt, alpha0=2,
                           adaptive=False)
    eng.step_all(3)
    for sid in solo.sessions:
        solo.step_session(sid, 3)
        assert all(torch.equal(a, b) for a, b in zip(
            eng.sessions[sid].state, solo.sessions[sid].state))
    assert eng.counters["cohort_dispatches"] == 1
    assert solo.counters["solo_dispatches"] == 3
    assert eng.dispatch_paths["pipelined_cohort"] == 1
    assert solo.dispatch_paths["pipelined_solo"] == 3


VARIANTS = {
    "base": {},
    "dt": {"dt": 3e-3},
    "simple": {"program": "simple"},
    "channel": {"case": "channel"},
    "f32_ir": {"precision": "f32_ir"},
    "serial": {"pipeline": "off"},
    "padded": {"pad_to_class": 4},
    "adaptive": {"adaptive": True},
}


def test_cohort_keys_split_like_jax():
    port, jax_ = _engines()
    for name, kw in VARIANTS.items():
        for copy in range(2):
            kw2 = dict(dict(dt=2e-3, alpha0=2, adaptive=False), **kw)
            _open(port, jax_, f"{name}{copy}", **kw2)

    def groups(eng):
        return sorted(sorted(g) for g in eng.cohorts().values())

    assert groups(port) == groups(jax_)
    assert ["base0", "base1", "dt0", "dt1"] in groups(port)
    assert len(port.cohorts()) == len(VARIANTS) - 1


def test_advance_group_rejections():
    eng = SimulationEngine(device="cpu")
    eng.open_session("a", CavityMesh.cube(4, 2), dt=2e-3, alpha0=2,
                     adaptive=False)
    eng.open_session("b", CavityMesh.cube(4, 2), dt=2e-3, alpha0=2,
                     adaptive=False, program="simple")
    with pytest.raises(ValueError, match="not cohort-compatible"):
        eng.advance_group(["a", "b"], 1)
    with pytest.raises(ValueError, match="n_steps"):
        eng.advance_group(["a"], 0)
    with pytest.raises(KeyError):
        eng.step_all(1, sids=["nope"])
    with pytest.raises(ValueError, match="already open"):
        eng.open_session("a", CavityMesh.cube(4, 2), dt=2e-3)
    with pytest.raises(ValueError, match="priority"):
        eng.open_session("c", CavityMesh.cube(4, 2), dt=2e-3, priority="vip")
    # the full mesh opens (tests/test_torch_full_mesh.py); without a
    # shard mesh it takes the visible devices, and one CPU is too few
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        eng.open_session("c", CavityMesh.cube(4, 2), dt=2e-3,
                         solve_mode="full_mesh")
    with pytest.raises(ValueError, match="pipeline mode"):
        eng.open_session("c", CavityMesh.cube(4, 2), dt=2e-3, pipeline="x")
    # supervised engines take a fresh SupervisorConfig each
    sup = [SimulationEngine(device="cpu", supervise=True) for _ in range(2)]
    assert sup[0].supervisor_config == SupervisorConfig()
    assert sup[0].supervisor_config is not sup[1].supervisor_config
    assert eng.supervisor_config is None and eng.failed == {}
    with pytest.raises(ValueError, match="scan_window"):
        SimulationEngine(device="cpu", scan_window=0)


def test_lane_classes_pad_with_filler_lanes_and_change_nothing():
    runs = {}
    for lane_classes in (False, True):
        eng = SimulationEngine(device="cpu", lane_classes=lane_classes)
        for i, parts in enumerate((2, 3, 4)):
            mesh = CavityMesh(nx=4, ny=4, nz=parts, n_parts=parts, h=0.025)
            eng.open_session(f"s{i}", mesh, dt=DTS[i], alpha0=1,
                             adaptive=False, pad_to_class=4)
        eng.step_all(2)
        runs[lane_classes] = eng
    lead = runs[True].sessions["s0"].solver
    assert 4 in lead._exec._batched_pipelined
    assert 3 in runs[False].sessions["s0"].solver._exec._batched_pipelined
    for sid in runs[True].sessions:
        assert all(torch.equal(a, b) for a, b in zip(
            runs[True].sessions[sid].state, runs[False].sessions[sid].state))
    assert runs[True].counters["cohort_dispatches"] == 1


def test_accounting_and_default_config():
    a, b = SimulationEngine(device="cpu"), SimulationEngine(device="cpu")
    assert a.config is not b.config
    eng = SimulationEngine(device="cpu", track_latency=True)
    for i in range(2):
        eng.open_session(f"s{i}", CavityMesh.cube(4, 2), dt=2e-3, alpha0=2,
                         adaptive=False, priority=("bulk", "deadline")[i],
                         deadline_ms=(None, 5.0)[i])
    eng.step_all(2)
    lat = eng.latency_stats()
    assert set(lat["classes"]) == {"bulk", "deadline"}
    assert lat["per_session"]["s0"]["n"] == 2
    eng.reset_stats()
    assert not any(eng.counters.values())
    assert not any(eng.dispatch_paths.values())
    assert eng.latency_stats() == {"per_session": {}, "classes": {}}
    assert eng.plan_cache.stats()["hits"] == 0
    final = eng.close_session("s0")
    assert final["alpha"] == 2 and "s0" not in eng.sessions


def test_serve_cli_on_the_cpu(capsys):
    stats = serve_main(["--device", "cpu", "--sessions", "3", "--steps", "2",
                        "--cfd-n", "4", "--parts", "2"])
    out = capsys.readouterr().out
    assert "opened 3 sessions, cohorts=[3]" in out
    # the warm-up request and the timed one: one cohort window each
    assert stats["counters"]["cohort_dispatches"] == 2
    assert stats["dispatch_paths"]["pipelined_cohort"] == 2
    # no sessions and nothing to resume: nothing to serve
    with pytest.raises(SystemExit):
        serve_main(["--device", "cpu"])
    assert "--sessions N" in capsys.readouterr().err
