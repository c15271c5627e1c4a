"""The port's scheduler against the JAX package's, on the CPU.

The policy core (plain Python in both) replays the same seeded
virtual-clock arrival traces against the same fake executor: equal
``bookkeeping()``, event logs and stats.  The helpers (``size_class``,
``pad_mesh``, ``percentile``, ``SessionSpec``) agree, and
``EngineScheduler`` runs the tiny size-class mix end to end on both
packages' engines with a deterministic clock: equal bookkeeping and final
states within 1e-10.
"""
import types

import numpy as np
import pytest
import torch

from repro.core.controller import ControllerConfig as JaxConfig
from repro.fvm.mesh import CavityMesh as JaxMesh
from repro.serving import scheduler as jsched
from repro.serving.engine import SimulationEngine as JaxEngine
from sched_sim import poisson_trace

from repro_torch.core.controller import ControllerConfig
from repro_torch.fvm.mesh import CavityMesh, PaddedCavityMesh
from repro_torch.launch.serve import mesh_mix
from repro_torch.serving import scheduler as psched
from repro_torch.serving.engine import SimulationEngine

PARITY = 1e-10


def _fake(clock, calls, scan_window=8):
    """The harness's fake executor: one launch plus weak per-lane cost."""
    def dispatch(sids, n_steps):
        chunk = min(int(n_steps), scan_window)
        clock.advance(1.0 + 0.25 * len(sids))
        calls.append((tuple(sids), chunk, clock.now()))
        return chunk
    return dispatch


def _run(mod, trace, max_wait_rounds):
    clock = mod.VirtualClock()
    calls, admitted, evicted = [], [], []
    specs = [mod.SessionSpec(sid=s.sid, mesh=s.mesh, dt=s.dt,
                             n_steps=s.n_steps, arrival_t=s.arrival_t,
                             priority=s.priority, deadline_ms=s.deadline_ms)
             for s in trace]
    keys = {s.sid: s.mesh for s in specs}
    sched = mod.CohortScheduler(
        dispatch=_fake(clock, calls), key_fn=keys.__getitem__, clock=clock,
        max_wait_rounds=max_wait_rounds,
        on_admit=lambda sp: admitted.append(sp.sid),
        on_evict=evicted.append)
    for s in specs:
        sched.submit(s)
    rounds = sched.run()
    return sched, rounds, calls, admitted, evicted


@pytest.mark.parametrize("seed,n,rate,waits", [
    (0, 24, 2.0, 4), (1, 40, 8.0, 2), (2, 16, 0.5, 1), (3, 32, 4.0, 6)])
def test_policy_core_replays_jax_traces(seed, n, rate, waits):
    trace = poisson_trace(seed, n, rate, classes=("cls4", "cls8", "cls16"),
                          n_steps=12, deadline_frac=0.3)
    got = _run(psched, trace, waits)
    want = _run(jsched, trace, waits)
    assert got[1:] == want[1:]
    assert got[0].bookkeeping() == want[0].bookkeeping()
    assert got[0].events == want[0].events
    assert got[0].stats() == want[0].stats()


def test_helpers_match_jax():
    for n in range(1, 40):
        assert psched.size_class(n) == jsched.size_class(n)
        assert psched.size_class(n, floor=8) == jsched.size_class(n, floor=8)
    rng = np.random.default_rng(0)
    for k in (1, 2, 7, 100):
        xs = list(rng.random(k))
        for q in (1, 50, 99, 100):
            assert psched.percentile(xs, q) == jsched.percentile(xs, q)
    for bad in (lambda m: m.size_class(0),
                lambda m: m.percentile([], 50),
                lambda m: m.percentile([1.0], 0),
                lambda m: m.SessionSpec("a", None, 1.0, 0),
                lambda m: m.SessionSpec("a", None, 1.0, 1, priority="vip"),
                lambda m: m.VirtualClock().advance(-1)):
        for mod in (psched, jsched):
            with pytest.raises(ValueError):
                bad(mod)
    mesh = CavityMesh(nx=4, ny=4, nz=3, n_parts=3, h=0.025)
    padded = psched.pad_mesh(mesh)
    want = jsched.pad_mesh(JaxMesh(nx=4, ny=4, nz=3, n_parts=3, h=0.025))
    assert isinstance(padded, PaddedCavityMesh)
    assert (padded.n_parts, padded.n_parts_real) == (want.n_parts,
                                                     want.n_parts_real)
    assert psched.pad_mesh(padded) is padded
    assert psched.pad_mesh(mesh, 8).n_parts == 8


def _tick_clock(mod):
    """A virtual clock that every advance moves by one fixed tick, so both
    engines' schedules see the same timeline whatever the walls."""
    class Tick(mod.VirtualClock):
        def advance(self, dt):
            return super().advance(0.01)

    return Tick()


def _engine_run(mod, engine, mesh_cls, config_cls):
    args = types.SimpleNamespace(cfd_n=4, parts=4)
    meshes = mesh_mix(args)
    eng = engine(config=config_cls(sample_every=4), lane_classes=True,
                 track_latency=True)
    closed = {}
    close = eng.close_session

    def keep(sid):
        closed[sid] = eng.sessions[sid].state
        return close(sid)

    eng.close_session = keep
    sched = mod.EngineScheduler(eng, clock=_tick_clock(mod))
    for i in range(4):
        m = meshes[i % len(meshes)]
        sched.submit(mod.SessionSpec(
            sid=f"t{i}", mesh=mesh_cls(nx=m.nx, ny=m.ny, nz=m.nz,
                                       n_parts=m.n_parts, h=m.h),
            dt=0.5 * m.h * (1 + 0.1 * i), n_steps=2, arrival_t=0.005 * i,
            priority="deadline" if i == 1 else "bulk",
            deadline_ms=5.0 if i == 1 else None,
            open_kwargs={"adaptive": False, "alpha0": 1,
                         "pipeline": "off"}))
    sched.run()
    return sched, closed


def test_engine_scheduler_end_to_end_matches_jax():
    def port_engine(**kw):
        return SimulationEngine(device="cpu", **kw)

    def jax_engine(**kw):
        eng = JaxEngine(**kw)
        solver_open = eng.open_session

        def open_session(sid, mesh, **okw):
            return solver_open(sid, mesh, solver_backend="reference", **okw)

        eng.open_session = open_session
        return eng

    got, states = _engine_run(psched, port_engine, CavityMesh,
                              ControllerConfig)
    want, jstates = _engine_run(jsched, jax_engine, JaxMesh, JaxConfig)
    book, jbook = got.bookkeeping(), want.bookkeeping()
    assert book == jbook
    # the events name each cohort key, whose dtype and backend spell
    # differently in the two packages
    def events(sched):
        return [{k: v for k, v in ev.items() if k != "key"}
                for ev in sched.core.events]

    assert events(got) == events(want)
    assert got.core.dispatches < 4
    assert any(len(ev["sids"]) > 1 for ev in got.core.events
               if ev["kind"] == "dispatch")
    counters = got.engine.counters
    assert counters == want.engine.counters
    assert set(states) == set(jstates) == {f"t{i}" for i in range(4)}
    for sid, st in states.items():
        for f in st._fields:
            a = getattr(st, f).numpy()
            b = np.asarray(getattr(jstates[sid], f))
            assert float(np.abs(a - b).max()) <= PARITY * max(
                float(np.abs(b).max()), 1e-300), (sid, f)
    assert set(got.closed) == set(want.closed)
    assert torch.is_tensor(states["t0"].U)
