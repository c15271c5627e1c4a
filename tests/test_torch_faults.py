"""The port's fault-injection harness against the JAX package's, on the CPU.

``parse_kinds``; ``ChaosMonkey`` schedules equal to JAX's event for event;
``poke`` firing each event once and skipping closed sessions; and each
injector replacing a session's state without writing into the cohort
buffer its leaves are views of (so neither its cohort-mates nor its
checkpoint move), with the same values as JAX's injector.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.faults import ChaosMonkey as JaxMonkey
from repro.fvm.piso import PisoState as JaxState

from repro_torch.core.cost_model import PhaseBreakdown
from repro_torch.faults import KINDS, ChaosMonkey, FaultEvent, parse_kinds
from repro_torch.fvm.mesh import CavityMesh
from repro_torch.fvm.piso import make_solver, stack_states, unstack_states
from repro_torch.serving.supervisor import SessionSupervisor


def test_parse_kinds():
    assert parse_kinds("all") == parse_kinds("") == KINDS
    assert parse_kinds("nan, cap") == ("nan", "cap")
    with pytest.raises(ValueError, match="gremlin"):
        parse_kinds("nan,gremlin")


SCHEDULES = [
    (0, ["a", "b", "c", "d"], KINDS, None, 16),
    (7, ["tenant0", "tenant1", "tenant2"], KINDS, 5, 32),
    (123, ["x"], ("nan", "slow"), 3, 2),
    (2024, [f"s{i}" for i in range(9)], ("cap",), None, 100),
]


@pytest.mark.parametrize("seed, sids, kinds, n_events, horizon", SCHEDULES)
def test_schedule_matches_jax(seed, sids, kinds, n_events, horizon):
    port = ChaosMonkey(seed, sids, kinds=kinds, n_events=n_events,
                       horizon=horizon)
    ref = JaxMonkey(seed, sids, kinds=kinds, n_events=n_events,
                    horizon=horizon)
    assert [dataclasses.astuple(e) for e in port.events] == \
        [dataclasses.astuple(e) for e in ref.events]
    assert port.events == sorted(port.events, key=lambda e: (e.step, e.sid))
    with pytest.raises(ValueError, match="at least one"):
        ChaosMonkey(seed, [])


def test_poke_fires_once_and_skips_closed_sessions():
    calls = []

    class Ctl:
        def step(self, sample):
            calls.append(sample)
            return 1

    sess = types.SimpleNamespace(steps_done=4, controller=Ctl())
    eng = types.SimpleNamespace(sessions={"a": sess})
    monkey = ChaosMonkey(0, ["a", "gone"], kinds=("slow",), n_events=4,
                         horizon=3)
    fired = monkey.poke(eng)
    assert fired == [e for e in monkey.events if e.sid == "a"]
    assert monkey.applied == fired
    assert monkey.poke(eng) == []           # every event fired or moot
    assert len(monkey._done) == len(monkey.events)
    # a session short of its step waits for it
    late = ChaosMonkey(0, ["a"], kinds=("slow",), n_events=1, horizon=3)
    late.events = [FaultEvent(step=9, sid="a", kind="slow")]
    assert late.poke(eng) == []
    sess.steps_done = 9
    assert late.poke(eng) == late.events


def _cohort():
    """Three lanes of a cavity state, stacked, and lane 1 as a session
    whose leaves are views of the stack, checkpointed."""
    solver = make_solver("piso", CavityMesh.cube(4, 2), alpha=2,
                         device="cpu")
    gen = np.random.default_rng(0)
    lanes = [type(s)(*(torch.tensor(gen.standard_normal(t.shape))
                       for t in s)) for s in [solver.initial_state()] * 3]
    stacked = stack_states(lanes)
    state = unstack_states(stacked)[1]
    sup = SessionSupervisor()
    sup.checkpoint(state, 4)
    sess = types.SimpleNamespace(state=state, supervisor=sup, solver=solver,
                                 steps_done=4)
    return stacked, sess


@pytest.mark.parametrize("kind", ["nan", "blowup"])
def test_state_injectors_are_functional_and_match_jax(kind):
    stacked, sess = _cohort()
    before = type(stacked)(*(t.clone() for t in stacked))
    lane = type(sess.state)(*(t.numpy().copy() for t in sess.state))
    getattr(ChaosMonkey, f"_inject_{kind}")(sess)
    # the cohort buffer (every lane, this one's view included) and the
    # checkpoint are untouched
    assert all(torch.equal(a, b) for a, b in zip(stacked, before))
    assert all(torch.equal(a, b[1])
               for a, b in zip(sess.supervisor.last_good[0], before))
    # the same values as JAX's injector on the same lane
    ref = types.SimpleNamespace(state=JaxState(*(jnp.asarray(a)
                                                 for a in lane)))
    getattr(JaxMonkey, f"_inject_{kind}")(ref)
    for f in JaxState._fields:
        np.testing.assert_array_equal(getattr(sess.state, f).numpy(),
                                      np.asarray(getattr(ref.state, f)),
                                      err_msg=f)
    bad = sess.state.U if kind == "nan" else sess.state.p
    assert not torch.isfinite(bad).all() or float(bad.abs().max()) > 1e199


def test_cap_injector_rebuilds_the_binding_at_the_cap():
    stacked, sess = _cohort()
    before = type(stacked)(*(t.clone() for t in stacked))
    old = dict(sess.solver._bindings)
    ChaosMonkey._inject_cap(sess)
    s = sess.solver
    assert (s.p_tol, s.p_maxiter) == (1e-30, 2)
    assert list(s._bindings) == list(old)
    assert all(s._bindings[k][1] is not old[k][1] for k in old)
    assert all(torch.equal(a, b) for a, b in zip(stacked, before))
    _, stats = s.step(sess.supervisor.rollback()[0], 1e-3)
    assert bool(stats.hit_cap) and not bool(stats.diverged)
    assert stats.p_iters.tolist() == [2, 2]


def test_slow_injector_inflates_four_samples():
    seen = []
    ctl = types.SimpleNamespace(step=lambda s: seen.append(s.solve) or 1)
    sess = types.SimpleNamespace(controller=ctl)
    ChaosMonkey._inject_slow(sess)
    for _ in range(6):
        sess.controller.step(PhaseBreakdown(assembly=1.0, update=0.1,
                                            halo=0.0, solve=2.0))
    assert seen == [100.0] * 4 + [2.0] * 2
