"""The port's session supervisor against the JAX package's, on the CPU.

The state machine fed the same verdict sequences in both packages
(directives, states, ``dt_scale``, event logs and ``to_dict()`` equal),
``from_dict`` across the packages both ways, ``window_verdict`` on the same
flag stacks, fresh clones from ``rollback``, and the precision ladder.
"""
import jax.numpy as jnp
import pytest
import torch

from repro.fvm.piso import StepStats as JaxStats
from repro.serving.supervisor import SessionSupervisor as JaxSupervisor
from repro.serving.supervisor import SupervisorConfig as JaxConfig
from repro.serving.supervisor import window_verdict as jax_verdict
from repro.solvers.precision import PRECISION_FALLBACK as JAX_FALLBACK

from repro_torch.fvm.piso import PisoState, StepStats
from repro_torch.serving.supervisor import (DEGRADED, FAILED, QUARANTINED,
                                            SessionSupervisor,
                                            SupervisorConfig, window_verdict)
from repro_torch.solvers.precision import PRECISION_FALLBACK

# each sequence: ("fault", kind) or ("clean",) per window
SEQUENCES = {
    "ladder_to_fail": [("fault", "diverged")] * 2 + [("fault", "hit_cap")] * 2,
    "recover_and_restore": [("fault", "diverged"), ("fault", "diverged"),
                            ("clean",), ("clean",), ("clean",),
                            ("fault", "diverged"), ("clean",), ("clean",),
                            ("clean",), ("clean",), ("clean",)],
    "clean_only": [("clean",)] * 3,
    "streak_reset": [("fault", "hit_cap"), ("clean",), ("fault", "hit_cap"),
                     ("clean",), ("clean",), ("clean",), ("clean",)],
}
CONFIGS = {
    "default": {},
    "tight": {"retry_budget": 1, "dt_backoff": 0.25, "recovery_windows": 1},
    "fallback": {"retry_budget": 5, "fallback_backend": "reference"},
}


def _drive(sup, seq):
    out = []
    for step, ev in enumerate(seq, start=1):
        if ev[0] == "fault":
            out.append(sup.on_fault(ev[1], 4 * step))
        else:
            out.append(sup.on_clean_window(4 * step))
        out.append((sup.state, sup.dt_scale, sup.retries_used,
                    sup.clean_windows))
    return out


@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("seq", SEQUENCES)
def test_state_machine_matches_jax(seq, cfg):
    port = SessionSupervisor(SupervisorConfig(**CONFIGS[cfg]))
    ref = JaxSupervisor(JaxConfig(**CONFIGS[cfg]))
    assert _drive(port, SEQUENCES[seq]) == _drive(ref, SEQUENCES[seq])
    assert port.to_dict() == ref.to_dict()
    assert port.healthy == ref.healthy


def test_escalation_ladder_and_fail():
    sup = SessionSupervisor(SupervisorConfig(retry_budget=3))
    assert sup.on_fault("diverged", 8) == "retry"
    assert (sup.state, sup.dt_scale) == (DEGRADED, 0.5)
    assert sup.on_fault("diverged", 8) == "quarantine"
    assert (sup.state, sup.dt_scale) == (QUARANTINED, 0.25)
    assert sup.on_fault("hit_cap", 8) == "retry"
    assert sup.on_fault("hit_cap", 8) == "fail"
    assert sup.state == FAILED
    assert sup.on_clean_window(12) == "none"


def test_from_dict_across_the_packages():
    port = SessionSupervisor(SupervisorConfig(retry_budget=5,
                                              fallback_backend="reference"))
    ref = JaxSupervisor(JaxConfig(retry_budget=5,
                                  fallback_backend="reference"))
    for sup in (port, ref):
        sup.on_fault("diverged", 8)
        sup.on_fault("diverged", 8)
        sup.on_clean_window(12)
        sup.orig_backend = "auto"
        sup.orig_precision = "bf16_ir"
    back = SessionSupervisor.from_dict(ref.to_dict())
    assert back.to_dict() == ref.to_dict() == port.to_dict()
    assert back.state == QUARANTINED and back.orig_precision == "bf16_ir"
    forth = JaxSupervisor.from_dict(port.to_dict())
    assert forth.to_dict() == port.to_dict()
    # a dict without the ladder origin (an older manifest) reads as None
    d = port.to_dict()
    d.pop("orig_precision")
    assert SessionSupervisor.from_dict(d).orig_precision is None


FLAG_STACKS = {
    "clean": ([False] * 4, [False] * 4),
    "one_nan": ([False, True, False, False], [False] * 4),
    "grazed_cap": ([False] * 4, [True, False, False, False]),
    "stuck": ([False] * 4, [True] * 4),
    "both": ([True] * 4, [True] * 4),
    "one_step": ([False], [True]),
}


@pytest.mark.parametrize("name", FLAG_STACKS)
def test_window_verdict_matches_jax(name):
    diverged, hit_cap = FLAG_STACKS[name]
    n = len(diverged)
    t = torch.tensor
    port = StepStats(t([0] * n), t([[0, 0]] * n), t([0.0] * n), t([0.0] * n),
                     ~t(diverged), t(diverged), t(hit_cap))
    ref = JaxStats(jnp.zeros(n), jnp.zeros((n, 2)), jnp.zeros(n),
                   jnp.zeros(n), ~jnp.asarray(diverged),
                   jnp.asarray(diverged), jnp.asarray(hit_cap))
    assert window_verdict(port) == jax_verdict(ref)
    # a sample step's stats are 0-d: the same verdict from one row
    row = StepStats(*(f[0] for f in port))
    assert window_verdict(row) == jax_verdict(
        JaxStats(*(f[0] for f in ref)))


def test_rollback_returns_fresh_clones():
    """A cohort member's leaves are views into the stacked tensor: the
    checkpoint and every rollback must be fresh storage."""
    cohort = torch.arange(2 * 5 * 6, dtype=torch.float64).reshape(2, 5, 6)
    state = PisoState(*(cohort[1] for _ in range(5)))
    sup = SessionSupervisor()
    sup.checkpoint(state, 12)
    cohort.zero_()          # the next window reuses the cohort buffer
    s1, n1 = sup.rollback()
    s2, n2 = sup.rollback()
    assert n1 == n2 == 12
    want = torch.arange(30, 60, dtype=torch.float64).reshape(5, 6)
    assert all(torch.equal(t, want) for t in s1)
    s1.U.fill_(-1.0)        # writing into one rollback ...
    assert torch.equal(s2.U, want)              # ... changes neither the next
    assert torch.equal(sup.last_good[0].U, want)  # ... nor the checkpoint
    assert torch.equal(sup.rollback()[0].U, want)
    assert s1.U.data_ptr() != s2.U.data_ptr() != sup.last_good[0].U.data_ptr()
    assert isinstance(s2, PisoState)


def test_precision_fallback_matches_jax():
    assert PRECISION_FALLBACK == JAX_FALLBACK
