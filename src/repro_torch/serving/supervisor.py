"""Session supervision: the divergence state machine for the engine.

The port of the JAX package's ``serving/supervisor.py``.  A multi-tenant
engine cannot assume every solve succeeds: a diverging session would
otherwise return NaN state silently, keep capping every later step, and
feed its garbage phase timings to the adaptive controller.  The step's
health signals (``StepStats.converged/diverged/hit_cap``, reduced on the
device by :func:`repro_torch.fvm.step_program.health_flags`) make the
failure observable; this module consumes them.

:class:`SessionSupervisor` is a per-session state machine over window
verdicts::

    HEALTHY ──fault──▶ DEGRADED ──fault──▶ QUARANTINED ──budget──▶ FAILED
       ▲                  │   ▲                │
       └── N clean ───────┘   └── N clean ─────┘

* **HEALTHY** — full dt, cohort-batched.  After every clean window the
  supervisor checkpoints a copy of the state (``last_good``) so a fault
  always has a pre-fault snapshot to retry from.
* **DEGRADED** — the fault rolled the session back to ``last_good`` and
  halved dt (``dt_backoff``); the session steps **solo** (its cohort key
  gains a per-sid token) so healthy cohort-mates keep their 1-dispatch
  window.  Each further fault burns one unit of ``retry_budget``.
* **QUARANTINED** — repeat offender: dt backs off again and, when
  ``fallback_backend`` is configured, the engine rebinds the session's
  Krylov backend (e.g. ``auto`` → ``reference``) for the retries.
* **FAILED** — retry budget exhausted; the engine closes the session and
  parks its final stats in ``engine.failed``.
* **Recovery** — ``recovery_windows`` consecutive clean windows step the
  machine back one level; reaching HEALTHY restores dt_scale = 1, the
  original backend, a fresh retry budget, and cohort membership.

The supervisor itself is engine-agnostic: it returns directives
("retry" / "quarantine" / "fail" / "recover" / "restore") and the engine
applies the side effects (rollback, rebind, close).  Everything except
the ``last_good`` tensors serializes via :meth:`to_dict`/:meth:`from_dict`
for the engine snapshot.

Checkpoints stay on the state's device: :meth:`~SessionSupervisor.
checkpoint` and :meth:`~SessionSupervisor.rollback` clone every leaf
there.  A leaf of a session's state after a cohort window is a view into
the stacked cohort tensor (:func:`repro_torch.fvm.piso.unstack_states`),
so a reference would alias buffers the next window reuses.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["HEALTHY", "DEGRADED", "QUARANTINED", "FAILED",
           "SupervisorConfig", "SupervisorEvent", "SessionSupervisor",
           "window_verdict"]

HEALTHY = "healthy"
DEGRADED = "degraded"
QUARANTINED = "quarantined"
FAILED = "failed"


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """Supervision policy knobs (engine-wide; state is per session)."""

    retry_budget: int = 3        # faults tolerated before FAILED
    dt_backoff: float = 0.5      # dt multiplier per escalation
    recovery_windows: int = 2    # clean windows per de-escalation level
    fallback_backend: str | None = None  # rebind target in QUARANTINED


@dataclasses.dataclass
class SupervisorEvent:
    """One audit-log entry: what happened to the session and when."""

    step: int
    kind: str     # "fault" | "degrade" | "quarantine" | "recover" |
                  # "restore" | "fail"
    detail: str = ""


def window_verdict(window_stats) -> str | None:
    """Classify one window's stacked stats: ``"diverged"`` if any step
    produced a non-finite leaf, ``"hit_cap"`` if every step exited a
    Krylov solve at maxiter (a single capped step in an otherwise clean
    window is tolerated — tight tolerances graze the cap transiently),
    else None.  Both reductions run on the flags' device and come back
    in one host read: the only sync of the supervision path."""
    diverged, all_capped = torch.stack(
        [window_stats.diverged.any(), window_stats.hit_cap.all()]).tolist()
    if diverged:
        return "diverged"
    if all_capped:
        return "hit_cap"
    return None


def _clone(state):
    """A fresh copy of every leaf of ``state``, on its device."""
    return type(state)(*(t.clone() for t in state))


class SessionSupervisor:
    """The per-session health state machine (see module docstring)."""

    def __init__(self, config: SupervisorConfig | None = None):
        self.config = SupervisorConfig() if config is None else config
        self.state = HEALTHY
        self.dt_scale = 1.0
        self.retries_used = 0
        self.clean_windows = 0
        self.events: list[SupervisorEvent] = []
        # (PisoState copy, steps_done) from the last verified-clean window
        self.last_good: tuple | None = None
        # set by the engine when it applies the fallback backend, so
        # recovery knows what to rebind back to
        self.orig_backend: str | None = None
        # likewise for the precision ladder (bf16_ir -> f32_ir -> f64):
        # the policy the tenant opened with, restored on full recovery
        self.orig_precision: str | None = None

    @property
    def healthy(self) -> bool:
        return self.state == HEALTHY

    # -- checkpointing -----------------------------------------------------
    def checkpoint(self, state, steps_done: int) -> None:
        """Store a **copy** of the state: a leaf of a cohort member's state
        is a view into the cohort's stacked tensor, which the next window
        replaces and whose storage a reference would keep alive."""
        self.last_good = (_clone(state), int(steps_done))

    def rollback(self) -> tuple:
        """A fresh copy of the pre-fault snapshot (fresh so a repeated
        fault can roll back to the same point again)."""
        assert self.last_good is not None, "no checkpoint to roll back to"
        state, steps_done = self.last_good
        return _clone(state), steps_done

    # -- verdict handling --------------------------------------------------
    def on_fault(self, kind: str, step: int) -> str:
        """Record a faulty window; returns the directive for the engine:
        ``"retry"`` (roll back and re-step), ``"quarantine"`` (roll back +
        apply the fallback backend) or ``"fail"`` (close the session)."""
        self.clean_windows = 0
        self.retries_used += 1
        self.events.append(SupervisorEvent(step, "fault", kind))
        if self.retries_used > self.config.retry_budget:
            self.state = FAILED
            self.events.append(SupervisorEvent(step, "fail",
                                               f"retries={self.retries_used}"))
            return "fail"
        if self.state == HEALTHY:
            self.state = DEGRADED
            self.dt_scale *= self.config.dt_backoff
            self.events.append(SupervisorEvent(
                step, "degrade", f"dt_scale={self.dt_scale:g}"))
            return "retry"
        if self.state == DEGRADED:
            self.state = QUARANTINED
            self.dt_scale *= self.config.dt_backoff
            self.events.append(SupervisorEvent(
                step, "quarantine", f"dt_scale={self.dt_scale:g}"))
            return "quarantine"
        return "retry"  # already QUARANTINED: keep burning the budget

    def on_clean_window(self, step: int) -> str:
        """Record a clean window; after ``recovery_windows`` of them the
        machine steps back one level.  Returns ``"recover"``
        (QUARANTINED → DEGRADED: the engine restores the original
        backend), ``"restore"`` (DEGRADED → HEALTHY: dt and cohort
        membership come back, budget refills) or ``"none"``."""
        if self.state in (HEALTHY, FAILED):
            return "none"
        self.clean_windows += 1
        if self.clean_windows < self.config.recovery_windows:
            return "none"
        self.clean_windows = 0
        if self.state == QUARANTINED:
            self.state = DEGRADED
            self.events.append(SupervisorEvent(step, "recover",
                                               "quarantined->degraded"))
            return "recover"
        self.state = HEALTHY
        self.dt_scale = 1.0
        self.retries_used = 0
        self.events.append(SupervisorEvent(step, "restore",
                                           "degraded->healthy"))
        return "restore"

    # -- serialization (scalars only; last_good tensors ride the engine
    # snapshot's npz) -------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "state": self.state,
            "dt_scale": self.dt_scale,
            "retries_used": self.retries_used,
            "clean_windows": self.clean_windows,
            "orig_backend": self.orig_backend,
            "orig_precision": self.orig_precision,
            "last_good_step": (None if self.last_good is None
                               else self.last_good[1]),
            "events": [dataclasses.asdict(e) for e in self.events],
            "config": dataclasses.asdict(self.config),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SessionSupervisor":
        sup = cls(SupervisorConfig(**d["config"]))
        sup.state = d["state"]
        sup.dt_scale = d["dt_scale"]
        sup.retries_used = d["retries_used"]
        sup.clean_windows = d["clean_windows"]
        sup.orig_backend = d["orig_backend"]
        sup.orig_precision = d.get("orig_precision")
        sup.events = [SupervisorEvent(**e) for e in d["events"]]
        return sup
