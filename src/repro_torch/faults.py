"""Deterministic fault injection for the serving engine (chaos harness).

The port of the JAX package's ``faults.py``.  Supervision code that only
real divergences exercise is untestable; this module manufactures the
failure modes on demand, **deterministically** (a seeded ``numpy``
generator draws the schedule, injectors replace session state between
windows), so runs replay identical fault sequences — the same schedule as
the JAX package's for the same arguments:

* ``nan`` — a NaN in one velocity component (the classic silent
  divergence: the next window's momentum assembly poisons the lane, the
  Krylov condition sees a NaN residual and exits at 0 iterations, and the
  step's ``isfinite`` reduction raises ``StepStats.diverged``).
* ``blowup`` — scale U and p by 1e200: the next assembly overflows to
  inf (a residual blow-up rather than a point NaN).
* ``cap`` — clamp the session's pressure solve to an unreachable
  tolerance at a tiny ``p_maxiter`` and rebuild its executors: every later
  step exits at the cap, raising ``hit_cap`` without any non-finite value.
* ``slow`` — inflate the next few controller samples' measured solve
  time 50×: a performance fault, not a health fault — the supervisor must
  NOT trip, and the controller's hysteresis is what absorbs it.

Injectors are functional: each builds new tensors and never writes into
the session's tensors, which may be views of a cohort buffer or share
storage with a checkpoint.  :class:`ChaosMonkey` is wired through
``launch/serve.py --chaos`` and driven by :meth:`ChaosMonkey.poke` between
engine windows.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["KINDS", "FaultEvent", "ChaosMonkey", "parse_kinds"]

KINDS = ("nan", "blowup", "cap", "slow")


def parse_kinds(spec: str) -> tuple[str, ...]:
    """Parse a ``--chaos`` argument: comma-separated kinds, or ``all``."""
    if spec in ("all", ""):
        return KINDS
    kinds = tuple(k.strip() for k in spec.split(",") if k.strip())
    unknown = [k for k in kinds if k not in KINDS]
    if unknown:
        raise ValueError(f"unknown fault kind(s) {unknown}; pick from "
                         f"{KINDS} or 'all'")
    return kinds


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled injection: fires once the target session's
    ``steps_done`` reaches ``step``."""

    step: int
    sid: str
    kind: str


class ChaosMonkey:
    """A seeded schedule of :class:`FaultEvent`\\ s over a session set.

    ``n_events`` defaults to one fault per two sessions (at least one);
    steps are drawn uniformly from ``[1, horizon)``.  The same
    ``(seed, sids, kinds, horizon)`` always yields the same schedule.
    """

    def __init__(self, seed: int, sids, kinds=KINDS,
                 n_events: int | None = None, horizon: int = 32):
        sids = list(sids)
        if not sids:
            raise ValueError("ChaosMonkey needs at least one session id")
        rng = np.random.default_rng(seed)
        if n_events is None:
            n_events = max(1, len(sids) // 2)
        self.events = sorted(
            (FaultEvent(step=int(rng.integers(1, max(2, horizon))),
                        sid=sids[int(rng.integers(len(sids)))],
                        kind=kinds[int(rng.integers(len(kinds)))])
             for _ in range(n_events)),
            key=lambda e: (e.step, e.sid))
        self.applied: list[FaultEvent] = []
        self._done: set[int] = set()

    def poke(self, engine) -> list[FaultEvent]:
        """Apply every not-yet-fired event whose target session has
        reached its step (call between windows — injectors replace host-
        side session state, never an executor mid-flight).  Returns the
        events applied by this call."""
        fired = []
        for i, ev in enumerate(self.events):
            if i in self._done:
                continue
            sess = engine.sessions.get(ev.sid)
            if sess is None:
                # target already failed/closed: the event is moot
                self._done.add(i)
                continue
            if sess.steps_done >= ev.step:
                getattr(self, f"_inject_{ev.kind}")(sess)
                self._done.add(i)
                self.applied.append(ev)
                fired.append(ev)
        return fired

    # ---- injectors -------------------------------------------------------
    @staticmethod
    def _inject_nan(sess) -> None:
        U = sess.state.U.clone()
        U[0, 0, 0] = float("nan")
        sess.state = sess.state._replace(U=U)

    @staticmethod
    def _inject_blowup(sess) -> None:
        sess.state = sess.state._replace(U=sess.state.U * 1e200,
                                         p=sess.state.p * 1e200)

    @staticmethod
    def _inject_cap(sess) -> None:
        # unreachable tolerance + tiny cap: every pressure solve from now
        # on exits at maxiter.  Drop the memoised bindings and rebind — a
        # host-side reconfiguration exactly like an operator pushing a bad
        # config.  The device loop captures its CUDA-graph blocks (which
        # bake in maxiter) per sweep, so the rebuilt binding recaptures
        # them; a later cache of graphs across steps must key them on the
        # tolerances and caps.
        sess.solver.p_tol = 1e-30
        sess.solver.p_maxiter = 2
        sess.solver._bindings.clear()
        sess.solver.rebind_alpha(sess.solver.alpha)

    @staticmethod
    def _inject_slow(sess, factor: float = 50.0, n_samples: int = 4) -> None:
        orig = sess.controller.step
        left = {"n": n_samples}

        def slow_step(sample):
            if left["n"] > 0:
                left["n"] -= 1
                sample = dataclasses.replace(sample,
                                             solve=sample.solve * factor)
            return orig(sample)

        sess.controller.step = slow_step
