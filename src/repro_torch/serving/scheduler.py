"""Continuous-batching scheduler: size-class cohorts, arrivals, deadlines.

The port's own copy of the JAX package's ``serving/scheduler.py`` policy
core (plain Python, statement for statement).  Cohort batching merges only sessions whose program key matches
exactly, so a realistic tenant mix fragments into singleton cohorts — one
dispatch per tenant, the undersubscribed regime the paper diagnoses for a
single solver, at serving scale.  The cure, in three parts:

**Size classes.**  :func:`size_class` buckets part counts into powers of
two; :func:`pad_mesh` zero-pads a mesh's slab axis to its class
(:class:`~repro_torch.fvm.mesh.PaddedCavityMesh`).  Tenants whose meshes
share a per-part structure ``(nx, ny, nzl, h)`` but differ in slab count
then share a mesh fingerprint — ONE cohort, with each lane's real size
riding along as the ``n_active`` operand.

**Continuous admission/eviction.**  :class:`CohortScheduler` runs in
rounds.  Each round admits due arrivals, groups active sessions by the
cohort key, dispatches chosen cohorts for ONE window stretch
(``SimulationEngine.advance_group``), and evicts sessions that finished.

**Priority/deadline policy.**  Sessions carry a priority class
(:data:`DEADLINE` | :data:`BULK`).  At each round, deadline cohorts
dispatch first (earliest ``deadline_ms`` first) and bulk cohorts are
deferred — unless a bulk cohort has waited ``max_wait_rounds`` rounds.
Every decision lands in an ``events`` log and per-session-step latencies
(queueing included) feed nearest-rank p50/p99 accounting per class.

The core is engine-agnostic — ``dispatch``/``key_fn`` hooks and an
injectable clock (:class:`VirtualClock`) — and :class:`EngineScheduler` is
the adapter over :class:`~repro_torch.serving.engine.SimulationEngine`.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import time

__all__ = ["BULK", "DEADLINE", "size_class", "pad_mesh", "percentile",
           "SessionSpec", "VirtualClock", "CohortScheduler",
           "EngineScheduler"]

BULK = "bulk"
DEADLINE = "deadline"


def size_class(n: int, floor: int = 1) -> int:
    """The smallest power of two >= ``max(n, floor)`` — the padded size
    class ``n`` buckets into (parts of a mesh, lanes of a cohort)."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    return 1 << (max(n, floor) - 1).bit_length()


def pad_mesh(mesh, n_parts: int | None = None):
    """Pad ``mesh`` to its power-of-two size class (or an explicit
    ``n_parts`` class).  Already-padded meshes pass through unchanged."""
    from repro_torch.fvm.mesh import PaddedCavityMesh

    if isinstance(mesh, PaddedCavityMesh):
        return mesh
    cls = size_class(mesh.n_parts) if n_parts is None else n_parts
    return PaddedCavityMesh.pad(mesh, cls)


def percentile(samples, q: float) -> float:
    """Nearest-rank percentile: the smallest sample such that at least
    ``q``% of the data is <= it (exact on hand-computable traces — no
    interpolation, so p50 of [1,2,3,4] is 2, p99 of 100 samples is the
    99th order statistic)."""
    if not samples:
        raise ValueError("percentile of an empty sample set")
    if not 0 < q <= 100:
        raise ValueError(f"q must be in (0, 100], got {q}")
    xs = sorted(samples)
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


@dataclasses.dataclass(frozen=True)
class SessionSpec:
    """One tenant's admission request (what :meth:`CohortScheduler.submit`
    queues): the mesh and timestep, total steps wanted, arrival time on
    the scheduler's clock, and the scheduling-policy class."""

    sid: str
    mesh: object
    dt: float
    n_steps: int
    arrival_t: float = 0.0
    priority: str = BULK
    deadline_ms: float | None = None
    # extra SimulationEngine.open_session kwargs (nu, adaptive, alpha0,
    # solver_backend, ...) applied by the EngineScheduler adapter
    open_kwargs: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.priority not in (BULK, DEADLINE):
            raise ValueError(f"unknown priority {self.priority!r}")
        if self.n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {self.n_steps}")


class VirtualClock:
    """A monotonically advanced fake clock (seconds).  The deterministic
    scheduler harness drives it explicitly; the EngineScheduler advances
    it by measured wall time per dispatch so virtual arrival schedules
    and real execution costs share one timeline."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance a clock backwards ({dt})")
        self.t += dt
        return self.t


class CohortScheduler:
    """The policy core: rounds of admit → group → prioritize → dispatch →
    evict, engine-agnostic via two hooks.

    ``dispatch(sids, n_steps) -> chunk`` advances one cohort by one
    stretch (at most ``n_steps`` steps) and returns how many steps it
    actually ran; ``key_fn(sid)`` is the cohort grouping key (program
    interchangeability).  ``on_admit(spec)`` / ``on_evict(sid)`` fire at
    the matching boundaries — the EngineScheduler opens/closes engine
    sessions there.

    Per-session-step latency is booked from the session's *last progress
    point* (arrival for the first dispatch), so time spent deferred in
    the queue counts against the session — the meter that makes the
    deadline-vs-bulk p99 ordering observable.
    """

    def __init__(self, dispatch, key_fn, clock=None,
                 max_wait_rounds: int = 4, on_admit=None, on_evict=None):
        if max_wait_rounds < 1:
            raise ValueError("max_wait_rounds must be >= 1")
        self.dispatch = dispatch
        self.key_fn = key_fn
        self.clock = VirtualClock() if clock is None else clock
        self.max_wait_rounds = max_wait_rounds
        self.on_admit = on_admit
        self.on_evict = on_evict
        self.pending: list[tuple] = []   # heap of (arrival_t, seq, spec)
        self._seq = 0
        # sid -> {"spec", "remaining", "last_t", "wait_rounds"}
        self.active: dict[str, dict] = {}
        self.samples: dict[str, list[float]] = {}
        self.priority_of: dict[str, str] = {}
        self.events: list[dict] = []
        self.rounds = 0
        self.dispatches = 0

    # ---- submission ----------------------------------------------------
    def submit(self, spec: SessionSpec) -> None:
        """Queue an arrival; it is admitted at the first round whose clock
        has reached ``spec.arrival_t`` (continuous batching: submissions
        may interleave with rounds)."""
        heapq.heappush(self.pending, (spec.arrival_t, self._seq, spec))
        self._seq += 1

    def _log(self, kind: str, **fields) -> None:
        self.events.append({"round": self.rounds, "kind": kind, **fields})

    def _admit_due(self, now: float) -> int:
        due = []
        while self.pending and self.pending[0][0] <= now:
            due.append(heapq.heappop(self.pending))
        # admission order: arrival time, deadline class before bulk among
        # simultaneous arrivals, then submission order — deterministic
        due.sort(key=lambda t: (t[0], 0 if t[2].priority == DEADLINE else 1,
                                t[1]))
        for arrival_t, _seq, spec in due:
            if spec.sid in self.active:
                raise ValueError(f"session {spec.sid!r} already active")
            self.active[spec.sid] = {"spec": spec,
                                     "remaining": spec.n_steps,
                                     "last_t": arrival_t,
                                     "wait_rounds": 0}
            self.samples.setdefault(spec.sid, [])
            self.priority_of[spec.sid] = spec.priority
            if self.on_admit is not None:
                self.on_admit(spec)
            self._log("admit", sid=spec.sid, t=now,
                      priority=spec.priority)
        return len(due)

    # ---- the scheduling round ------------------------------------------
    def round(self) -> bool:
        """One scheduling round; returns False when idle (nothing active
        and no arrival reachable — callers stop their loop)."""
        self.rounds += 1
        now = self.clock.now()
        self._admit_due(now)
        if not self.active:
            # fast-forward an advanceable clock to the next arrival; a
            # wall clock cannot be advanced, so the round reports idle
            if self.pending and hasattr(self.clock, "advance"):
                self.clock.advance(max(0.0, self.pending[0][0] - now))
                self._admit_due(self.clock.now())
            if not self.active:
                return False
        groups: dict[object, list[str]] = {}
        for sid in self.active:   # insertion order == admission order
            groups.setdefault(self.key_fn(sid), []).append(sid)
        deadline_groups, bulk_groups = [], []
        for key, sids in groups.items():
            dls = [self.active[s]["spec"].deadline_ms for s in sids
                   if self.active[s]["spec"].priority == DEADLINE]
            if dls:
                urgency = min((d for d in dls if d is not None),
                              default=float("inf"))
                deadline_groups.append((urgency, key, sids))
            else:
                bulk_groups.append((key, sids))
        # earliest-deadline-first; stable sort keeps admission order on ties
        deadline_groups.sort(key=lambda t: t[0])
        overdue = [(key, sids) for key, sids in bulk_groups
                   if max(self.active[s]["wait_rounds"] for s in sids)
                   >= self.max_wait_rounds]
        if deadline_groups:
            # deadline cohorts preempt bulk — except bulk cohorts whose
            # wait crossed max_wait_rounds (the anti-starvation override)
            dispatch_list = [(k, sids) for _, k, sids in deadline_groups]
            dispatch_list += overdue
            deferred = [g for g in bulk_groups if g not in overdue]
        else:
            dispatch_list = bulk_groups
            deferred = []
        for key, sids in deferred:
            for s in sids:
                self.active[s]["wait_rounds"] += 1
            self._log("defer", sids=tuple(sids), t=now, key=str(key))
        for key, sids in dispatch_list:
            # an earlier dispatch this round may have evicted/failed a
            # member (supervised engine closure, external cancellation) —
            # dispatch only what is still active, and skip drained groups
            alive = [s for s in sids if s in self.active]
            if not alive:
                continue
            n = min(self.active[s]["remaining"] for s in alive)
            chunk = self.dispatch(list(alive), n)
            self.dispatches += 1
            t1 = self.clock.now()
            self._log("dispatch", sids=tuple(alive), chunk=chunk, t=t1,
                      key=str(key))
            for s in alive:
                st = self.active.get(s)
                if st is None:
                    # evicted inside the dispatch itself: its queueing
                    # time stops counting toward the p50/p99 meters at
                    # the moment of removal — book nothing
                    continue
                if chunk > 0:
                    per_step = (t1 - st["last_t"]) / chunk
                    self.samples[s].extend([per_step] * chunk)
                    st["remaining"] -= chunk
                st["last_t"] = t1
                st["wait_rounds"] = 0
        # evictions happen at the window boundary just crossed
        for sid in [s for s, st in self.active.items()
                    if st["remaining"] <= 0]:
            self._evict(sid)
        return True

    def _evict(self, sid: str) -> None:
        del self.active[sid]
        if self.on_evict is not None:
            self.on_evict(sid)
        self._log("evict", sid=sid, t=self.clock.now())

    def evict(self, sid: str) -> None:
        """Evict an active session early (external cancellation); takes
        effect immediately, between rounds."""
        if sid not in self.active:
            raise KeyError(f"session {sid!r} is not active")
        self._evict(sid)

    def run(self, max_rounds: int = 100_000) -> int:
        """Drive rounds until all submitted work is admitted, stepped and
        evicted (or the round cap trips); returns the rounds consumed."""
        start = self.rounds
        while self.pending or self.active:
            if self.rounds - start >= max_rounds:
                raise RuntimeError(
                    f"scheduler did not drain within {max_rounds} rounds")
            if not self.round():
                break
        return self.rounds - start

    # ---- accounting ----------------------------------------------------
    def latency_stats(self) -> dict:
        """Nearest-rank p50/p99 of per-session-step latency, per session
        and pooled per priority class (finished sessions included)."""
        per_session, pooled = {}, {}
        for sid, xs in self.samples.items():
            if xs:
                per_session[sid] = {"n": len(xs),
                                    "p50": percentile(xs, 50),
                                    "p99": percentile(xs, 99)}
            pooled.setdefault(self.priority_of[sid], []).extend(xs)
        classes = {prio: {"n": len(xs), "p50": percentile(xs, 50),
                          "p99": percentile(xs, 99)}
                   for prio, xs in pooled.items() if xs}
        return {"per_session": per_session, "classes": classes}

    def stats(self) -> dict:
        return {
            "rounds": self.rounds,
            "dispatches": self.dispatches,
            "active": len(self.active),
            "pending": len(self.pending),
            "events": len(self.events),
            "latency": self.latency_stats(),
        }

    def bookkeeping(self) -> dict:
        """JSON-serializable scheduler bookkeeping: per-active-session
        progress/wait state, round/dispatch counters and the booked
        latency samples — enough to audit or compare a scheduler run."""
        return {
            "rounds": self.rounds,
            "dispatches": self.dispatches,
            "max_wait_rounds": self.max_wait_rounds,
            "clock_t": self.clock.now(),
            "n_pending": len(self.pending),
            "active": {
                sid: {"remaining": st["remaining"],
                      "last_t": st["last_t"],
                      "wait_rounds": st["wait_rounds"],
                      "priority": st["spec"].priority}
                for sid, st in self.active.items()
            },
            "samples": {sid: list(xs) for sid, xs in self.samples.items()},
        }


class EngineScheduler:
    """The production adapter: :class:`CohortScheduler` policy over a
    :class:`~repro_torch.serving.engine.SimulationEngine`.

    Admission opens an engine session with the spec's mesh padded to its
    power-of-two size class (``pad=True``), so heterogeneous tenants
    sharing a per-part structure co-batch; dispatch advances one cohort
    by one rolled-window stretch (``engine.advance_group``) and advances
    the scheduler's virtual clock by the measured wall time, so queueing
    and execution share one timeline; eviction closes the session.
    """

    def __init__(self, engine, clock=None, max_wait_rounds: int = 4,
                 pad: bool = True):
        self.engine = engine
        self.clock = VirtualClock() if clock is None else clock
        self.pad = pad
        self.last_stats: dict[str, object] = {}
        self.core = CohortScheduler(
            dispatch=self._dispatch, key_fn=self._key, clock=self.clock,
            max_wait_rounds=max_wait_rounds, on_admit=self._admit,
            on_evict=self._evict)
        self.closed: dict[str, dict] = {}

    def submit(self, spec: SessionSpec) -> None:
        self.core.submit(spec)

    def _admit(self, spec: SessionSpec) -> None:
        kwargs = dict(spec.open_kwargs)
        if self.pad and "pad_to_class" not in kwargs:
            from repro_torch.fvm.mesh import PaddedCavityMesh

            if not isinstance(spec.mesh, PaddedCavityMesh):
                kwargs["pad_to_class"] = size_class(spec.mesh.n_parts)
        self.engine.open_session(spec.sid, spec.mesh, dt=spec.dt,
                                 priority=spec.priority,
                                 deadline_ms=spec.deadline_ms, **kwargs)

    def _key(self, sid: str):
        return self.engine._cohort_key(self.engine.sessions[sid])

    def _dispatch(self, sids, n_steps: int) -> int:
        alive = [s for s in sids if s in self.engine.sessions]
        if not alive:
            return 0
        t0 = time.perf_counter()
        chunk = self.engine.advance_group(alive, n_steps, self.last_stats)
        if hasattr(self.clock, "advance"):
            self.clock.advance(time.perf_counter() - t0)
        # a supervised session may have FAILED inside the dispatch (the
        # engine closed it already) — sync the policy core's bookkeeping
        # so the heap/active maps never desync from the engine
        for s in alive:
            if s not in self.engine.sessions and s in self.core.active:
                self.core._evict(s)
        return chunk

    def _evict(self, sid: str) -> None:
        if sid in self.engine.sessions:
            self.closed[sid] = self.engine.close_session(sid)
        else:
            # already closed engine-side (supervised failure): keep the
            # post-mortem instead of double-closing
            self.closed[sid] = getattr(self.engine, "failed", {}).get(sid,
                                                                      {})

    def round(self) -> bool:
        return self.core.round()

    def run(self, max_rounds: int = 100_000) -> int:
        return self.core.run(max_rounds)

    def stats(self) -> dict:
        out = self.core.stats()
        out["engine"] = self.engine.stats()
        return out

    def bookkeeping(self) -> dict:
        return self.core.bookkeeping()

    def snapshot(self, path) -> None:
        """Engine snapshot with this scheduler's bookkeeping attached."""
        self.engine.snapshot(path, scheduler=self)
