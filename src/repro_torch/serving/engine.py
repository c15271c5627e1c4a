"""Batched LM serving, and multi-tenant CFD serving: many simulations,
one card.

The port of the JAX package's ``serving/engine.py``.  Its LM half:
``start`` prefills a batch of prompts into a decode cache, ``serve_step``
decodes one greedy token for the whole batch, ``generate`` drives both
(``launch/serve.py --arch``).  Its CFD half:
:class:`SimulationEngine` hosts many concurrent segregated
simulations ("solver-as-a-service") — any registered ``(program, case)``
pair, transient PISO or steady SIMPLE — each with its **own**
:class:`~repro_torch.core.controller.RepartitionController` (per-session
calibration, so tenants adapt their alpha independently) while all
sessions share one :class:`~repro_torch.core.controller.PlanCache` (plans
are immutable and keyed by mesh fingerprint).

Sessions advance one at a time (:meth:`SimulationEngine.step_session`) or
— the throughput path — in **cohorts** (:meth:`SimulationEngine.step_all`):
open sessions whose step is interchangeable (same mesh structure, alpha,
backend, viscosity, program, case, pipelining, precision, ...) are stacked
along a leading session axis and advance through one batched executor per
window (:class:`~repro_torch.fvm.step_program.BatchedExecutor`), one set of
launches per phase for the whole cohort instead of one per tenant: the
batching cure for a card that one small tenant leaves mostly idle.

``supervise=True`` attaches a
:class:`~repro_torch.serving.supervisor.SessionSupervisor` to every
session: each window's health flags (one host read) roll a faulty session
back to its last clean checkpoint, which stays on the device, and step it
solo at a smaller dt, climbing the precision ladder (``bf16_ir → f32_ir →
f64``) and, when configured, a fallback backend.  :meth:`SimulationEngine.
snapshot` and :meth:`SimulationEngine.restore` checkpoint a whole engine
to disk and resume it exactly, in the JAX package's format (plus each
session's Krylov tolerances).
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import torch

from repro_torch.core.controller import (ControllerConfig, PlanCache,
                                         RepartitionController)
from repro_torch.core.cost_model import H100, CostModel
from repro_torch.serving.supervisor import (FAILED, SessionSupervisor,
                                            SupervisorConfig, window_verdict)
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.solvers.precision import PRECISION_FALLBACK

__all__ = ["ServeState", "serve_step", "start", "generate",
           "SimulationSession", "SimulationEngine"]


class ServeState(NamedTuple):
    cache: dict
    last_tokens: torch.Tensor  # (B, 1) int32
    pos: int                   # next write position


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    # torch.argmax, like jnp.argmax, returns the first maximum
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def serve_step(cfg: ModelConfig, params, state: ServeState):
    """One greedy decode step for the whole batch (the cache in place)."""
    logits, cache = lm.decode_step(cfg, params, state.cache,
                                   state.last_tokens, state.pos)
    nxt = _greedy(logits)
    return ServeState(cache=cache, last_tokens=nxt, pos=state.pos + 1), nxt


def start(cfg: ModelConfig, params, prompts: torch.Tensor, max_len: int,
          frontend=None) -> tuple[ServeState, torch.Tensor]:
    """Prefill the prompts and return the initial serve state."""
    logits, cache = lm.prefill(cfg, params, prompts, max_len,
                               frontend=frontend)
    first = _greedy(logits)
    n_prefix = cfg.frontend_len if cfg.frontend == "vision_stub" else 0
    pos = prompts.shape[1] + n_prefix
    return ServeState(cache=cache, last_tokens=first, pos=pos), first


def generate(cfg: ModelConfig, params, prompts: torch.Tensor, n_new: int,
             frontend=None) -> torch.Tensor:
    """Greedy generation of ``n_new`` tokens.  Returns (B, n_new) int32 on
    the prompts' device.

    ``n_new=0`` is a pure no-op: no prefill, no decode loop, an empty
    ``(B, 0)`` token block.
    """
    if n_new < 0:
        raise ValueError(f"n_new must be >= 0, got {n_new}")
    if n_new == 0:
        return torch.zeros((prompts.shape[0], 0), dtype=torch.int32,
                           device=prompts.device)
    max_len = prompts.shape[1] + n_new + (
        cfg.frontend_len if cfg.frontend == "vision_stub" else 0)
    state, first = start(cfg, params, prompts, max_len, frontend)
    outs = [first]
    for _ in range(n_new - 1):
        state, nxt = serve_step(cfg, params, state)
        outs.append(nxt)
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# CFD simulation serving — multi-tenant PISO with per-session adaptation.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimulationSession:
    """One tenant: a solver, its private controller, and its flow state."""

    sid: str
    solver: object                      # a SegregatedSolver
    controller: RepartitionController
    state: object                       # PisoState
    dt: float
    mesh_fp: str = ""                   # structural mesh hash (cohort key)
    adaptive: bool = True
    steps_done: int = 0
    # serving-policy metadata (consumed by serving.scheduler): priority
    # class and, for deadline tenants, the per-session-step target
    priority: str = "bulk"
    deadline_ms: float | None = None
    # per-session-step wall latencies (seconds), appended when the engine
    # runs with track_latency=True; stats() folds them into p50/p99
    latency_samples: list = dataclasses.field(default_factory=list)
    # health state machine (serving.supervisor) — None when the engine
    # runs unsupervised (the default)
    supervisor: SessionSupervisor | None = None


def _last(stats, index=(-1,)):
    """One step's stats out of stacked stats (``index`` into every leaf)."""
    return type(stats)(*(t[index] for t in stats))


def _restored_mesh(m: dict, device: torch.device):
    """A snapshotted session's explicit full mesh on the restoring engine's
    ``device``: each recorded shard device of another type (a snapshot
    taken on the card, restored on the CPU) becomes ``device``."""
    from repro_torch.core.comm import make_cfd_mesh

    devs = [d if torch.device(d).type == device.type else device
            for d in m["mesh_devices"]]
    alpha = int(m["alpha"])
    return make_cfd_mesh(len(devs) // alpha, alpha, devices=devs)


class SimulationEngine:
    """Concurrent simulations with independent adaptive repartitioning.

    Controller state is strictly per session; the :class:`PlanCache` is
    shared.  ``device`` is where every session runs (``"cuda"`` by default;
    ``"cpu"`` only when asked for).  ``scan_window`` caps the steps of one
    window; ``lane_classes`` pads every padded (size-class) cohort's batch
    to the next power of two with zero filler lanes (``n_active=0``), so a
    cohort whose occupancy drifts reuses one of a few batch shapes;
    ``track_latency`` books wall time per session-step (synchronising the
    card after each dispatch) on ``clock``.  ``supervise`` attaches a
    supervisor under ``supervisor_config`` (a fresh
    :class:`~repro_torch.serving.supervisor.SupervisorConfig` by default)
    to every session.
    """

    def __init__(self, plan_cache: PlanCache | None = None,
                 config: ControllerConfig | None = None,
                 scan_window: int = 8, lane_classes: bool = False,
                 track_latency: bool = False, clock=None,
                 supervise: bool = False, supervisor_config=None,
                 device: str | torch.device = "cuda"):
        from repro_torch.env import resolve_device

        self.device = resolve_device(device)
        # explicit None test: an empty PlanCache is falsy (it has __len__)
        self.plan_cache = PlanCache() if plan_cache is None else plan_cache
        # per-instance default: a shared ControllerConfig() default would
        # alias every engine built without a config to one object
        self.config = ControllerConfig() if config is None else config
        if scan_window < 1:
            raise ValueError("scan_window must be >= 1")
        self.scan_window = scan_window
        self.lane_classes = lane_classes
        self.track_latency = track_latency
        self._clock = time.perf_counter if clock is None else clock
        # supervised mode: every session gets a SessionSupervisor that
        # reads the health flags once a window, rolls faulty sessions back
        # to their last clean checkpoint, and escalates degraded →
        # quarantined → failed.  Opt-in: unsupervised engines are untouched
        self.supervise = supervise
        if supervise:
            self.supervisor_config = (SupervisorConfig()
                                      if supervisor_config is None
                                      else supervisor_config)
        else:
            self.supervisor_config = supervisor_config
        # failed sessions' post-mortems: sid -> final stats + event log
        self.failed: dict[str, dict] = {}
        self.sessions: dict[str, SimulationSession] = {}
        # dispatch accounting: "solo" counts single-session windows,
        # "cohort" one per batched cohort window
        self.counters = {"solo_dispatches": 0, "cohort_dispatches": 0,
                         "sample_steps": 0, "rolled_windows": 0,
                         "scheduling_rounds": 0}
        # which executor served each window (sample steps always run the
        # serial instrumented schedule and are not split here)
        self.dispatch_paths = {"solo": 0, "cohort": 0,
                               "pipelined_solo": 0, "pipelined_cohort": 0}

    def open_session(self, sid: str, mesh, *, dt: float,
                     alpha0: int | None = None, nu: float = 0.01,
                     model: CostModel | None = None,
                     adaptive: bool = True,
                     solve_mode: str = "stacked",
                     solver_backend: str = "auto",
                     pad_to_class: int | None = None,
                     priority: str = "bulk",
                     deadline_ms: float | None = None,
                     program: str = "piso",
                     case: str = "cavity",
                     pipeline: str = "auto",
                     precision: str = "f64",
                     **solver_kw) -> SimulationSession:
        """Admit a simulation; its controller starts from the cost model's
        static pick (``alpha0=None``) exactly like the non-adaptive
        launcher, then departs from it as measurements arrive.

        ``pad_to_class`` zero-pads the mesh's part axis to that **size
        class** (:class:`~repro_torch.fvm.mesh.PaddedCavityMesh`) so
        tenants whose meshes share a per-part structure but differ in slab
        count land in one cohort.  ``priority`` ("bulk" | "deadline") and
        ``deadline_ms`` feed the scheduling policy; they do not change the
        numerics.  ``program``, ``case``, ``pipeline`` ("auto" | "on" |
        "off") and ``precision`` pick the tenant's program, flow case,
        stepping schedule and Krylov policy; each is a cohort-key
        component.  ``solve_mode`` ("stacked" | "full_mesh") is one too,
        and a full-mesh session always steps alone; its shards' devices
        come in ``solver_kw`` as ``spmd_mesh``
        (:func:`~repro_torch.core.comm.make_cfd_mesh`), or from the
        visible devices; a stacked session takes no mesh (raises).  ``solver_kw`` are further solver settings
        (``p_tol``, ``p_maxiter``, ``mom_tol``, ...).  The default cost
        model is ``CostModel(H100, n_dofs=...)`` at the mesh's real dofs.
        """
        from repro_torch.core.repartition import mesh_fingerprint
        from repro_torch.fvm.mesh import PaddedCavityMesh
        from repro_torch.fvm.piso import PIPELINE_MODES, make_solver
        from repro_torch.fvm.step_program import get_program

        if sid in self.sessions:
            raise ValueError(f"session {sid!r} already open")
        if (solve_mode == "stacked"
                and solver_kw.get("spmd_mesh") is not None):
            raise ValueError("a stacked tenant takes no spmd_mesh: the "
                             "engine steps stacked tenants in cohorts on "
                             "its device")
        if priority not in ("bulk", "deadline"):
            raise ValueError(f"unknown priority {priority!r}")
        if pad_to_class is not None:
            mesh = PaddedCavityMesh.pad(mesh, pad_to_class)
        # cost honesty for padded meshes: ghost slabs carry no dofs
        n_dofs = getattr(mesh, "n_cells_active", mesh.n_cells_global)
        model = model or CostModel(H100, n_dofs=n_dofs)
        # resolve the pipeline knob against the program spec up front so
        # the controller's initial alpha pick scores the overlap objective
        if pipeline not in PIPELINE_MODES:
            raise ValueError(f"unknown pipeline mode {pipeline!r} "
                             "(choose auto|on|off)")
        pipelined = (pipeline == "on"
                     or (pipeline == "auto"
                         and get_program(program).pipelined))
        controller = RepartitionController(
            model, n_cpu=mesh.n_parts, n_gpu=1, alpha0=alpha0,
            config=self.config, cache=self.plan_cache, fixed_fine=True,
            solve_mode=solve_mode, solver_backend=solver_backend,
            pipelined=pipelined, precision=precision)
        solver = make_solver(program, mesh, alpha=controller.alpha, nu=nu,
                             case=case, plan_cache=self.plan_cache,
                             solver_backend=solver_backend,
                             pipeline=pipeline, precision=precision,
                             device=self.device, solve_mode=solve_mode,
                             **solver_kw)
        sess = SimulationSession(sid=sid, solver=solver,
                                 controller=controller,
                                 state=solver.initial_state(), dt=dt,
                                 mesh_fp=mesh_fingerprint(mesh),
                                 adaptive=adaptive, priority=priority,
                                 deadline_ms=deadline_ms)
        if self.supervise:
            sess.supervisor = SessionSupervisor(self.supervisor_config)
            # the initial condition is by definition a clean snapshot
            sess.supervisor.checkpoint(sess.state, 0)
        self.sessions[sid] = sess
        return sess

    def step_session(self, sid: str, n_steps: int = 1):
        """Advance one tenant; other sessions' controllers are untouched.

        Non-sample steps advance in windows of the solver's stepper, and
        every ``ControllerConfig.sample_every``-th step of an adaptive
        session is an instrumented sample whose ``PhaseBreakdown`` feeds
        its controller; the sampling grid is anchored to ``steps_done``
        (:func:`~repro_torch.fvm.step_program.roll_schedule`) and windows
        are capped at ``scan_window`` steps.  Returns the last step's
        stats.  A supervised session goes through :meth:`step_all`: a
        rollback mid-request invalidates a precomputed schedule.
        """
        from repro_torch.fvm.step_program import roll_schedule

        sess = self.sessions[sid]
        if sess.supervisor is not None:
            return self.step_all(n_steps, sids=[sid]).get(sid)
        every = self._every(sess)
        stats = None
        for is_sample, chunk in roll_schedule(sess.steps_done, n_steps,
                                              every, cap=self.scan_window):
            stats = self._advance_one(sess, is_sample, chunk)
        return stats

    def _every(self, sess: SimulationSession) -> int | None:
        """The session's sampling cadence: ``sample_every`` for adaptive
        sessions, None otherwise — and None while a supervised session is
        unhealthy (its retry timings would feed the controller noise, and
        its rolled-back step counter would thrash the sampling phase)."""
        healthy = sess.supervisor is None or sess.supervisor.healthy
        return (self.config.sample_every
                if (sess.adaptive and healthy) else None)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- cohort-batched stepping ----------------------------------------
    def _advance_one(self, sess: SimulationSession, is_sample: bool,
                     chunk: int):
        """Advance one session through one schedule stretch (solo path)."""
        t0 = self._clock() if self.track_latency else 0.0
        sup = sess.supervisor
        dt = sess.dt if sup is None else sess.dt * sup.dt_scale
        sample = None
        if is_sample:
            sess.state, stats, sample = sess.solver.timed_step(sess.state,
                                                               dt)
            self.counters["sample_steps"] += 1
            window = stats
        else:
            sess.state, window = sess.solver.run_steps(sess.state, dt,
                                                       chunk)
            stats = _last(window)
            self.counters["solo_dispatches"] += 1
            self.counters["rolled_windows"] += 1
            self.dispatch_paths[
                "pipelined_solo" if sess.solver.pipelined else "solo"] += 1
        if self.track_latency:
            self._sync()
            per_step = (self._clock() - t0) / chunk
            sess.latency_samples.extend([per_step] * chunk)
        sess.steps_done += chunk
        verdict = self._supervise(sess, window) if sup is not None else None
        if sample is not None and verdict is None:
            alpha = sess.controller.step(sample)
            if alpha != sess.solver.alpha:
                sess.solver.rebind_alpha(alpha)
        return stats

    def _cohort_key(self, sess: SimulationSession) -> tuple:
        """Interchangeability key: sessions with equal keys step through
        ONE batched executor.

        The mesh fingerprint, alpha, solve mode and backend are the
        binding's identity (plus ``nu``/dtype, which the program closes
        over); adaptive sessions also carry their sampling phase
        (``steps_done mod sample_every``) so every member agrees on where
        the next instrumented sample falls.  A padded session keys on its
        class shape (a padded mesh fingerprints as a plain mesh of the
        padded shape) and on ``padded`` (its program takes ``n_active``).
        The Krylov tolerances and caps, the program, the case, the
        resolved ``pipelined`` flag and the precision policy are key
        components too: tenants that differ in any of them never share a
        dispatch.  The last component is the supervision token: an
        unhealthy session keys on its own sid, so it steps solo (its
        retries replay private windows at a scaled dt, perhaps on another
        backend) while healthy cohort-mates keep their one-dispatch
        window; recovery clears it and the session rejoins its cohort.
        """
        s = sess.solver
        phase = (sess.steps_done % self.config.sample_every
                 if sess.adaptive else -1)
        quarantine = (None if sess.supervisor is None
                      or sess.supervisor.healthy else sess.sid)
        tols = (s.mom_tol, s.p_tol, s.mom_maxiter, s.p_maxiter)
        return (sess.mesh_fp, s.alpha, s.solve_mode, s.solver_backend, s.nu,
                str(s.dtype), sess.adaptive, phase, tols, s.padded,
                s.program_name, s.case, s.pipelined, s.precision, quarantine)

    def step_all(self, n_steps: int = 1, sids=None) -> dict:
        """Advance every open session (or ``sids``) by ``n_steps`` through
        cohort-batched dispatches; returns the last stats per sid.

        Scheduling runs in rounds: sessions are grouped by
        :meth:`_cohort_key`, each cohort's states are stacked along a
        leading session axis (:func:`~repro_torch.fvm.piso.stack_states`)
        and the cohort advances through one stretch of the shared
        ``roll_schedule`` cadence via the leader's
        :meth:`~repro_torch.fvm.piso.SegregatedSolver.batched_executor`.
        Per-session ``dt`` rides along as a tensor.  A sampled stretch runs
        the cohort's instrumented walk and hands each tenant's controller
        its own row; a session whose controller switches alpha rebinds at
        once, and its changed key migrates it on the next round.
        Singleton cohorts take the solo path inside the same schedule.

        The accounting is by absolute targets: a supervised rollback moves
        ``steps_done`` backwards and the session stays live until it
        re-earns its target; a FAILED session leaves :attr:`sessions` and
        drops out (its retry budget bounds the extra rounds).
        """
        if n_steps < 0:
            raise ValueError(f"n_steps must be >= 0, got {n_steps}")
        sids = list(self.sessions if sids is None else sids)
        missing = [sid for sid in sids if sid not in self.sessions]
        if missing:
            raise KeyError(f"unknown session(s) {missing}")
        target = {sid: self.sessions[sid].steps_done + n_steps
                  for sid in sids}
        last: dict[str, object] = {}
        while True:
            live = [sid for sid in target
                    if sid in self.sessions
                    and self.sessions[sid].steps_done < target[sid]]
            if not live:
                break
            self.counters["scheduling_rounds"] += 1
            cohorts: dict[tuple, list[str]] = {}
            for sid in live:
                key = self._cohort_key(self.sessions[sid])
                cohorts.setdefault(key, []).append(sid)
            for group in cohorts.values():
                # a supervised failure earlier in this round may have
                # closed a member of a later group
                group = [sid for sid in group if sid in self.sessions]
                if not group:
                    continue
                rem = min(target[sid] - self.sessions[sid].steps_done
                          for sid in group)
                self.advance_group(group, rem, last)
        return last

    def advance_group(self, group, n_steps: int, last=None) -> int:
        """Advance one cohort ``group`` (sids sharing a cohort key) through
        ONE stretch of the shared cadence; returns the stretch length.

        The scheduling quantum of :mod:`repro_torch.serving.scheduler`.
        ``last``, when given, collects each member's latest stats under its
        sid.  A group whose members do not share the lead's key is
        rejected (stacking it would step a tenant with another's program).
        """
        from repro_torch.fvm.step_program import roll_schedule

        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        last = {} if last is None else last
        lead = self.sessions[group[0]]
        lead_key = self._cohort_key(lead)
        bad = [sid for sid in group[1:]
               if self._cohort_key(self.sessions[sid]) != lead_key]
        if bad:
            raise ValueError(
                f"advance_group: session(s) {bad} are not cohort-"
                f"compatible with lead {group[0]!r} (program/case/mesh/"
                "alpha mismatch) — migration across cohort keys must go "
                "through a new scheduling round, not a mixed dispatch")
        every = self._every(lead)
        is_sample, chunk = next(roll_schedule(
            lead.steps_done, n_steps, every, cap=self.scan_window))
        if len(group) == 1 or lead.solver.full_mesh_solve:
            # a full-mesh tenant steps alone (as in the JAX engine)
            for sid in group:
                last[sid] = self._advance_one(self.sessions[sid], is_sample,
                                              chunk)
        else:
            self._advance_cohort(group, is_sample, chunk, last)
        return chunk

    def _advance_cohort(self, group, is_sample: bool, chunk: int,
                        last) -> None:
        """Advance one multi-session cohort through one schedule stretch.

        A padded cohort passes the per-session ``n_active`` vector; with
        ``lane_classes`` its batch is padded to the next power of two with
        zero filler lanes (``n_active=0``, ``dt`` copied from the lead so
        ``V/dt`` stays finite).
        """
        from repro_torch.fvm.piso import stack_states, unstack_states
        from repro_torch.serving.scheduler import size_class

        sessions = [self.sessions[sid] for sid in group]
        lead = sessions[0]
        n = len(group)
        lanes = size_class(n) if self.lane_classes and lead.solver.padded \
            else n
        exe = lead.solver.batched_executor(lanes)
        states = stack_states([s.state for s in sessions], pad_to=lanes)
        dts = torch.tensor([s.dt for s in sessions] + [lead.dt] * (lanes - n),
                           dtype=lead.solver.dtype, device=self.device)
        rows = ([s.solver._extras() for s in sessions]
                + [lead.solver._filler_extras()] * (lanes - n))
        extras = lead.solver.lane_extras(rows)
        t0 = self._clock() if self.track_latency else 0.0
        if is_sample:
            states, stats, samples = exe.timed_step(states, dts, *extras)
            self.counters["sample_steps"] += 1
            per_stats = [_last(stats, (i,)) for i in range(n)]
        else:
            states, window = exe.run_steps(states, dts, chunk, *extras)
            self.counters["cohort_dispatches"] += 1
            self.counters["rolled_windows"] += 1
            self.dispatch_paths["pipelined_cohort" if lead.solver.pipelined
                                else "cohort"] += 1
            samples = None
            per_stats = [_last(window, (-1, i)) for i in range(n)]
        if self.track_latency:
            self._sync()
            per_step = (self._clock() - t0) / chunk
        for i, (sess, state) in enumerate(zip(sessions,
                                              unstack_states(states, n))):
            sess.state = state
            sess.steps_done += chunk
            last[sess.sid] = per_stats[i]
            if self.track_latency:
                sess.latency_samples.extend([per_step] * chunk)
            verdict = None
            if sess.supervisor is not None:
                # this lane's flags over the whole window: lanes are
                # independent, so a poisoned neighbour never perturbs this
                # verdict (or this lane's numerics)
                lane_window = (per_stats[i] if samples is not None
                               else _last(window, (slice(None), i)))
                verdict = self._supervise(sess, lane_window)
            if samples is not None and verdict is None:
                alpha = sess.controller.step(samples[i])
                if alpha != sess.solver.alpha:
                    # rebind now; the new cohort key migrates the session
                    # on the next scheduling round
                    sess.solver.rebind_alpha(alpha)

    # ---- supervision -----------------------------------------------------
    def _supervise(self, sess: SimulationSession, window_stats):
        """Apply one window's health verdict to a supervised session.

        Clean window: checkpoint the state and let the supervisor count
        toward recovery (restoring the original backend on
        QUARANTINED → DEGRADED and the original precision policy on
        DEGRADED → HEALTHY).  Faulty window: roll the session back to
        its last clean checkpoint and escalate.  Mixed-precision tenants
        first climb the precision ladder (``bf16_ir → f32_ir → f64``,
        one rung per fault) — a low-precision divergence is most often
        cured by more mantissa; only once the ladder is exhausted does
        "quarantine" rebind the configured fallback backend.  "fail"
        closes the session and parks its post-mortem in :attr:`failed`.
        Returns the supervisor directive (None for a clean window).
        """
        sup = sess.supervisor
        if sup is None or sup.state == FAILED:
            return None
        kind = window_verdict(window_stats)
        if kind is None:
            act = sup.on_clean_window(sess.steps_done)
            if act == "recover" and sup.orig_backend is not None:
                self._rebind_backend(sess, sup.orig_backend)
                sup.orig_backend = None
            if act == "restore" and sup.orig_precision is not None:
                self._rebind_precision(sess, sup.orig_precision)
                sup.orig_precision = None
            sup.checkpoint(sess.state, sess.steps_done)
            return None
        act = sup.on_fault(kind, sess.steps_done)
        if act == "fail":
            final = self.close_session(sess.sid)
            self.failed[sess.sid] = {
                "steps_done": sess.steps_done,
                "controller": final,
                "events": [dataclasses.asdict(e) for e in sup.events],
            }
            return act
        # roll back to the pre-fault checkpoint; the halved dt (and any
        # precision/backend rebind below) applies to the replay
        sess.state, sess.steps_done = sup.rollback()
        nxt = PRECISION_FALLBACK.get(sess.solver.precision)
        if nxt is not None:
            # precision ladder first: one rung toward f64 per fault
            if sup.orig_precision is None:
                sup.orig_precision = sess.solver.precision
            self._rebind_precision(sess, nxt)
        elif act == "quarantine" and sup.config.fallback_backend:
            fb = sup.config.fallback_backend
            if sess.solver.solver_backend != fb:
                sup.orig_backend = sess.solver.solver_backend
                self._rebind_backend(sess, fb)
        return act

    def _rebind_backend(self, sess: SimulationSession, backend: str):
        """Swap the session's Krylov backend in place; the solver memoises
        bindings per (program, alpha, backend, policy, pipelined), so a
        backend the session used before rebinds without building."""
        sess.solver.solver_backend = backend
        sess.controller.solver_backend = backend
        sess.solver.rebind_alpha(sess.solver.alpha)

    def _rebind_precision(self, sess: SimulationSession, precision: str):
        """Swap the session's precision policy in place.  Same memoised
        binding mechanics as :meth:`_rebind_backend` — the policy keys the
        binding and the plan — plus the cohort key: the session stops
        co-batching with its old-policy cohort-mates on the next
        dispatch."""
        if sess.solver.precision == precision:
            return
        sess.solver.precision = precision
        sess.controller.precision = precision
        base = sess.controller.base_model
        if base.precision != precision:
            sess.controller.base_model = base.with_precision(precision)
        sess.solver.rebind_alpha(sess.solver.alpha)

    # ---- exact checkpoint/restore ---------------------------------------
    def snapshot(self, path, scheduler=None) -> None:
        """Serialize the whole engine to ``path`` (a directory): every
        session's state leaves (plus its supervisor's ``last_good``
        checkpoint), controller calibration and decision state,
        supervisor state machine, Krylov tolerances, dispatch counters
        and — when a scheduler is handed in — its bookkeeping.  The JAX
        package's format 1: one ``arrays.npz`` of leaves (keys
        ``"{sid}|state|{field}"`` and ``"{sid}|good|{field}"``) and one
        ``manifest.json`` of everything else, written atomically (tmp +
        rename), so :meth:`restore` resumes **exactly** — same states,
        same controller decisions, same supervision posture.  Each
        session's entry also carries its ``tols`` (``mom_tol``, ``p_tol``,
        ``mom_maxiter``, ``p_maxiter``), a key the JAX package's restore
        ignores.
        """
        import json
        import os
        import shutil

        import numpy as np

        from repro_torch.fvm.piso import PisoState
        from repro_torch.interop import mesh_fields

        arrays: dict[str, np.ndarray] = {}
        sessions = []
        for sid, sess in self.sessions.items():
            for field, leaf in zip(PisoState._fields, sess.state):
                arrays[f"{sid}|state|{field}"] = leaf.cpu().numpy()
            sup = sess.supervisor
            if sup is not None and sup.last_good is not None:
                for field, leaf in zip(PisoState._fields, sup.last_good[0]):
                    arrays[f"{sid}|good|{field}"] = leaf.cpu().numpy()
            c = sess.controller
            s = sess.solver
            mesh = mesh_fields(s.mesh)
            # the JAX package's restore reads the key for every mesh
            mesh.setdefault("n_parts_real", None)
            sessions.append({
                "sid": sid,
                "mesh": mesh,
                "dt": sess.dt, "adaptive": sess.adaptive,
                "steps_done": sess.steps_done,
                "priority": sess.priority, "deadline_ms": sess.deadline_ms,
                "program": s.program_name,
                "case": s.case,
                "nu": s.nu,
                "alpha": s.alpha,
                "solve_mode": c.solve_mode,
                # the port's key (JAX ignores it): the shards' devices of an
                # explicit full mesh
                "mesh_devices": (None if s.spmd_mesh is None or s._auto_mesh
                                 else [str(d) for d in s.spmd_mesh.flat()]),
                "solver_backend": s.solver_backend,
                "pipeline": s.pipeline,
                "precision": s.precision,
                "tols": {"mom_tol": s.mom_tol, "p_tol": s.p_tol,
                         "mom_maxiter": s.mom_maxiter,
                         "p_maxiter": s.p_maxiter},
                "latency_samples": list(sess.latency_samples),
                "controller": {
                    "alpha": c.alpha,
                    "step_count": c.step_count,
                    "last_switch_step": c.last_switch_step,
                    "calibration": {
                        "log_scales": list(c.calibration._log_scales),
                        "n_obs": c.calibration.n_obs},
                    "switches": [dataclasses.asdict(e) for e in c.switches],
                    "history": [dataclasses.asdict(h) for h in c.history],
                    "challenger": c._challenger,
                    "challenger_wins": c._challenger_wins,
                },
                "supervisor": None if sup is None else sup.to_dict(),
            })
        manifest = {
            "format": 1,
            "engine": {
                "scan_window": self.scan_window,
                "lane_classes": self.lane_classes,
                "track_latency": self.track_latency,
                "supervise": self.supervise,
                "supervisor_config": (
                    None if self.supervisor_config is None
                    else dataclasses.asdict(self.supervisor_config)),
                "config": dataclasses.asdict(self.config),
                "counters": dict(self.counters),
                "dispatch_paths": dict(self.dispatch_paths),
            },
            "failed": self.failed,
            "scheduler": (None if scheduler is None
                          else scheduler.bookkeeping()),
            "sessions": sessions,
        }
        path = os.fspath(path)
        tmp = path.rstrip("/") + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1, default=float)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)

    @classmethod
    def restore(cls, path, plan_cache: PlanCache | None = None,
                clock=None, device: str | torch.device = "cuda"
                ) -> "SimulationEngine":
        """Rebuild an engine from :meth:`snapshot` output (the port's or
        the JAX package's) on ``device``.  Sessions are re-opened in
        manifest order (so cohort stacking order matches the snapshotting
        engine), then every leaf, counter and decision variable is
        overwritten with the serialized value: the resumed engine's next
        window is bit-identical to what the snapshotted engine would have
        computed.  A manifest without ``tols`` (the JAX package writes
        none) reopens its sessions at the solver's default tolerances."""
        import json
        import os

        import numpy as np

        from repro_torch.core.controller import SwitchEvent
        from repro_torch.core.cost_model import PhaseBreakdown
        from repro_torch.fvm.piso import PisoState
        from repro_torch.interop import mesh_from_fields

        with open(os.path.join(os.fspath(path), "manifest.json")) as f:
            manifest = json.load(f)
        arrs = np.load(os.path.join(os.fspath(path), "arrays.npz"))
        e = manifest["engine"]
        cfg = dict(e["config"])
        cfg["alphas"] = tuple(cfg["alphas"])
        sup_cfg = (None if e["supervisor_config"] is None
                   else SupervisorConfig(**e["supervisor_config"]))
        eng = cls(plan_cache=plan_cache, config=ControllerConfig(**cfg),
                  scan_window=int(e["scan_window"]),
                  lane_classes=e["lane_classes"],
                  track_latency=e["track_latency"], clock=clock,
                  supervise=e["supervise"], supervisor_config=sup_cfg,
                  device=device)
        eng.counters.update({k: int(v) for k, v in e["counters"].items()})
        eng.dispatch_paths.update(
            {k: int(v) for k, v in e.get("dispatch_paths", {}).items()})
        eng.failed = dict(manifest["failed"])

        def leaves(sid, kind):
            return PisoState(*(
                torch.tensor(arrs[f"{sid}|{kind}|{f}"], device=eng.device)
                for f in PisoState._fields))

        for m in manifest["sessions"]:
            sid = m["sid"]
            mesh_kw = {}
            if m.get("mesh_devices"):
                mesh_kw["spmd_mesh"] = _restored_mesh(m, eng.device)
            sess = eng.open_session(
                sid, mesh_from_fields(m["mesh"]), dt=float(m["dt"]),
                alpha0=int(m["alpha"]), nu=float(m["nu"]),
                adaptive=m["adaptive"], solve_mode=m["solve_mode"],
                solver_backend=m["solver_backend"],
                priority=m["priority"], deadline_ms=m["deadline_ms"],
                program=m["program"], case=m["case"],
                pipeline=m.get("pipeline", "auto"),
                precision=m.get("precision", "f64"), **m.get("tols", {}),
                **mesh_kw)
            sess.state = leaves(sid, "state")
            sess.steps_done = int(m["steps_done"])
            sess.latency_samples = list(m["latency_samples"])
            c, cd = sess.controller, m["controller"]
            c.alpha = int(cd["alpha"])
            c.step_count = int(cd["step_count"])
            c.last_switch_step = int(cd["last_switch_step"])
            c.calibration._log_scales = [
                float(s) for s in cd["calibration"]["log_scales"]]
            c.calibration.n_obs = int(cd["calibration"]["n_obs"])
            c.switches = [SwitchEvent(**s) for s in cd["switches"]]
            c.history = [PhaseBreakdown(**h) for h in cd["history"]]
            c._challenger = cd["challenger"]
            c._challenger_wins = int(cd["challenger_wins"])
            if m["supervisor"] is not None:
                sup = SessionSupervisor.from_dict(m["supervisor"])
                if m["supervisor"]["last_good_step"] is not None:
                    sup.last_good = (leaves(sid, "good"),
                                     int(m["supervisor"]["last_good_step"]))
                sess.supervisor = sup
        return eng

    def close_session(self, sid: str) -> dict:
        """Evict the tenant; returns its final controller stats."""
        sess = self.sessions.pop(sid)
        return sess.controller.stats()

    def cohorts(self) -> dict:
        """The current cohort map: cohort key -> open session ids (what
        the next ``step_all`` round would batch together)."""
        out: dict[tuple, list[str]] = {}
        for sid, sess in self.sessions.items():
            out.setdefault(self._cohort_key(sess), []).append(sid)
        return out

    def reset_stats(self) -> None:
        """Zero the dispatch counters, latency samples and plan-cache
        hit/miss meters (the cached plans are kept)."""
        for k in self.counters:
            self.counters[k] = 0
        for k in self.dispatch_paths:
            self.dispatch_paths[k] = 0
        for sess in self.sessions.values():
            sess.latency_samples.clear()
        reset = getattr(self.plan_cache, "reset_stats", None)
        if reset is not None:
            reset()

    def latency_stats(self) -> dict:
        """p50/p99 session-step latency, per session and pooled per
        priority class (nearest-rank percentiles; empty when the engine
        runs without ``track_latency``)."""
        from repro_torch.serving.scheduler import percentile

        per_session, pooled = {}, {}
        for sid, s in self.sessions.items():
            if s.latency_samples:
                per_session[sid] = {
                    "n": len(s.latency_samples),
                    "p50": percentile(s.latency_samples, 50),
                    "p99": percentile(s.latency_samples, 99),
                }
            pooled.setdefault(s.priority, []).extend(s.latency_samples)
        classes = {
            prio: {"n": len(xs), "p50": percentile(xs, 50),
                   "p99": percentile(xs, 99)}
            for prio, xs in pooled.items() if xs
        }
        return {"per_session": per_session, "classes": classes}

    def stats(self) -> dict:
        return {
            "sessions": {
                sid: {"steps": s.steps_done, "alpha": s.controller.alpha,
                      "solve_mode": s.controller.solve_mode,
                      "solver_backend": s.controller.solver_backend,
                      "switches": len(s.controller.switches),
                      "priority": s.priority,
                      "program": s.solver.program_name,
                      "case": s.solver.case,
                      "pipelined": s.solver.pipelined,
                      "precision": s.solver.precision,
                      "health": (None if s.supervisor is None
                                 else s.supervisor.state)}
                for sid, s in self.sessions.items()
            },
            "cohorts": [len(g) for g in self.cohorts().values()],
            "counters": dict(self.counters),
            "dispatch_paths": dict(self.dispatch_paths),
            "failed": sorted(self.failed),
            "plan_cache": self.plan_cache.stats(),
            "latency": self.latency_stats(),
        }
