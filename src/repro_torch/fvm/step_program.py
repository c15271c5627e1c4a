"""StepProgram — a segregated timestep as one declarative phase list.

A :class:`StepProgram` is an ordered tuple of named :class:`Phase` entries —
functions with declared env inputs/outputs and a cost-model phase tag —
built once per solver binding.  PISO (:func:`build_piso_program`) follows
the paper's fig. 5/7 decomposition: ``assemble_mom → update_mom →
solve_mom`` then, per corrector, ``assemble_p → update_p → solve_p →
correct``; SIMPLE (:mod:`repro_torch.fvm.simple`) is another phase list
over the same phase toolkit, with a convergence predicate.

The executors (the JAX package's, one for one):

* :class:`SerialExecutor` walks the phases in declared order: ``step(state,
  dt, *extra)`` advances one timestep, ``run_steps(state, dt, n, *extra)``
  advances ``n`` and returns per-step stacked stats, and ``run_converged``
  iterates a steady program until its ``converged`` predicate holds — the
  contract of the JAX package's ``FusedExecutor``.  PyTorch runs eagerly,
  so there is nothing to compile or donate; what JAX's fused window keeps
  off the host is kept off it here too: every step statistic stays a device
  tensor, and a window reads the device only inside the Krylov solves, once
  per replayed block (:mod:`repro_torch.solvers.device_loop`).
* :class:`InstrumentedExecutor` walks the same phases with a CUDA event at
  each phase boundary and bills each phase to its cost-model tag
  (:class:`repro_torch.core.cost_model.PhaseBreakdown`).
* :class:`PipelinedExecutor` runs the program's **software-pipelined**
  schedule (:class:`PipelineForm`): the declared inputs/outputs become a
  dependence DAG, independent phases are issued ahead of the blocking
  Krylov solves (the overlap frontier, computed from the declarations),
  and ring-carried values cross the step boundary (PISO carries
  ``grad(p)``).  The schedule is walked on one stream.
* :class:`BatchedExecutor` advances a **cohort** of same-shape tenants:
  every state leaf stacked along a leading session axis, one ``dt`` and one
  value of each extra operand per session.  Where JAX vmaps the program,
  the port binds the program's *cohort form* (``StepProgram.lanes_of``):
  the same phase functions over the ``B`` lanes' parts stacked ``(B*P,
  ...)``, one set of launches per phase for the whole cohort, the Krylov
  loops carrying one flag per lane and freezing a lane whose flag has
  dropped, and nothing reading across a lane border.  Each lane computes
  what it computes alone.  :class:`BatchedPipelinedExecutor` is the
  pipelined cohort variant; :class:`ProgramExecutors` keeps one binding's
  executors, the cohort ones per cohort size.

:func:`roll_schedule` is the window cadence of the JAX launcher and engine.
Programs are registered by name (:class:`ProgramSpec`, :func:`get_program`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.core.cost_model import PhaseBreakdown

__all__ = ["Phase", "StepProgram", "SerialExecutor", "InstrumentedExecutor",
           "PipelinedExecutor", "BatchedExecutor",
           "BatchedPipelinedExecutor", "ProgramExecutors", "PipelineForm",
           "build_piso_program", "health_flags", "roll_schedule",
           "PHASE_TAGS", "ProgramSpec", "PROGRAMS", "register_program",
           "program_names", "get_program", "PhaseToolkit", "LaneLayout",
           "cohort_form"]

# the cost-model buckets a phase may bill to
PHASE_TAGS = PhaseBreakdown.TIME_FIELDS


@dataclasses.dataclass(frozen=True)
class Phase:
    """One named step of the program.

    ``fn`` consumes ``inputs`` (env keys, positionally) and returns one
    value per name in ``outputs`` (a bare value when there is exactly
    one).  ``tag`` is the cost-model bucket the phase bills to; the
    attribution follows the paper's two partitions, so e.g. the momentum
    predictor's phases all bill to ``assembly`` even though one of them is
    a solve.  ``corrector`` marks per-corrector phase instances.
    ``blocking`` marks a latency-bound phase (a Krylov solve) for the
    pipelined scheduler: every dataflow-independent phase at the same
    dependence level is issued before it.
    """

    name: str
    tag: str
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]
    fn: Callable
    corrector: int | None = None
    blocking: bool = False

    @property
    def label(self) -> str:
        """Display name, unique per program position."""
        return (self.name if self.corrector is None
                else f"{self.name}[{self.corrector}]")


def _bind(env: dict, phase: Phase, out) -> None:
    """Store a phase's return value(s) under its declared output names."""
    if len(phase.outputs) == 1:
        out = (out,)
    if len(out) != len(phase.outputs):
        raise ValueError(
            f"phase {phase.label} returned {len(out)} values for outputs "
            f"{phase.outputs}")
    env.update(zip(phase.outputs, out))


def _run(env: dict, phase: Phase) -> None:
    _bind(env, phase, phase.fn(*(env[k] for k in phase.inputs)))


def _stack_stats(history):
    """Per-step stats stacked along a leading step axis."""
    return type(history[0])(*(torch.stack(f) for f in zip(*history)))


@dataclasses.dataclass(frozen=True)
class PipelineForm:
    """A program's software-pipelined alternative schedule.

    ``phases`` is a *restructured* phase list computing the same step as
    the program's serial list but factored so the dependence DAG exposes
    overlap (PISO splits the pressure assembly into a corrector-invariant
    matrix phase, issued beside the momentum solve, and a per-corrector
    source phase).  ``ring`` names env keys carried **across the step
    boundary**: each must be produced by some phase, and its value at the
    end of step t feeds step t+1's env.  ``prime`` seeds the ring for the
    first step of a window: ``prime(env) -> {ring key: value}``.
    """

    phases: tuple[Phase, ...]
    ring: tuple[str, ...] = ()
    prime: Callable | None = None


def _pipeline_schedule(phases: tuple[Phase, ...]):
    """Compile declared phase inputs/outputs into the pipelined schedule.

    Builds the dependence DAG (RAW + WAW + WAR over env keys, in declared
    order — predecessors always have smaller indices), levelizes it, and
    returns ``(schedule, levels, frontier)``:

    * ``schedule`` — the phases re-ordered by ``(level, blocking,
      declared index)``: at each dependence level every independent
      non-blocking phase is issued *before* the blocking Krylov solves;
    * ``levels`` — the per-phase dependence depth (declared order);
    * ``frontier`` — for each blocking phase, the labels of phases with
      **no transitive dependence either way**: the legal overlap set.
    """
    n = len(phases)
    last_writer: dict[str, int] = {}
    readers: dict[str, list[int]] = {}
    preds: list[set[int]] = [set() for _ in range(n)]
    for j, ph in enumerate(phases):
        for k in ph.inputs:                       # RAW
            if k in last_writer:
                preds[j].add(last_writer[k])
        for k in ph.outputs:
            if k in last_writer:                  # WAW
                preds[j].add(last_writer[k])
            for r in readers.get(k, ()):          # WAR
                if r != j:
                    preds[j].add(r)
        for k in ph.inputs:
            readers.setdefault(k, []).append(j)
        for k in ph.outputs:
            last_writer[k] = j
            readers[k] = []
    levels: list[int] = []
    for j in range(n):
        levels.append(1 + max((levels[p] for p in preds[j]), default=0))
    order = sorted(range(n),
                   key=lambda j: (levels[j], phases[j].blocking, j))
    anc: list[set[int]] = [set() for _ in range(n)]
    for j in range(n):
        for p in preds[j]:
            anc[j] |= anc[p] | {p}
    frontier = {
        ph.label: tuple(phases[k].label for k in range(n)
                        if k != j and k not in anc[j] and j not in anc[k])
        for j, ph in enumerate(phases) if ph.blocking
    }
    return tuple(phases[j] for j in order), tuple(levels), frontier


def _require_pipeline(program: StepProgram) -> None:
    if program.pipeline is None:
        raise ValueError(
            "program declares no PipelineForm (pipeline=None): steady "
            "programs (SIMPLE) cannot software-pipeline — their "
            "run_converged loop has an unknown trip count, so there "
            "is no window to carry the ring across")


@dataclasses.dataclass(frozen=True)
class StepProgram:
    """An ordered phase list + env seeding/finalization: one timestep.

    ``seed(state, dt, *extra)`` produces the initial env dict (keys
    declared in ``seed_keys``); phases then read/write named env slots in
    order; ``finalize(env)`` folds the final env into ``(state, stats)``.
    Construction validates the dataflow: every phase input must be
    produced by the seed or an earlier phase, and every tag must be one of
    :data:`PHASE_TAGS`; a pipeline form is validated the same way, its
    ring keys produced by its phases and primed.
    """

    phases: tuple[Phase, ...]
    seed: Callable
    finalize: Callable
    seed_keys: tuple[str, ...]
    # names of the extra per-step operands beyond (state, dt), in the
    # order every executor entry point takes them: a padded (size-class)
    # program's n_active, then SIMPLE's under-relaxation factors
    extra_keys: tuple[str, ...] = ()
    # the outer-loop convergence predicate ``stats -> bool tensor`` of a
    # steady program; None for a transient one (PISO)
    converged: Callable | None = None
    # the software-pipelined alternative schedule (None: serial only)
    pipeline: PipelineForm | None = None
    # ``lanes_of(B)``: this program's cohort form for B lanes (the same
    # phases over stacked lanes; its seed takes states stacked (B, ...),
    # a (B,) dt and (B,) extras, and its stats carry a leading lane axis);
    # None for a cohort form itself
    lanes_of: Callable | None = None
    # the binding's per-step move record over a (solve, assemble) mesh
    # (repro_torch.core.update.MoveRecord: the seed clears it, the phases
    # add to it); None off a mesh
    moves: object | None = None

    def __post_init__(self):
        self._validate_phases(self.phases, set(self.seed_keys))
        if self.pipeline is not None:
            form = self.pipeline
            self._validate_phases(form.phases,
                                  set(self.seed_keys) | set(form.ring))
            produced = set()
            for ph in form.phases:
                produced.update(ph.outputs)
            missing = [k for k in form.ring if k not in produced]
            if missing:
                raise ValueError(
                    f"pipeline ring keys {missing} are not produced by any "
                    f"pipeline phase — nothing to carry across the step "
                    f"boundary")
            if form.ring and form.prime is None:
                raise ValueError(
                    "a pipeline with ring-carried keys needs a prime() "
                    "prologue to seed them for the first step")

    @staticmethod
    def _validate_phases(phases, available: set) -> None:
        for ph in phases:
            if ph.tag not in PHASE_TAGS:
                raise ValueError(
                    f"phase {ph.label}: unknown tag {ph.tag!r} "
                    f"(must be one of {PHASE_TAGS})")
            missing = [k for k in ph.inputs if k not in available]
            if missing:
                raise ValueError(
                    f"phase {ph.label}: inputs {missing} are neither seeded "
                    f"nor produced by an earlier phase")
            available.update(ph.outputs)

    def step(self, state, dt, *extra):
        """One timestep: ``(state, dt, *extra) -> (state, stats)``."""
        env = self.seed(state, dt, *extra)
        for ph in self.phases:
            _run(env, ph)
        return self.finalize(env)


def _converged_loop(program: StepProgram, step: Callable, state, dt,
                    max_iters: int, extra):
    """Iterate ``step`` until ``program.converged`` holds, at most
    ``max_iters`` times, per lane: a lane whose predicate holds (or whose
    count reached the cap) keeps its state, stats and count while the
    others step on — the carry select of JAX's vmapped ``while_loop``.  One
    host read per outer iteration.  Returns ``(state, stats, n_outer)``,
    ``n_outer`` a Python int for one system and an int32 tensor per lane
    for a cohort (stats with a leading lane axis)."""
    n = int(max_iters)
    if n < 1:
        raise ValueError(f"max_iters must be >= 1, got {max_iters}")
    conv = program.converged
    if conv is None:
        raise ValueError(
            "program declares no convergence predicate (converged="
            "None): run_converged is only meaningful for steady-state "
            "programs")
    state, stats = step(state, dt, *extra)
    going = ~conv(stats)
    if going.dim() == 0:
        k = 1
        while k < n and bool(going):
            state, stats = step(state, dt, *extra)
            going = ~conv(stats)
            k += 1
        return state, stats, k
    k = torch.ones(going.shape, dtype=torch.int32, device=going.device)
    going = going & (k < n)
    while bool(going.any()):
        new_state, new_stats = step(state, dt, *extra)
        state = type(state)(*(_lane_where(going, a, b)
                              for a, b in zip(new_state, state)))
        stats = type(stats)(*(_lane_where(going, a, b)
                              for a, b in zip(new_stats, stats)))
        k = k + going.to(torch.int32)
        going = going & ~conv(stats) & (k < n)
    return state, stats, k


def _lane_where(flag: torch.Tensor, new: torch.Tensor,
                old: torch.Tensor) -> torch.Tensor:
    """``new`` where the lane's flag is set, ``old`` elsewhere (leading lane
    axis on both)."""
    return torch.where(flag.view((-1,) + (1,) * (new.dim() - 1)), new, old)


class SerialExecutor:
    """Walk the program's phases in declared order, one step at a time."""

    def __init__(self, program: StepProgram):
        self.program = program

    def step(self, state, dt, *extra):
        """One timestep; returns ``(state, stats)``."""
        return self.program.step(state, dt, *extra)

    def run_steps(self, state, dt, n_steps: int, *extra):
        """``n_steps`` timesteps; every stats field comes back stacked
        along a leading ``n_steps`` axis."""
        n = int(n_steps)
        if n < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        history = []
        for _ in range(n):
            state, stats = self.program.step(state, dt, *extra)
            history.append(stats)
        return state, _stack_stats(history)

    def run_converged(self, state, dt, max_iters: int, *extra):
        """Iterate a steady program until its ``converged`` predicate holds
        on the step's stats, at most ``max_iters`` times.

        The first step always runs; then the loop steps while ``k <
        max_iters`` and the predicate is false — one host read per outer
        iteration.  Returns ``(state, stats, n_outer)``: the last step's
        stats and the number of steps run (the cap when unconverged).
        """
        return _converged_loop(self.program, self.program.step, state, dt,
                               max_iters, extra)


class _PhaseClock:
    """Timestamps at phase boundaries: CUDA events on the current stream of
    a CUDA device (read after one synchronisation at the end), the host
    clock on the CPU (where every phase is synchronous)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> list[float]:
        """The seconds between consecutive marks."""
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def _timed_walk(program: StepProgram, env: dict, device: torch.device,
                n_rows: int) -> list[dict]:
    """Walk the serial phase list with a timestamp at every phase boundary;
    mutate ``env``.  THE instrumented walk of the solo and cohort executors:
    each phase's seconds are shared evenly across ``n_rows`` sessions (1
    alone; a cohort stacks same-shape states, so each session's work is the
    same) and billed to its tag; returns one tag-times dict per row."""
    clock = _PhaseClock(device)
    clock.mark()
    for ph in program.phases:
        _run(env, ph)
        clock.mark()
    share = 1.0 / n_rows
    times = dict.fromkeys(PHASE_TAGS, 0.0)
    for ph, secs in zip(program.phases, clock.seconds()):
        times[ph.tag] += secs * share
    return [dict(times) for _ in range(n_rows)]


class InstrumentedExecutor:
    """Walk the serial phase list with a timestamp at every phase boundary.

    The JAX package's ``InstrumentedExecutor``: the same phase functions in
    the same order as :class:`SerialExecutor`, so the result is the one
    ``step`` gives, bit for bit.  On a CUDA device the timestamps are CUDA
    events on the current stream, read after one synchronisation at the
    end of the step (the Krylov loops' own block reads aside, the walk adds
    no host read); each phase's seconds are billed to its tag.  ``halo`` is
    0: the port has no probe of the exchange yet (the stacked layout keeps
    every part on one device).  The walk is always the serial schedule,
    also for a pipelined session: every breakdown has ``overlapped=False``.
    ``last_moves`` is the walked step's move record over a mesh
    (``{kind: MoveStats}``, None off a mesh).
    """

    def __init__(self, program: StepProgram):
        self.program = program
        self.calls = 0
        self.last_moves = None

    def timed_step(self, state, dt, *extra):
        """One step; returns ``(state, stats, PhaseBreakdown)``."""
        self.calls += 1
        prog = self.program
        env = prog.seed(state, dt, *extra)
        (row,) = _timed_walk(prog, env, state[0].device, 1)
        state, stats = prog.finalize(env)
        if prog.moves is not None:
            self.last_moves = dict(prog.moves.kinds)
        return state, stats, PhaseBreakdown(**row)


class _PipelineWalk:
    """The pipelined schedule of one program, walked over an env on the
    current stream."""

    def __init__(self, program: StepProgram):
        _require_pipeline(program)
        self.program = program
        self.form = program.pipeline
        self.schedule, self.levels, self.frontier = _pipeline_schedule(
            self.form.phases)

    def walk(self, env: dict) -> None:
        for ph in self.schedule:
            _run(env, ph)

    def prime(self, env: dict) -> dict:
        prime = self.form.prime
        return prime(env) if prime is not None else {}


class PipelinedExecutor:
    """The program's :class:`PipelineForm` schedule, one step at a time.

    The contract of :class:`SerialExecutor` (``step``, ``run_steps`` with
    per-step stacked stats), but each step runs the *pipelined* schedule —
    phases re-ordered along the computed dependence levels, independent
    work issued ahead of the blocking solves —
    and the ``ring`` values cross the step boundary: ``prime`` runs once per
    window (``step`` is a window of one) and each step hands its ring to
    the next as device tensors.  ``schedule``/``levels``/``frontier``
    expose the overlap structure.  ``run_converged`` refuses, as in JAX.
    """

    def __init__(self, program: StepProgram):
        self._walk = _PipelineWalk(program)
        self.program = program
        self.schedule = self._walk.schedule
        self.levels = self._walk.levels
        self.frontier = self._walk.frontier
        self.dispatches = 0

    def _window(self, state, dt, n: int, extra):
        prog, walk = self.program, self._walk
        ring_keys = prog.pipeline.ring
        env = prog.seed(state, dt, *extra)
        ring = walk.prime(env)
        history = []
        for i in range(n):
            if i:
                env = prog.seed(state, dt, *extra)
            env.update(ring)
            walk.walk(env)
            state, stats = prog.finalize(env)
            ring = {k: env[k] for k in ring_keys}
            history.append(stats)
        return state, history

    def step(self, state, dt, *extra):
        """One pipelined timestep (its ring primed from ``state``)."""
        self.dispatches += 1
        state, (stats,) = self._window(state, dt, 1, extra)
        return state, stats

    def run_steps(self, state, dt, n_steps: int, *extra):
        """``n_steps`` pipelined timesteps as one window; stacked stats."""
        n = int(n_steps)
        if n < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        self.dispatches += 1
        state, history = self._window(state, dt, n, extra)
        return state, _stack_stats(history)

    def run_converged(self, state, dt, max_iters: int, *extra):
        raise ValueError(
            "PipelinedExecutor cannot run_converged: the convergence "
            "loop's trip count is unknown, so there is no window to "
            "software-pipeline across — use the serial executor for "
            "steady outer iteration")


class BatchedExecutor:
    """A cohort of same-shape sessions through the program's cohort form.

    Every state leaf is stacked along a leading session axis of size
    ``batch`` and ``dt`` is a ``(batch,)`` tensor, as are the extra
    operands (a padded program's ``n_active``, SIMPLE's relaxation
    factors).  ``run_steps`` advances the whole cohort through one window;
    each phase is one set of launches for all lanes; the Krylov loops
    freeze each lane at its own count, so each session's iterates and
    counts are its solo run's.  Stats carry leading ``(n_steps, batch)``
    axes.  ``timed_step`` is the cohort's instrumented sample: each phase's
    seconds shared evenly across the cohort, one :class:`PhaseBreakdown`
    per session.  ``dispatches`` counts windows, ``samples`` timed steps.
    """

    def __init__(self, program: StepProgram, batch: int):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if program.lanes_of is None:
            raise ValueError("program has no cohort form (lanes_of): a "
                             "cohort build, or a binding over a mesh, "
                             "which steps alone")
        self.program = program
        self.batch = batch
        self.lanes = program.lanes_of(batch)
        self.dispatches = 0
        self.samples = 0

    def _check(self, states, dts, extras) -> None:
        lead = states[0].shape[0]
        if lead != self.batch or tuple(dts.shape) != (self.batch,):
            raise ValueError(
                f"cohort shape mismatch: executor batch={self.batch}, "
                f"state lead={lead}, dt shape={tuple(dts.shape)}")
        for name, x in zip(self.program.extra_keys, extras):
            if tuple(x.shape[:1]) != (self.batch,):
                raise ValueError(
                    f"cohort extra {name!r} must carry a leading "
                    f"({self.batch},) session axis")

    def step(self, states, dts, *extras):
        """One timestep for the whole cohort."""
        self._check(states, dts, extras)
        self.dispatches += 1
        return self.lanes.step(states, dts, *extras)

    def run_steps(self, states, dts, n_steps: int, *extras):
        """``n_steps`` cohort timesteps as one window; stats leaves carry
        leading ``(n_steps, batch)`` axes."""
        self._check(states, dts, extras)
        n = int(n_steps)
        if n < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        self.dispatches += 1
        history = []
        for _ in range(n):
            states, stats = self.lanes.step(states, dts, *extras)
            history.append(stats)
        return states, _stack_stats(history)

    def run_converged(self, states, dts, max_iters: int, *extras):
        """The whole cohort outer-iterated to convergence: a lane whose
        predicate holds keeps its state, stats and count while the others
        step on (JAX's vmapped ``while_loop``), so each session ends where
        its solo run ends.  Returns ``(states, stats, n_outer)``,
        ``n_outer`` a ``(batch,)`` int32 tensor."""
        self._check(states, dts, extras)
        self.dispatches += 1
        return _converged_loop(self.lanes, self.lanes.step, states, dts,
                               max_iters, extras)

    def timed_step(self, states, dts, *extras):
        """One instrumented cohort step (serial schedule).  Returns
        ``(states, stats, rows)``, one :class:`PhaseBreakdown` per
        session."""
        self._check(states, dts, extras)
        self.samples += 1
        prog = self.lanes
        env = prog.seed(states, dts, *extras)
        rows = _timed_walk(prog, env, states[0].device, self.batch)
        states, stats = prog.finalize(env)
        return states, stats, [PhaseBreakdown(**row) for row in rows]


class BatchedPipelinedExecutor:
    """The pipelined schedule over a cohort: each lane carries its own ring
    (primed per lane from its own state), so each session's numerics are
    its solo :class:`PipelinedExecutor` run's.  ``timed_step`` delegates to
    a serial :class:`BatchedExecutor` walk (``overlapped=False`` rows)."""

    def __init__(self, program: StepProgram, batch: int):
        _require_pipeline(program)
        self.program = program
        self.batch = batch
        self._serial = BatchedExecutor(program, batch)
        self._pipe = PipelinedExecutor(self._serial.lanes)
        self.dispatches = 0
        self.samples = 0

    def step(self, states, dts, *extras):
        """One pipelined cohort timestep."""
        self._serial._check(states, dts, extras)
        self.dispatches += 1
        return self._pipe.step(states, dts, *extras)

    def run_steps(self, states, dts, n_steps: int, *extras):
        """``n_steps`` pipelined cohort timesteps as one window; stats
        leaves carry leading ``(n_steps, batch)`` axes."""
        self._serial._check(states, dts, extras)
        self.dispatches += 1
        return self._pipe.run_steps(states, dts, n_steps, *extras)

    def run_converged(self, states, dts, max_iters: int, *extras):
        raise ValueError(
            "BatchedPipelinedExecutor cannot run_converged — see "
            "PipelinedExecutor.run_converged")

    def timed_step(self, states, dts, *extras):
        """One instrumented cohort step on the SERIAL schedule."""
        self.samples += 1
        return self._serial.timed_step(states, dts, *extras)


class ProgramExecutors:
    """The executors of one program binding (kept per ``(program, alpha,
    backend, policy, pipelined)`` by the solver): the serial and
    instrumented ones, the pipelined one (lazily: a program without a
    :class:`PipelineForm` raises only when it is asked for), and the
    cohort ones per cohort size."""

    def __init__(self, program: StepProgram):
        self.program = program
        self.serial = SerialExecutor(program)
        self.instrumented = InstrumentedExecutor(program)
        self._batched: dict[int, BatchedExecutor] = {}
        self._pipelined: PipelinedExecutor | None = None
        self._batched_pipelined: dict[int, BatchedPipelinedExecutor] = {}

    def batched(self, batch: int) -> BatchedExecutor:
        """The cohort executor for ``batch`` stacked sessions (kept)."""
        exe = self._batched.get(batch)
        if exe is None:
            exe = self._batched[batch] = BatchedExecutor(self.program, batch)
        return exe

    @property
    def pipelined(self) -> PipelinedExecutor:
        """The software-pipelined executor (built at first use)."""
        if self._pipelined is None:
            self._pipelined = PipelinedExecutor(self.program)
        return self._pipelined

    def batched_pipelined(self, batch: int) -> BatchedPipelinedExecutor:
        """The pipelined cohort executor for ``batch`` sessions (kept)."""
        exe = self._batched_pipelined.get(batch)
        if exe is None:
            exe = self._batched_pipelined[batch] = BatchedPipelinedExecutor(
                self.program, batch)
        return exe


def roll_schedule(start: int, n_steps: int, every: int | None,
                  cap: int | None = None):
    """Yield the window cadence as ``(is_sample, chunk)`` stretches.

    The JAX package's ``roll_schedule``, as it is: the sampling grid is
    anchored at the absolute step index ``start`` (steps divisible by
    ``every`` are single instrumented samples); ``every=None`` never
    samples; other stretches run to the next sample point, at most ``cap``
    steps per window.
    """
    if every is not None and every < 1:
        raise ValueError("every must be >= 1")
    done = 0
    while done < n_steps:
        step = start + done
        if every is not None and step % every == 0:
            yield True, 1
            done += 1
            continue
        chunk = n_steps - done
        if every is not None:
            chunk = min(every - step % every, chunk)
        if cap is not None:
            chunk = min(chunk, cap)
        yield False, chunk
        done += chunk


# ---------------------------------------------------------------------------
# The program registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """Registry entry for a timestep program.

    ``build(solver)`` binds a solver's plans + SolverOps into a
    :class:`StepProgram`; ``transient`` tells time-marching programs
    (PISO: fixed numbers of steps) from steady ones (SIMPLE: iterate to
    ``converged``); ``pipelined`` says whether the built program declares
    a :class:`PipelineForm` (the static half of the solver's
    ``pipeline=auto|on|off`` resolution; a steady program leaves it
    False).
    """

    name: str
    build: Callable
    transient: bool = True
    description: str = ""
    pipelined: bool = False


PROGRAMS: dict[str, ProgramSpec] = {}


def register_program(spec: ProgramSpec) -> ProgramSpec:
    if spec.name in PROGRAMS:
        raise ValueError(f"program {spec.name!r} already registered")
    PROGRAMS[spec.name] = spec
    return spec


def program_names() -> tuple[str, ...]:
    get_program("simple")  # force the lazy registration
    return tuple(sorted(PROGRAMS))


def get_program(name: str) -> ProgramSpec:
    """Look up a registered program spec by name.

    :mod:`repro_torch.fvm.simple` registers on import; it is imported
    lazily here (it imports this module).
    """
    if name not in PROGRAMS:
        import importlib

        importlib.import_module("repro_torch.fvm.simple")
    try:
        return PROGRAMS[name]
    except KeyError:
        raise KeyError(f"unknown program {name!r} "
                       f"(registered: {tuple(sorted(PROGRAMS))})") from None


# ---------------------------------------------------------------------------
# Health signals
# ---------------------------------------------------------------------------

def health_flags(state, solver_ok: torch.Tensor, solver_cap: torch.Tensor,
                 *scalars, lanes: int | None = None,
                 across: Callable | None = None):
    """Reduce a step's health to three boolean tensors, on the device.

    ``solver_ok`` and ``solver_cap`` are the step's Krylov flags reduced
    over its solves.

    ``finite`` is an ``isfinite`` reduction over every state leaf plus the
    extra per-step scalars (residuals, continuity error).  Returns
    ``(converged, diverged, hit_cap)``: ``converged`` means every Krylov
    solve met its tolerance AND the state is finite; ``diverged`` means a
    non-finite value appeared; ``hit_cap`` means some solve exited at its
    iteration cap on an otherwise finite state.  0-d for one system; with
    ``lanes`` one flag per lane, each reduced over that lane alone (every
    leaf carries a leading lane axis).  ``across`` combines ``finite``
    over the places one system's state is split across (the ranks of a
    mesh over distinct devices, :meth:`LaneLayout.across`).
    """
    if lanes is None:
        finite = torch.stack([torch.isfinite(t).all()
                              for t in (*state, *scalars)]).all()
    else:
        finite = torch.stack([torch.isfinite(t).reshape(lanes, -1).all(1)
                              for t in (*state, *scalars)]).all(0)
    if across is not None:
        finite = across(finite)
    return solver_ok & finite, ~finite, solver_cap & finite


# ---------------------------------------------------------------------------
# The phase functions, bound to one solver
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LaneLayout:
    """How a program's fields are laid out: one system (``lanes`` None,
    parts stacked ``(P, ...)``) or a cohort of ``lanes`` lanes of ``parts``
    parts each, the phases working on ``(lanes * parts, ...)`` and the
    state and stats carrying a leading lane axis."""

    lanes: int | None
    parts: int

    def flat(self, t: torch.Tensor) -> torch.Tensor:
        """A stacked-state leaf ``(B, P, ...)`` as ``(B * P, ...)``."""
        if self.lanes is None:
            return t
        return t.reshape((self.lanes * self.parts,) + tuple(t.shape[2:]))

    def unflat(self, t: torch.Tensor) -> torch.Tensor:
        """``(B * P, ...)`` back to ``(B, P, ...)``."""
        if self.lanes is None:
            return t
        return t.reshape((self.lanes, self.parts) + tuple(t.shape[1:]))

    def per_part(self, v):
        """A per-lane operand (one value per lane) as one value per part, a
        column over the stacked parts; one system's passes as it is."""
        if self.lanes is None:
            return v
        return v.repeat_interleave(self.parts).reshape(-1, 1)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The maximum of ``x``, per lane."""
        if self.lanes is None:
            return torch.max(x)
        return x.reshape(self.lanes, -1).amax(1)

    def across(self, flag: torch.Tensor) -> torch.Tensor:
        """A flag of this place's share combined over the places the system
        is split across: here the system is whole, the flag itself."""
        return flag


@dataclasses.dataclass
class PhaseToolkit:
    """The segregated-scheme phase functions bound to one solver (PISO and
    SIMPLE draw from one binding), with the pipelined form's factored
    phases and the binding's mask keys and lane layout."""

    asm: object
    padded: bool
    mask_keys: tuple[str, ...]
    asm_of: Callable            # (*masks) -> assembly view
    layout: LaneLayout
    moves: object | None        # the solver's MoveRecord over a mesh
    assemble_mom: Callable
    update_mom: Callable
    solve_mom: Callable
    assemble_p: Callable
    update_p: Callable
    solve_p: Callable
    # the pipelined form's factored phases: momentum assembly consuming a
    # ring-carried grad(p); the corrector-invariant pressure-matrix half;
    # the per-corrector source-only half; the standalone gradient
    assemble_mom_g: Callable
    assemble_p_mat: Callable
    assemble_p_src: Callable
    grad_p: Callable


def cohort_form(solver, lanes: int | None, lanes_of: Callable):
    """A program build's ``lanes_of``: None for a cohort build (it is one)
    and for a binding over a mesh, which steps alone (a full-mesh pressure
    system spans the shard mesh, a stacked one over a mesh keeps its state
    in the mesh's layout; the JAX engine batches neither)."""
    if lanes is not None or solver.spmd_mesh is not None:
        return None
    return lanes_of


def _binding(solver) -> tuple:
    """What a program closes over at its build: the momentum and pressure
    plans and the coarse part count (a later ``rebind_alpha`` changes the
    solver's, not the program's)."""
    return solver.plan_mom, solver.plan_p, solver.n_coarse


def _phase_toolkit(solver, lanes: int | None = None,
                   binding: tuple | None = None) -> PhaseToolkit:
    """Bind the phase functions to a solver's plans + SolverOps: for one
    system, or (``lanes``) for a cohort of that many lanes of the solver's
    mesh, the fields stacked one lane after another."""
    from repro_torch.fvm.piso import _offdiag3
    from repro_torch.solvers.bicgstab import bicgstab
    from repro_torch.solvers.cg import cg

    plan_m, plan_p, n_c = _binding(solver) if binding is None else binding
    layout = LaneLayout(lanes, solver.mesh.n_parts)
    n_c = n_c * (1 if lanes is None else lanes)
    asm = solver.asm if lanes is None else solver.asm.lane_view(lanes)
    padded = solver.padded
    # a padded program threads per-lane masks through the env; a plain one
    # uses the assembly's static masks
    mask_keys = ("if_mask", "patch_mask") if padded else ()

    def asm_of(*masks):
        return asm.with_masks(*masks) if masks else asm

    # -- momentum predictor (fine partition, BiCGStab, Jacobi) ------------
    def assemble_mom(U, phi, phi_if, phi_b, p, dt, *masks):
        return asm_of(*masks).assemble_momentum(U, phi, phi_if, p, dt,
                                                phi_b=phi_b)

    def update_mom(sysM):
        # the momentum system stays in the fine layout (alpha 1)
        return solver._bands(plan_m, sysM.diag, sysM.upper, sysM.lower,
                             sysM.iface, kind="update_mom")

    def solve_mom(bandsM, sysM, U):
        # the three velocity components one after another, each its own
        # BiCGStab with its own count; mom_iters is their max — what the
        # JAX package's vmapped while_loop reports
        opsM = solver._solver_ops(plan_m, bandsM, sysM.diag, lanes=lanes)
        res = [bicgstab(opsM, sysM.source[..., c].contiguous(),
                        U[..., c].contiguous(), tol=solver.mom_tol,
                        maxiter=solver.mom_maxiter) for c in range(3)]
        U_new = torch.stack([r.x for r in res], dim=2)
        # reduced on the device: no host read
        return (U_new, torch.stack([r.iters for r in res]).amax(0),
                torch.stack([r.converged for r in res]).all(0),
                torch.stack([r.hit_cap for r in res]).any(0))

    # -- the pressure equation --------------------------------------------
    def assemble_p(sysM, U, *masks):
        a = asm_of(*masks)
        rAU = a.V / sysM.diag
        HbyA = (sysM.source - _offdiag3(a, sysM, U)) / sysM.diag[..., None]
        phiH, phiH_if = a.face_flux(HbyA)
        phiH_b = a.boundary_flux(HbyA)
        sysP = a.assemble_pressure(rAU, phiH, phiH_if, phiH_b)
        return rAU, HbyA, phiH, phiH_if, phiH_b, sysP

    # over a mesh, the pressure operands are pinned to the solve layout
    # (the fine parts' shares go to their coarse part's owner, counted in
    # the solver's move record) and the solution comes back to the fine
    # layout for the correctors
    pin = solver._solve_constraint

    def update_p(sysP):
        return pin(solver._bands(plan_p, sysP.diag, sysP.upper, sysP.lower,
                                 sysP.iface, kind="update_p"))

    def solve_p(bandsP, sysP, p):
        b_c = pin(sysP.source.reshape(n_c, -1), "b_c")
        x0_c = pin(p.reshape(n_c, -1), "x0_c")
        diag_c = pin(sysP.diag.reshape(n_c, -1), "diag_c")
        opsP = solver._solver_ops(plan_p, bandsP, diag_c, lanes=lanes)
        sol = cg(opsP, b_c, x0_c, tol=solver.p_tol, maxiter=solver.p_maxiter)
        solver._count_owner("x_back", sol.x)
        return (sol.x.reshape(p.shape), sol.iters, sol.residual,
                sol.converged, sol.hit_cap)

    # -- the pipelined form's factored phases ------------------------------
    def assemble_mom_g(U, phi, phi_if, phi_b, gradp, dt, *masks):
        # the ring-carried grad(p) replaces the in-phase gradient: the
        # dataflow edge from step t's last corrector into step t+1
        return asm_of(*masks).assemble_momentum(U, phi, phi_if, None, dt,
                                                phi_b=phi_b, gradp=gradp)

    def assemble_p_mat(sysM, *masks):
        # corrector-invariant: every pressure-matrix coefficient depends
        # only on rAU = V / diag(momentum)
        a = asm_of(*masks)
        rAU = a.V / sysM.diag
        return rAU, a.assemble_pressure_matrix(rAU)

    def assemble_p_src(sysM, sysP_mat, rAU, U, *masks):
        # per corrector: only the divergence source changes with U
        a = asm_of(*masks)
        HbyA = (sysM.source - _offdiag3(a, sysM, U)) / sysM.diag[..., None]
        phiH, phiH_if = a.face_flux(HbyA)
        phiH_b = a.boundary_flux(HbyA)
        sysP = dataclasses.replace(
            sysP_mat, source=-a.divergence(phiH, phiH_if, phiH_b))
        return HbyA, phiH, phiH_if, phiH_b, sysP

    def grad_p(p, *masks):
        return asm_of(*masks).grad(p)

    tk = PhaseToolkit(
        asm=asm, padded=padded, mask_keys=mask_keys, asm_of=asm_of,
        layout=layout, moves=solver.moves, assemble_mom=assemble_mom,
        update_mom=update_mom,
        solve_mom=solve_mom, assemble_p=assemble_p, update_p=update_p,
        solve_p=solve_p, assemble_mom_g=assemble_mom_g,
        assemble_p_mat=assemble_p_mat, assemble_p_src=assemble_p_src,
        grad_p=grad_p)
    # a rank of a mesh over distinct devices (repro_torch.fvm.distinct)
    # swaps in its layout and its update and solve phases
    rank = getattr(solver, "rank", None)
    return tk if rank is None else rank.toolkit(tk, plan_m, plan_p, n_c)


def seed_env(tk: PhaseToolkit, state, dt, n_active=None) -> dict:
    """The env every program seeds: the state's fields (flattened over a
    cohort's lanes), ``dt`` (one value per part for a cohort) and, for a
    padded program, ``n_active`` with the activity masks derived from
    it."""
    lay = tk.layout
    if tk.moves is not None:
        tk.moves.reset()
    U, p, phi, phi_if, phi_b = (lay.flat(t) for t in state)
    if lay.lanes is not None:
        dt = dt.repeat_interleave(lay.parts)
    env = {"U": U, "p": p, "phi": phi, "phi_if": phi_if, "phi_b": phi_b,
           "dt": dt}
    if tk.padded:
        if_mask, patch_mask = tk.asm.dynamic_masks(n_active)
        env.update(n_active=n_active, if_mask=if_mask, patch_mask=patch_mask)
    return env


def final_state(tk: PhaseToolkit, env: dict):
    """The env's fields as a :class:`~repro_torch.fvm.piso.PisoState` (a
    cohort's with its leading lane axis back)."""
    from repro_torch.fvm.piso import PisoState

    return PisoState(*(tk.layout.unflat(env[k])
                       for k in ("U", "p", "phi", "phi_if", "phi_b")))


# ---------------------------------------------------------------------------
# The PISO program
# ---------------------------------------------------------------------------

def build_piso_program(solver, lanes: int | None = None,
                       binding: tuple | None = None) -> StepProgram:
    """Bind a solver's plans + SolverOps into the PISO phase list.

    A solver bound to a size-class :class:`~repro_torch.fvm.mesh.
    PaddedCavityMesh` (``solver.padded``) builds the **padded** program:
    the step takes one extra operand ``n_active`` (the session's real slab
    count), the seed derives the interface/patch activity masks from it
    (:meth:`~repro_torch.fvm.assembly.CavityAssembly.dynamic_masks`), and
    the assembly phases consume those masks instead of the static ones, so
    one program serves every session of the size class.  Ghost slabs stay
    exactly zero.

    The program also declares its pipelined form: momentum assembly from a
    ring-carried ``grad(p)``, the pressure matrix (and its update) built
    once per step beside the momentum solve, and a per-corrector source;
    and ``lanes_of``, its cohort form (``lanes``: this build is one).
    """
    from repro_torch.fvm.piso import StepStats

    binding = _binding(solver) if binding is None else binding
    tk = _phase_toolkit(solver, lanes, binding)
    lay, mask_keys = tk.layout, tk.mask_keys
    n_corr = solver.n_correctors
    if n_corr < 1:
        raise ValueError("the PISO program needs at least one corrector")

    def correct(sysP, phiH, phiH_if, phiH_b, p, HbyA, rAU, *masks):
        a = tk.asm_of(*masks)
        phi, phi_if = a.correct_flux(sysP, phiH, phiH_if, p)
        phi_b = a.correct_boundary_flux(sysP, phiH_b, p)
        U = HbyA - rAU[..., None] * a.grad(p)
        cont = lay.max(torch.abs(a.divergence(phi, phi_if, phi_b))) / a.V
        return phi, phi_if, phi_b, U, cont

    solve_p_outs = [("p", f"p_iters_{i}", "p_res", f"p_ok_{i}", f"p_cap_{i}")
                    for i in range(n_corr)]
    phases = [
        Phase("assemble_mom", "assembly",
              ("U", "phi", "phi_if", "phi_b", "p", "dt") + mask_keys,
              ("sysM",), tk.assemble_mom),
        Phase("update_mom", "assembly", ("sysM",), ("bandsM",),
              tk.update_mom),
        Phase("solve_mom", "assembly", ("bandsM", "sysM", "U"),
              ("U", "mom_iters", "mom_ok", "mom_cap"), tk.solve_mom),
    ]
    for i in range(n_corr):
        phases += [
            Phase("assemble_p", "assembly", ("sysM", "U") + mask_keys,
                  ("rAU", "HbyA", "phiH", "phiH_if", "phiH_b", "sysP"),
                  tk.assemble_p, corrector=i),
            Phase("update_p", "update", ("sysP",), ("bandsP",), tk.update_p,
                  corrector=i),
            Phase("solve_p", "solve", ("bandsP", "sysP", "p"),
                  solve_p_outs[i], tk.solve_p, corrector=i),
            Phase("correct", "assembly",
                  ("sysP", "phiH", "phiH_if", "phiH_b", "p", "HbyA", "rAU")
                  + mask_keys,
                  ("phi", "phi_if", "phi_b", "U", "cont"), correct,
                  corrector=i),
        ]

    seed_keys = ("U", "p", "phi", "phi_if", "phi_b", "dt")
    if tk.padded:
        def seed(state, dt, n_active):
            return seed_env(tk, state, dt, n_active)

        seed_keys += ("n_active", "if_mask", "patch_mask")
        extra_keys = ("n_active",)
    else:
        def seed(state, dt):
            return seed_env(tk, state, dt)

        extra_keys = ()

    def finalize(env):
        state = final_state(tk, env)
        ok, cap = env["mom_ok"], env["mom_cap"]
        for i in range(n_corr):
            ok = ok & env[f"p_ok_{i}"]
            cap = cap | env[f"p_cap_{i}"]
        converged, diverged, hit_cap = health_flags(
            state, ok, cap, env["cont"], env["p_res"], lanes=lay.lanes,
            across=lay.across)
        stats = StepStats(
            mom_iters=env["mom_iters"].to(torch.int32),
            p_iters=torch.stack([env[f"p_iters_{i}"] for i in range(n_corr)],
                                dim=-1).to(torch.int32),
            continuity_err=env["cont"],
            p_residual=env["p_res"],
            converged=converged, diverged=diverged, hit_cap=hit_cap)
        return state, stats

    # ---- the pipelined form ------------------------------------------------
    # The same step, factored so the dependence DAG exposes overlap:
    #  * assemble_mom consumes a RING-CARRIED grad(p), produced by the
    #    trailing grad_p phase of the previous step (the prime computes it
    #    for a window's first step);
    #  * the pressure matrix (and its DIA bands via update_p) is built ONCE
    #    per step from rAU only, next to the momentum solve, which it does
    #    not depend on (the overlap frontier);
    #  * each corrector then re-assembles only the divergence source.
    pipe_phases = [
        Phase("assemble_mom", "assembly",
              ("U", "phi", "phi_if", "phi_b", "gradp", "dt") + mask_keys,
              ("sysM",), tk.assemble_mom_g),
        Phase("update_mom", "assembly", ("sysM",), ("bandsM",),
              tk.update_mom),
        Phase("solve_mom", "assembly", ("bandsM", "sysM", "U"),
              ("U", "mom_iters", "mom_ok", "mom_cap"), tk.solve_mom,
              blocking=True),
        Phase("assemble_p_mat", "assembly", ("sysM",) + mask_keys,
              ("rAU", "sysP_mat"), tk.assemble_p_mat),
        Phase("update_p", "update", ("sysP_mat",), ("bandsP",),
              tk.update_p),
    ]
    for i in range(n_corr):
        pipe_phases += [
            Phase("assemble_p", "assembly",
                  ("sysM", "sysP_mat", "rAU", "U") + mask_keys,
                  ("HbyA", "phiH", "phiH_if", "phiH_b", "sysP"),
                  tk.assemble_p_src, corrector=i),
            Phase("solve_p", "solve", ("bandsP", "sysP", "p"),
                  solve_p_outs[i], tk.solve_p, corrector=i, blocking=True),
            Phase("correct", "assembly",
                  ("sysP", "phiH", "phiH_if", "phiH_b", "p", "HbyA", "rAU")
                  + mask_keys,
                  ("phi", "phi_if", "phi_b", "U", "cont"), correct,
                  corrector=i),
        ]
    pipe_phases.append(
        Phase("grad_p", "assembly", ("p",) + mask_keys, ("gradp",),
              tk.grad_p))

    def prime(env):
        # the pipeline prologue: the first step's gradient from the seeded p
        masks = tuple(env[k] for k in mask_keys)
        return {"gradp": tk.grad_p(env["p"], *masks)}

    pipeline = PipelineForm(phases=tuple(pipe_phases), ring=("gradp",),
                            prime=prime)

    def lanes_of(batch: int) -> StepProgram:
        return build_piso_program(solver, lanes=batch, binding=binding)

    return StepProgram(phases=tuple(phases), seed=seed, finalize=finalize,
                       seed_keys=seed_keys, extra_keys=extra_keys,
                       pipeline=pipeline,
                       lanes_of=cohort_form(solver, lanes, lanes_of),
                       moves=tk.moves)


register_program(ProgramSpec(
    name="piso",
    build=build_piso_program,
    transient=True,
    pipelined=True,
    description=("transient PISO: momentum predictor + n_correctors "
                 "pressure corrections per timestep (the paper's fig. 5/7 "
                 "decomposition), with a software-pipelined form "
                 "(ring-carried grad(p), the pressure matrix built once)"),
))
