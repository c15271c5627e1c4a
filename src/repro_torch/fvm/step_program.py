"""StepProgram — a segregated timestep as one declarative phase list.

A :class:`StepProgram` is an ordered tuple of named :class:`Phase` entries —
functions with declared env inputs/outputs and a cost-model phase tag —
built once per solver binding.  PISO (:func:`build_piso_program`) follows
the paper's fig. 5/7 decomposition: ``assemble_mom → update_mom →
solve_mom`` then, per corrector, ``assemble_p → update_p → solve_p →
correct``; SIMPLE (:mod:`repro_torch.fvm.simple`) is another phase list
over the same phase toolkit, with a convergence predicate.

:class:`SerialExecutor` walks the phases in declared order: ``step(state,
dt, *extra)`` advances one timestep, ``run_steps(state, dt, n, *extra)``
advances ``n`` and returns per-step stacked stats, and ``run_converged``
iterates a steady program until its ``converged`` predicate holds — the
contract of the JAX package's ``FusedExecutor``.  PyTorch runs eagerly, so
there is nothing to compile or donate; what JAX's fused window keeps off
the host is kept off it here too: every step statistic (Krylov counts,
flags, residuals) stays a device tensor, and a window of steps reads the
device only inside the Krylov solves, once per replayed block
(:mod:`repro_torch.solvers.device_loop`).
:class:`InstrumentedExecutor` walks the same phases with a CUDA event at
each phase boundary and bills each phase to its cost-model tag
(:class:`repro_torch.core.cost_model.PhaseBreakdown`); :func:`roll_schedule`
is the window cadence of the JAX launcher and engine.  Programs are
registered by name (:class:`ProgramSpec`, :func:`get_program`).  The
pipelined and batched executors are still to be ported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.core.cost_model import PhaseBreakdown

__all__ = ["Phase", "StepProgram", "SerialExecutor", "InstrumentedExecutor",
           "build_piso_program", "health_flags", "roll_schedule",
           "PHASE_TAGS", "ProgramSpec", "PROGRAMS", "register_program",
           "program_names", "get_program"]

# the cost-model buckets a phase may bill to
PHASE_TAGS = ("assembly", "update", "halo", "solve")


@dataclasses.dataclass(frozen=True)
class Phase:
    """One named step of the program.

    ``fn`` consumes ``inputs`` (env keys, positionally) and returns one
    value per name in ``outputs`` (a bare value when there is exactly
    one).  ``tag`` is the cost-model bucket the phase bills to; the
    attribution follows the paper's two partitions, so e.g. the momentum
    predictor's phases all bill to ``assembly`` even though one of them is
    a solve.  ``corrector`` marks per-corrector phase instances.
    """

    name: str
    tag: str
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]
    fn: Callable
    corrector: int | None = None

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


@dataclasses.dataclass(frozen=True)
class StepProgram:
    """An ordered phase list + env seeding/finalization: one timestep.

    ``seed(state, dt, *extra)`` produces the initial env dict (keys
    declared in ``seed_keys``); phases then read/write named env slots in
    order; ``finalize(env)`` folds the final env into ``(state, stats)``.
    Construction validates the dataflow: every phase input must be
    produced by the seed or an earlier phase, and every tag must be one of
    :data:`PHASE_TAGS`.
    """

    phases: tuple[Phase, ...]
    seed: Callable
    finalize: Callable
    seed_keys: tuple[str, ...]
    # names of the extra per-step operands beyond (state, dt), in the
    # order every executor entry point takes them (SIMPLE: its
    # under-relaxation factors)
    extra_keys: tuple[str, ...] = ()
    # the outer-loop convergence predicate ``stats -> bool tensor`` of a
    # steady program; None for a transient one (PISO)
    converged: Callable | None = None

    def __post_init__(self):
        available = set(self.seed_keys)
        for ph in self.phases:
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
            _bind(env, ph, ph.fn(*(env[k] for k in ph.inputs)))
        return self.finalize(env)


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
        stacked = type(history[0])(*(torch.stack(f) for f in zip(*history)))
        return state, stacked

    def run_converged(self, state, dt, max_iters: int, *extra):
        """Iterate a steady program until its ``converged`` predicate holds
        on the step's stats, at most ``max_iters`` times.

        The first step always runs; then the loop steps while ``k <
        max_iters`` and the predicate is false — one host read per outer
        iteration.  Returns ``(state, stats, n_outer)``: the last step's
        stats and the number of steps run (the cap when unconverged).
        """
        n = int(max_iters)
        if n < 1:
            raise ValueError(f"max_iters must be >= 1, got {max_iters}")
        conv = self.program.converged
        if conv is None:
            raise ValueError(
                "program declares no convergence predicate (converged="
                "None): run_converged is only meaningful for steady-state "
                "programs")
        state, stats = self.program.step(state, dt, *extra)
        k = 1
        while k < n and not bool(conv(stats)):
            state, stats = self.program.step(state, dt, *extra)
            k += 1
        return state, stats, k


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


class InstrumentedExecutor:
    """Walk the serial phase list with a timestamp at every phase boundary.

    The JAX package's ``InstrumentedExecutor``: the same phase functions in
    the same order as :class:`SerialExecutor`, so the result is the one
    ``step`` gives, bit for bit.  On a CUDA device the timestamps are CUDA
    events on the current stream, read after one synchronisation at the
    end of the step (the Krylov loops' own block reads aside, the walk adds
    no host read); each phase's seconds are billed to its tag.  ``halo`` is
    0: the port has no probe of the exchange yet (the stacked layout keeps
    every part on one device).
    """

    def __init__(self, program: StepProgram):
        self.program = program
        self.calls = 0

    def timed_step(self, state, dt, *extra):
        """One step; returns ``(state, stats, PhaseBreakdown)``."""
        self.calls += 1
        prog = self.program
        env = prog.seed(state, dt, *extra)
        clock = _PhaseClock(state[0].device)
        clock.mark()
        for ph in prog.phases:
            _bind(env, ph, ph.fn(*(env[k] for k in ph.inputs)))
            clock.mark()
        state, stats = prog.finalize(env)
        times = dict.fromkeys(PHASE_TAGS, 0.0)
        for ph, secs in zip(prog.phases, clock.seconds()):
            times[ph.tag] += secs
        return state, stats, PhaseBreakdown(**times)


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
    ``converged``).
    """

    name: str
    build: Callable
    transient: bool = True
    description: str = ""


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
                 *scalars):
    """Reduce a step's health to three boolean 0-d tensors, on the device.

    ``solver_ok`` and ``solver_cap`` are the step's Krylov flags reduced
    over its solves (0-d bool tensors).

    ``finite`` is an ``isfinite`` reduction over every state leaf plus the
    extra per-step scalars (residuals, continuity error).  Returns
    ``(converged, diverged, hit_cap)``: ``converged`` means every Krylov
    solve met its tolerance AND the state is finite; ``diverged`` means a
    non-finite value appeared; ``hit_cap`` means some solve exited at its
    iteration cap on an otherwise finite state.
    """
    finite = torch.stack([torch.isfinite(t).all()
                          for t in (*state, *scalars)]).all()
    return solver_ok & finite, ~finite, solver_cap & finite


# ---------------------------------------------------------------------------
# The phase functions, bound to one solver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PhaseToolkit:
    """The segregated-scheme phase functions bound to one solver."""

    asm: object
    assemble_mom: Callable
    update_mom: Callable
    solve_mom: Callable
    assemble_p: Callable
    update_p: Callable
    solve_p: Callable


def _phase_toolkit(solver) -> PhaseToolkit:
    """Bind the serial phase functions to a solver's plans + SolverOps."""
    from repro_torch.fvm.piso import _offdiag3
    from repro_torch.solvers.bicgstab import bicgstab
    from repro_torch.solvers.cg import cg

    asm = solver.asm
    plan_m, plan_p = solver.plan_mom, solver.plan_p
    n_c = solver.n_coarse

    # -- momentum predictor (fine partition, BiCGStab, Jacobi) ------------
    def assemble_mom(U, phi, phi_if, phi_b, p, dt):
        return asm.assemble_momentum(U, phi, phi_if, p, dt, phi_b=phi_b)

    def update_mom(sysM):
        return solver._bands(plan_m, sysM.diag, sysM.upper, sysM.lower,
                             sysM.iface)

    def solve_mom(bandsM, sysM, U):
        # the three velocity components one after another, each its own
        # BiCGStab with its own count; mom_iters is their max — what the
        # JAX package's vmapped while_loop reports
        opsM = solver._solver_ops(plan_m, bandsM, sysM.diag)
        res = [bicgstab(opsM, sysM.source[..., c].contiguous(),
                        U[..., c].contiguous(), tol=solver.mom_tol,
                        maxiter=solver.mom_maxiter) for c in range(3)]
        U_new = torch.stack([r.x for r in res], dim=2)
        # reduced on the device: no host read
        return (U_new, torch.stack([r.iters for r in res]).max(),
                torch.stack([r.converged for r in res]).all(),
                torch.stack([r.hit_cap for r in res]).any())

    # -- the pressure equation --------------------------------------------
    def assemble_p(sysM, U):
        rAU = asm.V / sysM.diag
        HbyA = (sysM.source - _offdiag3(asm, sysM, U)) / sysM.diag[..., None]
        phiH, phiH_if = asm.face_flux(HbyA)
        phiH_b = asm.boundary_flux(HbyA)
        sysP = asm.assemble_pressure(rAU, phiH, phiH_if, phiH_b)
        return rAU, HbyA, phiH, phiH_if, phiH_b, sysP

    def update_p(sysP):
        return solver._bands(plan_p, sysP.diag, sysP.upper, sysP.lower,
                             sysP.iface)

    def solve_p(bandsP, sysP, p):
        b_c = sysP.source.reshape(n_c, -1)
        x0_c = p.reshape(n_c, -1)
        diag_c = sysP.diag.reshape(n_c, -1)
        opsP = solver._solver_ops(plan_p, bandsP, diag_c)
        sol = cg(opsP, b_c, x0_c, tol=solver.p_tol, maxiter=solver.p_maxiter)
        return (sol.x.reshape(p.shape), sol.iters, sol.residual,
                sol.converged, sol.hit_cap)

    return PhaseToolkit(asm=asm, assemble_mom=assemble_mom,
                        update_mom=update_mom, solve_mom=solve_mom,
                        assemble_p=assemble_p, update_p=update_p,
                        solve_p=solve_p)


# ---------------------------------------------------------------------------
# The PISO program
# ---------------------------------------------------------------------------

def build_piso_program(solver) -> StepProgram:
    """Bind a solver's plans + SolverOps into the PISO phase list."""
    from repro_torch.fvm.piso import PisoState, StepStats

    tk = _phase_toolkit(solver)
    asm = tk.asm
    n_corr = solver.n_correctors
    if n_corr < 1:
        raise ValueError("the PISO program needs at least one corrector")

    def correct(sysP, phiH, phiH_if, phiH_b, p, HbyA, rAU):
        phi, phi_if = asm.correct_flux(sysP, phiH, phiH_if, p)
        phi_b = asm.correct_boundary_flux(sysP, phiH_b, p)
        U = HbyA - rAU[..., None] * asm.grad(p)
        cont = torch.max(torch.abs(asm.divergence(phi, phi_if, phi_b))) / asm.V
        return phi, phi_if, phi_b, U, cont

    phases = [
        Phase("assemble_mom", "assembly",
              ("U", "phi", "phi_if", "phi_b", "p", "dt"), ("sysM",),
              tk.assemble_mom),
        Phase("update_mom", "assembly", ("sysM",), ("bandsM",),
              tk.update_mom),
        Phase("solve_mom", "assembly", ("bandsM", "sysM", "U"),
              ("U", "mom_iters", "mom_ok", "mom_cap"), tk.solve_mom),
    ]
    for i in range(n_corr):
        phases += [
            Phase("assemble_p", "assembly", ("sysM", "U"),
                  ("rAU", "HbyA", "phiH", "phiH_if", "phiH_b", "sysP"),
                  tk.assemble_p, corrector=i),
            Phase("update_p", "update", ("sysP",), ("bandsP",), tk.update_p,
                  corrector=i),
            Phase("solve_p", "solve", ("bandsP", "sysP", "p"),
                  ("p", f"p_iters_{i}", "p_res", f"p_ok_{i}", f"p_cap_{i}"),
                  tk.solve_p, corrector=i),
            Phase("correct", "assembly",
                  ("sysP", "phiH", "phiH_if", "phiH_b", "p", "HbyA", "rAU"),
                  ("phi", "phi_if", "phi_b", "U", "cont"), correct,
                  corrector=i),
        ]

    def seed(state, dt):
        U, p, phi, phi_if, phi_b = state
        return {"U": U, "p": p, "phi": phi, "phi_if": phi_if,
                "phi_b": phi_b, "dt": dt}

    def finalize(env):
        state = PisoState(env["U"], env["p"], env["phi"], env["phi_if"],
                          env["phi_b"])
        ok, cap = env["mom_ok"], env["mom_cap"]
        for i in range(n_corr):
            ok = ok & env[f"p_ok_{i}"]
            cap = cap | env[f"p_cap_{i}"]
        converged, diverged, hit_cap = health_flags(
            state, ok, cap, env["cont"], env["p_res"])
        stats = StepStats(
            mom_iters=env["mom_iters"].to(torch.int32),
            p_iters=torch.stack([env[f"p_iters_{i}"]
                                 for i in range(n_corr)]).to(torch.int32),
            continuity_err=env["cont"],
            p_residual=env["p_res"],
            converged=converged, diverged=diverged, hit_cap=hit_cap)
        return state, stats

    return StepProgram(phases=tuple(phases), seed=seed, finalize=finalize,
                       seed_keys=("U", "p", "phi", "phi_if", "phi_b", "dt"))


register_program(ProgramSpec(
    name="piso",
    build=build_piso_program,
    transient=True,
    description=("transient PISO: momentum predictor + n_correctors "
                 "pressure corrections per timestep (the paper's fig. 5/7 "
                 "decomposition)"),
))
