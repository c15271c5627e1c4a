"""StepProgram — the PISO timestep as one declarative phase list.

A :class:`StepProgram` is an ordered tuple of named :class:`Phase` entries —
functions with declared env inputs/outputs and a cost-model phase tag —
built once per solver binding by :func:`build_piso_program`.  The phase
order is the paper's fig. 5/7 decomposition: ``assemble_mom → update_mom →
solve_mom`` then, per corrector, ``assemble_p → update_p → solve_p →
correct``.

:class:`SerialExecutor` walks the phases in declared order: ``step(state,
dt)`` advances one timestep and ``run_steps(state, dt, n)`` advances ``n``
and returns per-step stacked :class:`~repro_torch.fvm.piso.StepStats` —
the contract of the JAX package's ``FusedExecutor``.  PyTorch runs
eagerly, so there is nothing to compile or donate; the pipelined, batched
and instrumented executors are still to be ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["Phase", "StepProgram", "SerialExecutor", "build_piso_program",
           "health_flags", "PHASE_TAGS"]

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

    ``seed(state, dt)`` produces the initial env dict (keys declared in
    ``seed_keys``); phases then read/write named env slots in order;
    ``finalize(env)`` folds the final env into ``(state, stats)``.
    Construction validates the dataflow: every phase input must be
    produced by the seed or an earlier phase, and every tag must be one of
    :data:`PHASE_TAGS`.
    """

    phases: tuple[Phase, ...]
    seed: Callable
    finalize: Callable
    seed_keys: tuple[str, ...]

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

    def step(self, state, dt):
        """One timestep: ``(state, dt) -> (state, stats)``."""
        env = self.seed(state, dt)
        for ph in self.phases:
            _bind(env, ph, ph.fn(*(env[k] for k in ph.inputs)))
        return self.finalize(env)


class SerialExecutor:
    """Walk the program's phases in declared order, one step at a time."""

    def __init__(self, program: StepProgram):
        self.program = program

    def step(self, state, dt):
        """One timestep; returns ``(state, StepStats)``."""
        return self.program.step(state, dt)

    def run_steps(self, state, dt, n_steps: int):
        """``n_steps`` timesteps; every ``StepStats`` field comes back
        stacked along a leading ``n_steps`` axis."""
        n = int(n_steps)
        if n < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        history = []
        for _ in range(n):
            state, stats = self.program.step(state, dt)
            history.append(stats)
        stacked = type(history[0])(*(torch.stack(f) for f in zip(*history)))
        return state, stacked


# ---------------------------------------------------------------------------
# Health signals
# ---------------------------------------------------------------------------

def health_flags(state, solver_ok: bool, solver_cap: bool, *scalars):
    """Reduce a step's health to three boolean 0-d tensors.

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
        return (U_new, max(r.iters for r in res),
                all(r.converged for r in res), any(r.hit_cap for r in res))

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
    """Bind a ``PisoSolver``'s plans + SolverOps into the PISO phase list."""
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
        ok = env["mom_ok"] and all(env[f"p_ok_{i}"] for i in range(n_corr))
        cap = env["mom_cap"] or any(env[f"p_cap_{i}"] for i in range(n_corr))
        converged, diverged, hit_cap = health_flags(
            state, ok, cap, env["cont"], env["p_res"])
        device = env["cont"].device

        def ints(*xs):
            return torch.tensor(xs, dtype=torch.int32, device=device)

        stats = StepStats(
            mom_iters=ints(env["mom_iters"])[0],
            p_iters=ints(*(env[f"p_iters_{i}"] for i in range(n_corr))),
            continuity_err=env["cont"],
            p_residual=env["p_res"],
            converged=converged, diverged=diverged, hit_cap=hit_cap)
        return state, stats

    return StepProgram(phases=tuple(phases), seed=seed, finalize=finalize,
                       seed_keys=("U", "p", "phi", "phi_if", "phi_b", "dt"))
