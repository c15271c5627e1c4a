"""icoFOAM PISO time loop over the repartitioned distributed system.

Faithful to the paper's measured configuration (§4):

* the **momentum** predictor is solved on the **fine** (CPU/assembly)
  partition with BiCGStab (an alpha=1 repartition plan, i.e. the identity
  repartition, gives the fine-partition DIA matrix);
* the **pressure** equation is repartitioned with ratio **alpha** onto the
  coarse (GPU/solve) partition and solved with CG;
* each PISO corrector re-sends the coefficients through the update pattern
  (paper fig. 3b) — the create/update split means no symbolic work per step.

The timestep is declared once as a :class:`~repro_torch.fvm.step_program.
StepProgram` phase list and walked by the serial executor
(:meth:`SegregatedSolver.timed_step`: by the instrumented one, which bills
each phase's time to its cost-model tag).  Step statistics stay device
tensors; a caller reads them when it logs.
:class:`SegregatedSolver` is the case- and program-agnostic binder: it owns
the plans (built once, on the host), their device-resident gather indices,
the SolverOps backend and precision dispatch and the assembly of a
:class:`~repro_torch.fvm.cases.FlowCase`, and builds the registered
program named by ``program_name``.  :class:`PisoSolver` (the transient
PISO marcher) and :class:`SimpleSolver` (the steady under-relaxed SIMPLE
iterator, ``run_steady``) are its registered specializations.
``rebind_alpha`` swaps the pressure side's ratio between steps and keeps
every ratio it has bound.  The port runs the stacked layout (every coarse
part's rows on the one device).
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import torch

from repro_torch.core.ldu import buffer_from_parts
from repro_torch.core.repartition import RepartitionPlan, plan_for_mesh
from repro_torch.core.update import update_device_direct, update_host_buffer
from repro_torch.env import DTYPE, resolve_device
from repro_torch.fvm.assembly import CavityAssembly
from repro_torch.fvm.cases import FlowCase, get_case
from repro_torch.fvm.mesh import CavityMesh
from repro_torch.fvm.step_program import (InstrumentedExecutor,
                                         SerialExecutor, get_program,
                                         roll_schedule)
from repro_torch.solvers.jacobi import jacobi_preconditioner
from repro_torch.solvers.ops import (fused_stacked_ops, reference_ops,
                                     resolve_backend)
from repro_torch.solvers.precision import get_policy
from repro_torch.sparse.distributed import spmv_dia

__all__ = ["SegregatedSolver", "PisoSolver", "SimpleSolver", "PisoState",
           "StepStats", "SOLVERS", "make_solver"]


class PisoState(NamedTuple):
    U: torch.Tensor       # (P, m, 3)
    p: torch.Tensor       # (P, m)
    phi: torch.Tensor     # (P, F) conservative face fluxes
    phi_if: torch.Tensor  # (P, 2, B)
    phi_b: torch.Tensor   # (P, 2, B) z-boundary fluxes (zero for the cavity)


class StepStats(NamedTuple):
    mom_iters: torch.Tensor       # max over the three velocity components
    p_iters: torch.Tensor         # (n_correctors,)
    continuity_err: torch.Tensor  # max |div(phi)| after correction
    p_residual: torch.Tensor
    # health: every Krylov solve met tolerance on a finite state / a
    # non-finite value appeared / some solve exited at its iteration cap
    converged: torch.Tensor
    diverged: torch.Tensor
    hit_cap: torch.Tensor


@dataclasses.dataclass
class SegregatedSolver:
    """Bind a mesh + flow case + repartitioning ratio alpha into a stepper
    of the registered program ``program_name``.

    ``solver_backend`` ("auto", "fused" or "reference") and ``precision``
    ("f64", "f32_ir" or "bf16_ir", the policies of
    :mod:`repro_torch.solvers.precision`) are read at every solve, so
    either may be changed between steps; "auto" is "fused" on a CUDA
    device.  Both the momentum BiCGStab and the pressure CG run under the
    policy.  ``plan_seconds`` records the host time the repartition plans
    took to build (kept out of the step time), :meth:`rebind_alpha`'s
    included.
    """

    mesh: CavityMesh
    alpha: int = 1
    nu: float = 0.01
    lid_speed: float = 1.0
    n_correctors: int = 2
    program_name: str = "piso"
    case: str | FlowCase = "cavity"
    # SIMPLE's under-relaxation factors (extra operands of its step) and
    # outer-loop convergence gates; unused by transient programs
    relax_u: float = 0.7
    relax_p: float = 0.3
    tol_continuity: float = 1e-5
    tol_u: float = 1e-6
    max_outer: int = 200
    mom_tol: float = 1e-7
    p_tol: float = 1e-8
    # Krylov iteration caps (a capped exit raises StepStats.hit_cap)
    mom_maxiter: int = 500
    p_maxiter: int = 2000
    update_schedule: str = "device_direct"  # or "host_buffer" (paper fig. 9)
    dtype: torch.dtype = DTYPE
    solver_backend: str = "auto"
    # mixed-precision Krylov policy: "f64" is the plain f64 solve;
    # "f32_ir"/"bf16_ir" run the inner sweeps at the storage dtype inside
    # an outer f64 iterative-refinement loop
    precision: str = "f64"
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        resolve_backend(self.solver_backend, self.device)  # validates
        get_policy(self.precision)  # raises on an unknown policy name
        get_program(self.program_name)  # raises on an unknown program
        if self.update_schedule not in ("device_direct", "host_buffer"):
            raise ValueError(
                f"unknown update schedule {self.update_schedule!r}")
        # the default cavity goes through the assembly's case=None path so
        # lid_speed keeps its meaning
        self.case_spec = get_case(self.case)
        self.case = self.case_spec.name
        asm_case = None if self.case == "cavity" else self.case_spec
        self.asm = CavityAssembly(self.mesh, nu=self.nu,
                                  lid_speed=self.lid_speed, dtype=self.dtype,
                                  case=asm_case, device=self.device)
        self._update = (update_device_direct
                        if self.update_schedule == "device_direct"
                        else update_host_buffer)
        self.plan_seconds = 0.0
        # identity repartition for the momentum (fine-partition) matrix
        self.plan_mom: RepartitionPlan = self._build_plan(1)
        # pressure plans per alpha, and per (program, alpha) the
        # (plan, program, executor) binding, each built once
        self._plans: dict[int, RepartitionPlan] = {1: self.plan_mom}
        self._bindings: dict[tuple[str, int], tuple] = {}
        self.rebind_alpha(self.alpha)

    def _build_plan(self, alpha: int) -> RepartitionPlan:
        """A plan built on the host, its gather index copied to the
        device once; the build's seconds go to ``plan_seconds``."""
        t0 = time.perf_counter()
        plan = plan_for_mesh(self.mesh, alpha)
        self.plan_seconds += time.perf_counter() - t0
        plan.src_on(self.device)
        return plan

    def rebind_alpha(self, alpha: int) -> None:
        """Swap the pressure side's repartitioning ratio, between steps.

        The state is alpha-independent (fine-partition layout), so a
        running simulation may switch.  A new alpha builds its plan on the
        host and the phase list of ``program_name``; a revisited ``(program,
        alpha)`` reuses its plan, device index and program, and builds
        nothing.
        """
        if self.mesh.n_parts % alpha != 0:
            raise ValueError("alpha must divide the number of fine parts")
        self.alpha = alpha
        self.n_coarse = self.mesh.n_parts // alpha
        key = (self.program_name, alpha)
        binding = self._bindings.get(key)
        if binding is None:
            if alpha not in self._plans:
                self._plans[alpha] = self._build_plan(alpha)
            # the program build reads plan_p and n_coarse off the solver
            self.plan_p = self._plans[alpha]
            program = get_program(self.program_name).build(self)
            binding = self._bindings[key] = (
                self.plan_p, program, SerialExecutor(program),
                InstrumentedExecutor(program))
        self.plan_p, self.program, self._exec, self._instrumented = binding

    def _bands(self, plan: RepartitionPlan, diag, upper, lower, iface):
        """LDU buffers → repartitioned DIA bands via the update pattern."""
        buffers = buffer_from_parts(diag, upper, lower, iface)  # (P_f, L)
        n_c = buffers.shape[0] // plan.alpha
        grouped = buffers.reshape(n_c, plan.alpha, plan.buffer_len)
        return self._update(plan, grouped)

    def _solver_ops(self, plan: RepartitionPlan, bands, diag):
        """Bind the (bands, diag) system into a SolverOps bundle under the
        current backend and precision policy."""
        offsets = tuple(int(o) for o in plan.dia_offsets)
        policy = get_policy(self.precision)
        if resolve_backend(self.solver_backend, bands.device) == "fused":
            return fused_stacked_ops(bands, diag, offsets=offsets,
                                     plane=plan.plane, policy=policy)

        if policy.refine:
            # inner sweep over downcast bands, outer f64 residual replay
            # over the originals
            bands_lo = bands.to(policy.storage_dtype)
            diag_lo = diag.to(policy.storage_dtype)

            def A_lo(x):
                return spmv_dia(bands_lo, x, offsets=offsets,
                                plane=plan.plane)

            def A_hi(x):
                return spmv_dia(bands, x, offsets=offsets, plane=plan.plane)

            return reference_ops(A_lo, jacobi_preconditioner(diag_lo),
                                 policy=policy, matvec_hi=A_hi)

        def A(x):
            return spmv_dia(bands, x, offsets=offsets, plane=plan.plane)

        return reference_ops(A, jacobi_preconditioner(diag))

    def initial_state(self) -> PisoState:
        P, m, F = self.mesh.n_parts, self.mesh.n_cells, self.mesh.n_faces
        B = self.mesh.plane

        def zeros(*shape):
            return torch.zeros(shape, dtype=self.dtype, device=self.device)

        U = zeros(P, m, 3)
        return PisoState(
            U=U,
            p=zeros(P, m),
            phi=zeros(P, F),
            phi_if=zeros(P, 2, B),
            # Dirichlet boundary fluxes are fixed from step 0 (exact zeros
            # for the cavity)
            phi_b=self.asm.boundary_flux(U),
        )

    def _extras(self) -> tuple:
        """The extra operands the bound program takes per step, by its
        ``extra_keys`` (SIMPLE: the under-relaxation factors)."""
        return tuple(float(getattr(self, k))
                     for k in self.program.extra_keys)

    def step(self, state: PisoState, dt: float):
        """One timestep (one outer iteration of a steady program);
        returns ``(state, stats)``."""
        return self._exec.step(state, dt, *self._extras())

    def run_steps(self, state: PisoState, dt: float, n_steps: int):
        """``n_steps`` timesteps; the stats fields stacked per step."""
        return self._exec.run_steps(state, dt, n_steps, *self._extras())

    def timed_step(self, state: PisoState, dt: float):
        """One step walked phase by phase with a timestamp at each phase
        boundary (:class:`~repro_torch.fvm.step_program.
        InstrumentedExecutor`); returns ``(state, stats, PhaseBreakdown)``.

        Attribution follows the paper's two partitions: **assembly** is
        the fine-partition share (the momentum predictor with its BiCGStab
        solve, pressure assembly, the corrections), **update** the
        coefficient update into the coarse plan, **solve** the pressure CG;
        **halo** is 0 (no probe yet).  The state and stats are the ones
        :meth:`step` gives, bit for bit.
        """
        return self._instrumented.timed_step(state, dt, *self._extras())

    def run(self, n_steps: int, dt: float, state: PisoState | None = None,
            scan_steps: int | None = None):
        """``n_steps`` steps from ``state`` (default: the initial state).

        By default one window (:meth:`run_steps`); ``scan_steps`` caps the
        window length (``roll_schedule``, as the JAX package's ``run``
        does), the per-step stats concatenated along the step axis.
        """
        state = self.initial_state() if state is None else state
        if scan_steps is None:
            return self.run_steps(state, dt, n_steps)
        windows = []
        for _sample, chunk in roll_schedule(0, n_steps, None, cap=scan_steps):
            state, w = self.run_steps(state, dt, chunk)
            windows.append(w)
        return state, type(windows[0])(*(torch.cat(f)
                                         for f in zip(*windows)))

    def run_steady(self, dt: float = 1.0, state: PisoState | None = None,
                   max_outer: int | None = None):
        """Outer-iterate to the program's convergence predicate (steady
        programs only: PISO declares none and raises).

        ``dt`` is ignored by a steady program (SIMPLE assembles with an
        infinite timestep).  Returns ``(state, stats, n_outer)`` with
        ``stats`` the last outer iteration's and ``n_outer`` the number
        run (the cap, ``max_outer`` or the solver's, when unconverged).
        """
        state = self.initial_state() if state is None else state
        cap = self.max_outer if max_outer is None else max_outer
        return self._exec.run_converged(state, dt, cap, *self._extras())


@dataclasses.dataclass
class PisoSolver(SegregatedSolver):
    """The transient PISO marcher (the paper's measured solver)."""

    program_name: str = "piso"


@dataclasses.dataclass
class SimpleSolver(SegregatedSolver):
    """The steady-state under-relaxed SIMPLE iterator (``run_steady``).

    One pressure correction per outer iteration (simpleFoam), implicit
    momentum under-relaxation by ``relax_u``, explicit pressure relaxation
    by ``relax_p``; converged when both the continuity error and the outer
    velocity change drop below their gates.
    """

    program_name: str = "simple"
    n_correctors: int = 1


SOLVERS: dict[str, type] = {"piso": PisoSolver, "simple": SimpleSolver}


def make_solver(program: str, mesh: CavityMesh, **kw) -> SegregatedSolver:
    """Construct the registered solver specialization for a program name."""
    try:
        cls = SOLVERS[program]
    except KeyError:
        raise KeyError(f"unknown program {program!r} "
                       f"(registered: {tuple(sorted(SOLVERS))})") from None
    return cls(mesh, **kw)


def _offdiag3(asm: CavityAssembly, sysM, U: torch.Tensor) -> torch.Tensor:
    """Off-diagonal apply per velocity component: (P, m, 3)."""
    return torch.stack([asm.offdiag_apply(sysM, U[..., c]) for c in range(3)],
                       dim=2)
