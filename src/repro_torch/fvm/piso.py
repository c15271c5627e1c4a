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
StepProgram` phase list and walked by the serial executor.
:class:`SegregatedSolver` is the binder: it owns the plans (built once, on
the host), their device-resident gather indices, the SolverOps backend
dispatch and the assembly; :class:`PisoSolver` is the transient PISO
specialization.  The port runs the stacked layout (every coarse part's
rows on the one device).
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import torch

from repro_torch.core.ldu import buffer_from_parts
from repro_torch.core.repartition import RepartitionPlan, plan_for_mesh
from repro_torch.core.update import (dia_index, update_device_direct,
                                     update_host_buffer)
from repro_torch.env import DTYPE, resolve_device
from repro_torch.fvm.assembly import CavityAssembly
from repro_torch.fvm.cases import FlowCase, get_case
from repro_torch.fvm.mesh import CavityMesh
from repro_torch.fvm.step_program import (SerialExecutor,
                                         build_piso_program)
from repro_torch.solvers.jacobi import jacobi_preconditioner
from repro_torch.solvers.ops import (fused_stacked_ops, reference_ops,
                                     resolve_backend)
from repro_torch.sparse.distributed import spmv_dia

__all__ = ["SegregatedSolver", "PisoSolver", "PisoState", "StepStats"]


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
    """Bind a mesh + flow case + repartitioning ratio alpha into a stepper.

    ``solver_backend`` ("auto", "fused" or "reference") is read at every
    solve, so it may be changed between steps; "auto" is "fused" on a CUDA
    device.  ``plan_seconds`` records the host time the repartition plans
    took to build (kept out of the step time).
    """

    mesh: CavityMesh
    alpha: int = 1
    nu: float = 0.01
    lid_speed: float = 1.0
    n_correctors: int = 2
    case: str | FlowCase = "cavity"
    mom_tol: float = 1e-7
    p_tol: float = 1e-8
    # Krylov iteration caps (a capped exit raises StepStats.hit_cap)
    mom_maxiter: int = 500
    p_maxiter: int = 2000
    update_schedule: str = "device_direct"  # or "host_buffer" (paper fig. 9)
    dtype: torch.dtype = DTYPE
    solver_backend: str = "auto"
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.mesh.n_parts % self.alpha != 0:
            raise ValueError("alpha must divide the number of fine parts")
        resolve_backend(self.solver_backend, self.device)  # validates
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
        t0 = time.perf_counter()
        # identity repartition for the momentum (fine-partition) matrix
        self.plan_mom: RepartitionPlan = plan_for_mesh(self.mesh, 1)
        self.plan_p: RepartitionPlan = (
            self.plan_mom if self.alpha == 1
            else plan_for_mesh(self.mesh, self.alpha))
        self.plan_seconds = time.perf_counter() - t0
        self.n_coarse = self.mesh.n_parts // self.alpha
        # each plan's gather index, copied to the device once
        self._src = {id(plan): dia_index(plan, self.device)
                     for plan in (self.plan_mom, self.plan_p)}
        # the PISO phase list (the steady SIMPLE program is still to port)
        self.program = build_piso_program(self)
        self._exec = SerialExecutor(self.program)

    def _bands(self, plan: RepartitionPlan, diag, upper, lower, iface):
        """LDU buffers → repartitioned DIA bands via the update pattern."""
        buffers = buffer_from_parts(diag, upper, lower, iface)  # (P_f, L)
        n_c = buffers.shape[0] // plan.alpha
        grouped = buffers.reshape(n_c, plan.alpha, plan.buffer_len)
        return self._update(plan, grouped, self._src[id(plan)])

    def _solver_ops(self, plan: RepartitionPlan, bands, diag):
        """Bind the (bands, diag) system into a SolverOps bundle."""
        offsets = tuple(int(o) for o in plan.dia_offsets)
        if resolve_backend(self.solver_backend, bands.device) == "fused":
            return fused_stacked_ops(bands, diag, offsets=offsets,
                                     plane=plan.plane)

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

    def step(self, state: PisoState, dt: float):
        """One timestep; returns ``(state, StepStats)``."""
        return self._exec.step(state, dt)

    def run_steps(self, state: PisoState, dt: float, n_steps: int):
        """``n_steps`` timesteps; ``StepStats`` fields stacked per step."""
        return self._exec.run_steps(state, dt, n_steps)

    def run(self, n_steps: int, dt: float, state: PisoState | None = None):
        """``run_steps`` from ``state`` (default: the initial state)."""
        state = self.initial_state() if state is None else state
        return self.run_steps(state, dt, n_steps)


@dataclasses.dataclass
class PisoSolver(SegregatedSolver):
    """The transient PISO marcher (the paper's measured solver)."""


def _offdiag3(asm: CavityAssembly, sysM, U: torch.Tensor) -> torch.Tensor:
    """Off-diagonal apply per velocity component: (P, m, 3)."""
    return torch.stack([asm.offdiag_apply(sysM, U[..., c]) for c in range(3)],
                       dim=2)
