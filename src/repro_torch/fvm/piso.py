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
every ratio it has bound; with a shared
:class:`~repro_torch.core.controller.PlanCache` (``plan_cache``) the plans
come from the cache.  ``solve_mode`` picks the pressure solve's layout:
"stacked" (every coarse part's rows together on the solver's device) or
"full_mesh" (the fused system's rows cut into ``n_coarse * alpha`` row
shards over ``spmd_mesh``, :mod:`repro_torch.core.comm` and
:mod:`repro_torch.sparse.shardmap_spmv`; the momentum solve, alpha 1, stays
stacked).  "stacked" with an explicit ``spmd_mesh`` is the paper's own
layout: the fine state in the assembly layout over the ``(solve,
assemble)`` mesh, the pressure system pinned to the solve layout, and each
step's moves between the two counted in ``moves`` (and, over distinct
devices, carried: :mod:`repro_torch.fvm.distinct`).

The serving surface: ``pipeline`` ("auto" | "on" | "off") picks the
software-pipelined executor for a program that declares one (``_stepper``);
a size-class :class:`~repro_torch.fvm.mesh.PaddedCavityMesh` makes the
solver ``padded`` (its program takes ``n_active``); :func:`stack_states` /
:func:`unstack_states` move sessions in and out of a cohort, and
:meth:`SegregatedSolver.batched_executor` steps a cohort of sessions of
this binding.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import torch

from repro_torch.core.comm import (ShardMesh, assembly_layout,
                                   canonical_device, make_cfd_mesh,
                                   solve_constraint, stacked_layout)
from repro_torch.core.layout import Sharded
from repro_torch.core.ldu import buffer_from_parts
from repro_torch.core.repartition import RepartitionPlan, plan_for_mesh
from repro_torch.core.update import (MoveRecord, halo_moves, owner_moves,
                                     update_device_direct, update_host_buffer,
                                     update_moves)
from repro_torch.env import DTYPE, resolve_device
from repro_torch.fvm.assembly import CavityAssembly
from repro_torch.fvm.distinct import DistinctSteps
from repro_torch.fvm.cases import FlowCase, get_case
from repro_torch.fvm.mesh import CavityMesh
from repro_torch.fvm.step_program import (ProgramExecutors, get_program,
                                         roll_schedule)
from repro_torch.solvers.jacobi import jacobi_preconditioner
from repro_torch.solvers.ops import (fused_stacked_ops, reference_ops,
                                     resolve_backend)
from repro_torch.solvers.precision import get_policy
from repro_torch.sparse.distributed import spmv_dia

__all__ = ["SegregatedSolver", "PisoSolver", "SimpleSolver", "PisoState",
           "StepStats", "SOLVERS", "make_solver", "stack_states",
           "unstack_states", "PIPELINE_MODES", "SOLVE_MODES"]

PIPELINE_MODES = ("auto", "on", "off")
SOLVE_MODES = ("stacked", "full_mesh")


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


def stack_states(states, pad_to: int | None = None) -> PisoState:
    """Stack per-session states along a new leading session axis: the
    cohort form the batched executors take.  All states share leaf shapes
    and dtypes (the cohort contract).

    ``pad_to`` appends all-zero **filler lanes** until the leading axis
    reaches that size, so a cohort can ride a lane-class executor (a
    power-of-two batch).  With a padded program a filler lane carries
    ``n_active=0``: every mask is zero and its Krylov loops stop at once.
    """
    states = list(states)
    if not states:
        raise ValueError("cannot stack an empty session list")
    if pad_to is not None:
        if pad_to < len(states):
            raise ValueError(
                f"pad_to={pad_to} below cohort size {len(states)}")
        filler = PisoState(*(torch.zeros_like(t) for t in states[0]))
        states = states + [filler] * (pad_to - len(states))
    return PisoState(*(torch.stack(leaves) for leaves in zip(*states)))


def unstack_states(stacked: PisoState, n: int | None = None):
    """Split a cohort-stacked state back into per-session states (views),
    the first ``n`` (default: all) — trailing filler lanes are dropped."""
    lead = stacked[0].shape[0]
    n = lead if n is None else n
    if n > lead:
        raise ValueError(f"requested {n} sessions from a stack of {lead}")
    return [PisoState(*(t[i] for t in stacked)) for i in range(n)]


@dataclasses.dataclass
class SegregatedSolver:
    """Bind a mesh + flow case + repartitioning ratio alpha into a stepper
    of the registered program ``program_name``.

    ``solver_backend`` ("auto", "fused" or "reference") and ``precision``
    ("f64", "f32_ir" or "bf16_ir", the policies of
    :mod:`repro_torch.solvers.precision`) are read at every solve, so
    either may be changed between steps; "auto" is "fused" on a CUDA
    device.  Both the momentum BiCGStab and the pressure CG run under the
    policy.  ``plan_cache``, when given, supplies every plan (the key
    convention of the controller's ``plan``: the stacked mode, the
    requested backend and the policy as key components).
    ``plan_seconds`` records the host time the repartition plans took to
    build (kept out of the step time; with a cache, only its misses),
    :meth:`rebind_alpha`'s included.  ``pipeline`` ("auto" | "on" |
    "off"): the software-pipelined executor whenever the program declares
    a pipelined form ("auto"), always ("on": a program without one
    raises), or never; the resolved boolean is ``pipelined``.

    ``solve_mode="full_mesh"`` (``full_mesh_solve=True`` is the JAX
    package's alias) solves the pressure system over ``spmd_mesh``, a
    :class:`~repro_torch.core.comm.ShardMesh` whose first shard is on
    ``device``; without one, the mesh is built from the distinct visible
    devices of ``device``'s type and rebuilt at every
    :meth:`rebind_alpha`, and too few devices raise.  An explicit mesh is
    reshaped over the same devices when alpha changes.  The full mesh is
    f64 only and unpadded, as in JAX: a refined ``precision`` raises at
    construction and, set later, at the next solve.  Where an explicit
    mesh's shards name several distinct devices, each pressure CG runs one
    host loop a device over that device's rows
    (:class:`~repro_torch.sparse.shardmap_spmv.ShardRanks`, either
    backend), and ``moves`` books what it carries between devices (the
    rows of ``b_c``, ``x0_c``, ``diag_c`` and the bands, ``bands_p``, to
    each device, the solution back, a product's planes, ``solve_halo``).

    ``solve_mode="stacked"`` with an explicit ``spmd_mesh`` (a
    :class:`~repro_torch.core.comm.ShardMesh`, or a ``DeviceMesh`` with
    the axes ``("solve", "assemble")``) runs the paper's layout: fine part
    ``f`` on its position of the assembly layout, coarse part ``c`` solved
    at its owner (:func:`~repro_torch.core.update.owner_positions`).  Its
    first position must be on ``device``.  On a mesh of one device the
    device's positions are one tensor, so the step is the stacked step,
    launch for launch and bit for bit.  A mesh whose positions name
    distinct devices steps through :mod:`repro_torch.fvm.distinct` (a
    thread a device, each on its own parts; the updates, operands and
    solution carried between devices), in every precision policy and on a
    padded (size-class) mesh, as JAX's stacked mode runs them.  The mesh
    keeps its shape across :meth:`rebind_alpha`, as JAX's does, and the
    owners follow JAX's block rule.  ``moves`` records what each step
    carries between positions and between devices, by kind
    (:class:`~repro_torch.core.update.MoveRecord`: the two value updates,
    the solve operands ``b_c``, ``x0_c`` and ``diag_c`` to the owners, the
    solution back, the assembly's neighbour planes); it is None without
    such a mesh.  :meth:`step`, :meth:`run_steps`,
    :meth:`run`, :meth:`timed_step` and :meth:`run_steady` take a state
    whose leaves are in the assembly layout
    (:func:`~repro_torch.core.comm.assembly_layout`, each shard on its
    position's device) as well as a stacked one, and hand the state back
    in the layout it came in.
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
    # an optional shared PlanCache (repro_torch.core.controller)
    plan_cache: object | None = None
    # software-pipelined stepping: "auto" | "on" | "off"
    pipeline: str = "auto"
    # the pressure solve's layout (class doc); full_mesh_solve is the JAX
    # package's legacy alias for solve_mode="full_mesh"
    solve_mode: str = "stacked"
    spmd_mesh: object | None = None
    full_mesh_solve: bool = False

    def __post_init__(self):
        self.device = resolve_device(self.device)
        resolve_backend(self.solver_backend, self.device)  # validates
        get_policy(self.precision)  # raises on an unknown policy name
        if self.full_mesh_solve and self.solve_mode == "stacked":
            self.solve_mode = "full_mesh"
        if self.solve_mode not in SOLVE_MODES:
            raise ValueError(f"unknown solve_mode {self.solve_mode!r}")
        self.full_mesh_solve = self.solve_mode == "full_mesh"
        self._check_full_mesh_policy(self.precision)
        spec = get_program(self.program_name)  # raises on an unknown one
        if self.pipeline not in PIPELINE_MODES:
            raise ValueError(f"unknown pipeline mode {self.pipeline!r} "
                             f"(choose auto|on|off)")
        if self.pipeline == "on" and not spec.pipelined:
            raise ValueError(
                f"program {self.program_name!r} declares no pipelined form "
                f"(steady programs cannot software-pipeline across an "
                f"unknown outer trip count) — use pipeline='auto' or 'off'")
        self.pipelined = (self.pipeline == "on"
                          or (self.pipeline == "auto" and spec.pipelined))
        # size-class serving: a PaddedCavityMesh carries ghost slabs whose
        # activity follows the per-session n_active operand
        self.padded = getattr(self.mesh, "n_parts_real", None) is not None
        self.n_active = self.mesh.n_parts_active
        if self.padded and self.full_mesh_solve:
            raise ValueError(
                "padded (size-class) meshes require solve_mode='stacked'")
        # an explicit mesh is kept (the full mesh reshapes it); otherwise
        # the full mesh builds its own at every ratio
        self._auto_mesh = self.spmd_mesh is None
        self.moves = None
        self._distinct = None
        stacked_mesh = False
        if self.spmd_mesh is not None:
            self.spmd_mesh = ShardMesh.from_device_mesh(self.spmd_mesh)
            stacked_mesh = not self.full_mesh_solve
            if stacked_mesh:
                self._check_stacked_mesh(self.spmd_mesh)
            # a full mesh over several devices books what its solves carry
            if stacked_mesh or self.spmd_mesh.one_device is None:
                self.moves = MoveRecord()
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
        if stacked_mesh:
            self.asm.on_halo = self._count_halo
        self._update = (update_device_direct
                        if self.update_schedule == "device_direct"
                        else update_host_buffer)
        self.plan_seconds = 0.0
        # without a cache, the plans per alpha; and per (program, alpha,
        # mode, backend, policy, pipelined) the (plan, executors) binding,
        # each built once
        self._plans: dict[int, RepartitionPlan] = {}
        self._bindings: dict[tuple, tuple] = {}
        # identity repartition for the momentum (fine-partition) matrix
        self.plan_mom: RepartitionPlan = self._plan_for(1)
        self.rebind_alpha(self.alpha)
        if stacked_mesh and self.spmd_mesh.one_device is None:
            self._distinct = DistinctSteps(self)

    def _plan_for(self, alpha: int) -> RepartitionPlan:
        """The plan for ``alpha``: from ``plan_cache`` when given, else
        built once per solver; a build runs on the host, its seconds go to
        ``plan_seconds``, and the gather index is copied to the device
        once."""
        t0 = time.perf_counter()
        if self.plan_cache is not None:
            misses = self.plan_cache.misses
            plan = self.plan_cache.plan_for_mesh(
                self.mesh, alpha, "dia", mode=self.solve_mode,
                backend=self.solver_backend, precision=self.precision)
            built = self.plan_cache.misses != misses
        else:
            plan = self._plans.get(alpha)
            built = plan is None
            if built:
                plan = self._plans[alpha] = plan_for_mesh(self.mesh, alpha)
        if built:
            self.plan_seconds += time.perf_counter() - t0
        plan.src_on(self.device)
        return plan

    def rebind_alpha(self, alpha: int) -> None:
        """Swap the pressure side's repartitioning ratio, between steps.

        The state is alpha-independent (fine-partition layout), so a
        running simulation may switch.  A new alpha builds its plan on the
        host (or takes it from ``plan_cache``, which counts a hit) and the
        phase list of ``program_name``; a revisited ``(program, alpha,
        solver_backend, precision)`` reuses its plan, device index and
        program, and builds nothing.  The mode, the backend and the policy
        key the binding as they key the cache, so the binding always holds
        the plan the cache returned for them.  In full-mesh mode the
        automatic mesh is rebuilt at the new shape and an explicit one
        reshaped over its devices; in stacked mode an explicit mesh keeps
        its shape (JAX's), and the coarse parts go to its solve rows by the
        block rule.
        """
        if self.mesh.n_parts % alpha != 0:
            raise ValueError("alpha must divide the number of fine parts")
        n_coarse = self.mesh.n_parts // alpha
        if self.full_mesh_solve:
            self.spmd_mesh = self._mesh_for(n_coarse, alpha)
        plan = self._plan_for(alpha)
        self.alpha = alpha
        self.n_coarse = n_coarse
        key = (self.program_name, alpha, self.solve_mode, self.solver_backend,
               self.precision, self.pipelined)
        binding = self._bindings.get(key)
        if binding is None:
            # the program build reads plan_p and n_coarse off the solver
            self.plan_p = plan
            program = get_program(self.program_name).build(self)
            binding = self._bindings[key] = (self.plan_p,
                                             ProgramExecutors(program))
        self.plan_p, self._exec = binding
        self.program = self._exec.program
        self._instrumented = self._exec.instrumented

    def _mesh_for(self, n_coarse: int, alpha: int):
        """The full mesh at ``(n_coarse, alpha)``: built from the visible
        devices, or the explicit mesh reshaped over its devices; its first
        shard must be on the solver's device."""
        if self._auto_mesh:
            mesh = make_cfd_mesh(n_coarse, alpha,
                                 device_type=self.device.type)
        elif tuple(self.spmd_mesh.shape) != (n_coarse, alpha):
            mesh = make_cfd_mesh(n_coarse, alpha,
                                 devices=self.spmd_mesh.flat())
        else:
            mesh = self.spmd_mesh
        first, home = mesh.flat()[0], canonical_device(self.device)
        if first != home:
            raise ValueError(f"the mesh's first shard is on {first}, the "
                             f"solver's state on {home}")
        return mesh

    def _check_stacked_mesh(self, mesh: ShardMesh) -> None:
        """A stacked solve's mesh: the first position on the solver's
        device, the fine parts in equal blocks over the positions."""
        first, home = mesh.flat()[0], canonical_device(self.device)
        if first != home:
            raise ValueError(f"the mesh's first position is on {first}, "
                             f"the solver's state on {home}")
        if self.mesh.n_parts % mesh.size:
            raise ValueError(f"{self.mesh.n_parts} fine parts do not lay "
                             f"out over {mesh.size} mesh positions")

    def _count_halo(self, x: torch.Tensor) -> None:
        """The assembly's neighbour planes of ``x`` across positions."""
        plane_bytes = self.mesh.plane * x.element_size() * x[0, 0].numel()
        self.moves.add("halo", halo_moves(self.spmd_mesh, self.mesh.n_parts,
                                          plane_bytes))

    def _solve_constraint(self, x: torch.Tensor, kind: str | None = None
                          ) -> torch.Tensor:
        """Pin a solve-phase tensor ``(n_c, ...)`` to the solve layout
        (:func:`~repro_torch.core.comm.solve_constraint`, a no-op off a
        mesh).  ``kind`` names the move that takes it there from the fine
        layout, each fine part's share to its owner, added to ``moves``."""
        x = solve_constraint(self.spmd_mesh, x, full_mesh=self.full_mesh_solve)
        if kind is not None:
            self._count_owner(kind, x)
        return x

    def _count_owner(self, kind: str, x: torch.Tensor) -> None:
        """Each fine part's share of the coarse ``x`` between its position
        and its owner, added to ``moves`` (off a mesh: nothing)."""
        P = self.mesh.n_parts
        self._count_owner_bytes(kind, P // x.shape[0],
                                x.numel() * x.element_size() // P)

    def _count_owner_bytes(self, kind: str, alpha: int,
                           part_bytes: int) -> None:
        """``part_bytes`` of each fine part between its position and its
        coarse part's owner at ratio ``alpha``, added to ``moves`` (the
        stacked layout's)."""
        if self.moves is not None and not self.full_mesh_solve:
            self.moves.add(kind, owner_moves(self.spmd_mesh,
                                             self.mesh.n_parts, alpha,
                                             part_bytes))

    def _count_update(self, kind: str, plan: RepartitionPlan,
                      itemsize: int) -> None:
        """What one value update of ``plan`` carries, added to ``moves``
        (``kind`` "update_mom": the bands stay in the fine layout;
        "update_p": they go to the solve layout; the stacked layout's)."""
        if self.moves is not None and not self.full_mesh_solve:
            self.moves.add(kind, update_moves(
                self.spmd_mesh, self.mesh.n_parts, plan.alpha,
                plan.buffer_len * itemsize, self.update_schedule,
                solve_layout=kind != "update_mom"))

    def _check_full_mesh_policy(self, precision: str) -> None:
        if precision != "f64" and self.full_mesh_solve:
            raise ValueError(
                "mixed-precision policies require solve_mode='stacked' "
                "(the full-mesh backend is f64-only)")

    def _use_full_mesh(self, plan: RepartitionPlan) -> bool:
        """The full-mesh SpMV serves multi-part fused systems only: the
        momentum (alpha 1, fine-partition) solve keeps the stacked path."""
        return (self.full_mesh_solve and self.spmd_mesh is not None
                and plan.alpha > 1)

    def _bands(self, plan: RepartitionPlan, diag, upper, lower, iface,
               kind: str | None = None):
        """LDU buffers → repartitioned DIA bands via the update pattern.
        ``kind`` ("update_mom": the bands stay in the fine layout;
        "update_p": they go to the solve layout) counts the update's moves
        in ``moves``."""
        buffers = buffer_from_parts(diag, upper, lower, iface)  # (P_f, L)
        n_c = buffers.shape[0] // plan.alpha
        grouped = buffers.reshape(n_c, plan.alpha, plan.buffer_len)
        if kind is not None:
            self._count_update(kind, plan, buffers.element_size())
        return self._update(plan, grouped)

    def _solver_ops(self, plan: RepartitionPlan, bands, diag,
                    lanes: int | None = None):
        """Bind the (bands, diag) system into a SolverOps bundle under the
        current backend and precision policy; ``lanes``: the bands are a
        cohort of that many lanes (:mod:`repro_torch.solvers.ops`)."""
        offsets = tuple(int(o) for o in plan.dia_offsets)
        policy = get_policy(self.precision)
        # read at every solve: a full-mesh solver never runs a refined
        # policy, nor quietly the stacked layout instead
        self._check_full_mesh_policy(policy.name)
        if self._use_full_mesh(plan):
            return self._full_mesh_ops(plan, bands, diag, offsets, lanes)
        if resolve_backend(self.solver_backend, bands.device) == "fused":
            return fused_stacked_ops(bands, diag, offsets=offsets,
                                     plane=plan.plane, policy=policy,
                                     lanes=lanes)
        n = 1 if lanes is None else lanes

        def over(b):
            def A(x):
                return spmv_dia(b, x, offsets=offsets, plane=plan.plane,
                                lanes=n)
            return A

        if policy.refine:
            # inner sweep over downcast bands, outer f64 residual replay
            # over the originals
            bands_lo = bands.to(policy.storage_dtype)
            diag_lo = diag.to(policy.storage_dtype)
            return reference_ops(over(bands_lo),
                                 jacobi_preconditioner(diag_lo),
                                 policy=policy, matvec_hi=over(bands),
                                 lanes=lanes)
        return reference_ops(over(bands), jacobi_preconditioner(diag),
                             lanes=lanes)

    def _full_mesh_ops(self, plan: RepartitionPlan, bands, diag, offsets,
                       lanes):
        """The full-mesh bundle (:mod:`repro_torch.sparse.shardmap_spmv`):
        the fused backend's kernels over the shards, or the reference
        backend's plain PyTorch; over several devices either runs a host
        loop a device on the device's own rows, its copies booked in
        ``moves``."""
        from repro_torch.core.comm import to_shards
        from repro_torch.sparse.shardmap_spmv import (
            make_fused_ops_full_mesh, make_jacobi_full_mesh,
            make_rank_ops_full_mesh, make_spmv_full_mesh)

        if lanes is not None:
            raise ValueError("a full-mesh system steps alone: it has no "
                             "cohort form")
        mesh = self.spmd_mesh
        kw = dict(offsets=offsets, plane=plan.plane,
                  n_coarse=self.mesh.n_parts // plan.alpha, alpha=plan.alpha,
                  m_coarse=plan.m_coarse)
        if resolve_backend(self.solver_backend, bands.device) == "fused":
            return make_fused_ops_full_mesh(mesh, bands, diag,
                                            moves=self.moves, **kw)
        if mesh.one_device is None:
            return make_rank_ops_full_mesh(mesh, bands, diag, kernels=False,
                                           moves=self.moves, **kw)
        fm = make_spmv_full_mesh(mesh, use_kernel=False, **kw)
        b_sh = to_shards(bands, plan.alpha)
        return reference_ops(lambda x: fm(b_sh, x),
                             make_jacobi_full_mesh(mesh, diag))

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

    def _extra_value(self, key: str, filler: bool = False):
        """One extra operand by name (``program.extra_keys``).

        ``filler=True`` is the value a zero lane of a padded cohort carries
        (``n_active=0`` deactivates every mask; the relaxation factors keep
        their real values, harmless on a zeroed state)."""
        if key == "n_active":
            return 0 if filler else int(self.n_active)
        if key in ("relax_u", "relax_p"):
            return float(getattr(self, key))
        raise KeyError(f"program asks for unknown extra operand {key!r}")

    def _extras(self) -> tuple:
        """The extra operands the bound program takes per step, by its
        ``extra_keys``: a padded program's real slab count ``n_active``,
        SIMPLE's under-relaxation factors."""
        return tuple(self._extra_value(k) for k in self.program.extra_keys)

    def _filler_extras(self) -> tuple:
        """The extras a padded cohort's zero filler lane carries."""
        return tuple(self._extra_value(k, filler=True)
                     for k in self.program.extra_keys)

    def lane_extras(self, rows) -> tuple:
        """Per-lane extras ``rows`` (one :meth:`_extras`-like tuple per
        lane) as the cohort executors take them: one ``(B,)`` device tensor
        per extra key (``n_active`` int32, the factors in the solver's
        dtype)."""
        out = []
        for key, col in zip(self.program.extra_keys, zip(*rows)):
            dtype = torch.int32 if key == "n_active" else self.dtype
            out.append(torch.tensor(col, dtype=dtype, device=self.device))
        return tuple(out)

    @property
    def _stepper(self):
        """The advancing executor of this binding: the software-pipelined
        one when the resolved ``pipeline`` knob says so, the serial one
        otherwise (the same contract)."""
        return self._exec.pipelined if self.pipelined else self._exec.serial

    def batched_executor(self, batch: int):
        """The cohort executor for ``batch`` stacked sessions of this
        binding (pipelined when the knob resolved so), kept per cohort
        size with the binding's other executors.  Any solver with an equal
        binding on the same mesh computes the same cohort step, which is
        what lets the serving engine step a cohort through one member's
        executor."""
        if self.pipelined:
            return self._exec.batched_pipelined(batch)
        return self._exec.batched(batch)

    def _enter(self, state: PisoState):
        """``state`` as the stepper takes it, and the function that hands a
        resulting state back in the layout ``state`` came in.  A stacked
        state passes as it is; a state in the assembly layout
        (:func:`~repro_torch.core.comm.assembly_layout`, every position on
        the solver's device, and over the solver's mesh when it has one) is
        joined into the stacked tensors, bitwise; any other layout
        raises."""
        leaves = tuple(state)
        if not any(isinstance(t, Sharded) for t in leaves):
            return state, lambda st: st
        if not all(isinstance(t, Sharded) for t in leaves):
            raise ValueError("a state is in the assembly layout in every "
                             "leaf or in none")
        mesh, home = leaves[0].mesh, canonical_device(self.device)
        for t in leaves:
            if t.mesh != mesh:
                raise ValueError("the state's leaves lie on distinct meshes")
            if any(canonical_device(sh.device) != home for sh in t.shards):
                raise ValueError(f"a state position off the solver's device "
                                 f"{home}: {t!r}")
        if self.moves is not None and mesh != self.spmd_mesh:
            raise ValueError(f"the state is laid out over {mesh!r}, the "
                             f"solver's mesh is {self.spmd_mesh!r}")
        stacked = type(state)(*(stacked_layout(t, self.device)
                                for t in leaves))
        return stacked, lambda st: type(st)(*(assembly_layout(t, mesh)
                                              for t in st))

    def step(self, state: PisoState, dt: float):
        """One timestep (one outer iteration of a steady program);
        returns ``(state, stats)``."""
        if self._distinct is not None:
            return self._distinct.call("step", state, dt)
        state, back = self._enter(state)
        state, stats = self._stepper.step(state, dt, *self._extras())
        return back(state), stats

    def run_steps(self, state: PisoState, dt: float, n_steps: int):
        """``n_steps`` timesteps; the stats fields stacked per step."""
        if self._distinct is not None:
            return self._distinct.call("run_steps", state, dt, n_steps)
        state, back = self._enter(state)
        state, stats = self._stepper.run_steps(state, dt, n_steps,
                                               *self._extras())
        return back(state), stats

    def timed_step(self, state: PisoState, dt: float):
        """One step walked phase by phase with a timestamp at each phase
        boundary (:class:`~repro_torch.fvm.step_program.
        InstrumentedExecutor`); returns ``(state, stats, PhaseBreakdown)``.

        Attribution follows the paper's two partitions: **assembly** is
        the fine-partition share (the momentum predictor with its BiCGStab
        solve, pressure assembly, the corrections), **update** the
        coefficient update into the coarse plan, **solve** the pressure CG;
        **halo** is 0 (no probe yet).  The state and stats are the ones
        :meth:`step` gives, bit for bit.  Over distinct devices the walk
        is rank 0's, and ``_distinct.last_ranks`` keeps each rank's phase
        seconds and the seconds it waited at collectives in each.
        """
        if self._distinct is not None:
            return self._distinct.call("timed", state, dt)
        state, back = self._enter(state)
        state, stats, row = self._instrumented.timed_step(state, dt,
                                                          *self._extras())
        return back(state), stats, row

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
        if self._distinct is not None:
            windows = []
            for _sample, chunk in roll_schedule(0, n_steps, None,
                                                cap=scan_steps):
                state, w = self.run_steps(state, dt, chunk)
                windows.append(w)
            return state, type(windows[0])(*(torch.cat(f)
                                             for f in zip(*windows)))
        state, back = self._enter(state)
        windows = []
        for _sample, chunk in roll_schedule(0, n_steps, None, cap=scan_steps):
            state, w = self._stepper.run_steps(state, dt, chunk,
                                               *self._extras())
            windows.append(w)
        return back(state), type(windows[0])(*(torch.cat(f)
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
        if self._distinct is not None:
            return self._distinct.call("steady", state, dt, cap)
        state, back = self._enter(state)
        state, stats, n_outer = self._exec.serial.run_converged(
            state, dt, cap, *self._extras())
        return back(state), stats, n_outer


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
