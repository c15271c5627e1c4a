"""Computational cost model (paper §2) and hardware calibration — the
port's own copy of the JAX package's ``src/repro/core/cost_model.py``.

Implements eq. (1)–(3):

    T(n)            = T_AS(n) + T_LS(n)                       (single partition)
    T(n_AS, n_LS)   = T_AS(n_AS) + T_LS(n_LS) + T_R(n_AS,n_LS) (repartitioned)

with modelled speed-up curves ``S_AS``, ``S_LS``.  The launcher uses it to
pick the repartitioning ratio alpha (``--alpha 0``), and the adaptive
controller (:mod:`repro_torch.core.controller`) calibrates it online from
measured per-phase times.

Speed-up laws: assembly follows Amdahl with a cache bonus (the paper cites
superlinear effects at 10k–30k DOFs/core [Galeazzo et al.]); the solver
follows a DOFs-per-device roofline: ~constant rate above ``dofs_sat`` per
device (paper fig. 4: >1M DOFs/GPU), degrading below.

Two machines ship: :data:`HOREKA_A100`, the paper's A100 cluster
calibrated from the paper's figures, and :data:`H100`, this port's card,
each field measured on it (``chip_smoke.py`` phase 12b).
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

from repro_torch.solvers.precision import get_policy

__all__ = [
    "HardwareSpec", "CostModel", "PhaseBreakdown", "HOREKA_A100", "H100",
]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-device peaks + interconnect."""

    name: str
    peak_flops: float          # FLOP/s per device (bf16/fp32 as relevant)
    hbm_bw: float              # B/s per device
    link_bw: float             # B/s per link (the coefficient update's transport)
    host_flops: float          # FLOP/s per host core (assembly side)
    host_bw: float             # B/s host memory per core group
    h2d_bw: float              # B/s host→device staging (non-direct path)
    dofs_sat: float            # DOFs/device for full solver efficiency
    oversub_penalty: float     # slowdown factor per extra rank sharing a device
    # per-message latency of the grouped coefficient update: each coarse part
    # receives one buffer per fused fine part, so the update pays
    # ``msg_latency * alpha`` on top of the bandwidth term.  This is what makes
    # the optimal alpha an *interior* point (more fine parts: faster assembly
    # but a costlier update) — paper fig. 5/6's phi growth with alpha.
    msg_latency: float = 5e-6


HOREKA_A100 = HardwareSpec(
    name="horeka_a100",
    peak_flops=19.5e12, hbm_bw=1555e9, link_bw=25e9,
    host_flops=3e9 * 4, host_bw=20e9, h2d_bw=12e9,
    dofs_sat=1e6,
    # calibrated from paper fig. 7: GPUOSR1 degrades up to ~140x at 16 ranks/GPU
    oversub_penalty=9.3,
)

# One NVIDIA H100 running the whole stacked system, every field read on it
# by ``chip_smoke.py`` phase 12b at the 210^3 cavity (30 fine parts, the
# 3-step state, f64, the kernels) unless marked: measured, fitted (the
# model solved for the field from a measured time) or bounded.  In the
# port every fine part is assembled on the card and every coarse part
# solved on it, so:
#   hbm_bw       the f64 DIA SpMV kernel alone at the pressure shape, bytes
#                (bands, x, y once each) over seconds;
#   link_bw      the on-card rate of one pressure value update (the
#                model's (nnz + 1) * n_dofs * 8 bytes over the intercept
#                of a least-squares line of its seconds against alpha);
#   msg_latency  that line's slope: seconds per fused fine buffer (the
#                card moves the same bytes at every alpha, so the slope is
#                small and only bounded from above);
#   host_bw      fitted: the card's assembly seconds per dof (the step's
#                assembly phase, which bills the momentum predictor and its
#                BiCGStab solve too) spread as the model spreads it over
#                the 30 fine parts: t_assembly(30) equals the measurement;
#   host_flops   fitted: host_bw * 250 / 200 (the model's flops and bytes
#                per dof), so neither assembly term dominates the other;
#   dofs_sat     an upper bound: the ms per pressure-CG iteration is
#                flat in the rows per coarse part over alpha 1..30, so
#                the knee lies at or below the smallest parts, 308,700
#                rows (the sweep reaches no smaller parts);
#   h2d_bw       a pinned 256 MB host-to-device copy;
#   peak_flops   f64 outside the tensor cores, NVIDIA's data sheet (not
#                measured; no method of the model reads it);
#   oversub_penalty  0: one process drives the card (no rank contention).
H100 = HardwareSpec(
    name="h100",
    peak_flops=34e12,        # data sheet, SXM part (not measured)
    hbm_bw=3.06e12,          # NVIDIA H100 80GB HBM3, 700.00 W
    link_bw=4.49e11,         # NVIDIA H100 80GB HBM3, 700.00 W
    host_flops=2.01e8,       # NVIDIA H100 80GB HBM3, 700.00 W
    host_bw=1.61e8,          # NVIDIA H100 80GB HBM3, 700.00 W
    h2d_bw=5.45e10,          # NVIDIA H100 80GB HBM3, 700.00 W
    dofs_sat=3.1e5,          # NVIDIA H100 80GB HBM3, 700.00 W
    oversub_penalty=0.0,
    # the slope is not resolved (4.7 +- 3.4 us per alpha): an upper bound
    # of 11 us, the point estimate shipped; NVIDIA H100 80GB HBM3, 700.00 W
    msg_latency=4.7e-6,
)


@dataclasses.dataclass(frozen=True)
class PhaseBreakdown:
    """Per-phase time of one outer iteration (seconds).

    The four instrumented buckets of a segregated step: host-side matrix
    **assembly**, the repartitioning coefficient **update** (paper fig.
    3b), the **halo** exchange of the solve, and the Krylov **solve**.
    ``overlapped`` is provenance, not a time: True marks a breakdown taken
    from overlapping phases, which must not calibrate a serial model (the
    controller's ``observe`` skips calibration for such samples); the
    instrumented walk is serial and emits False.
    """

    TIME_FIELDS: ClassVar[tuple] = ("assembly", "update", "halo", "solve")

    assembly: float
    update: float
    halo: float
    solve: float
    overlapped: bool = False

    @property
    def total(self) -> float:
        return self.assembly + self.update + self.halo + self.solve

    @property
    def imbalance(self) -> float:
        """CPU-side over GPU-side share, the controller's balance signal:
        1.0 when assembly exactly hides behind the accelerator phases, >1
        undersubscribed assembly (raise alpha), <1 oversubscribed."""
        gpu_side = self.solve + self.halo + self.update
        return self.assembly / max(gpu_side, 1e-30)


@dataclasses.dataclass
class CostModel:
    """Paper §2 model for one linear system of ``n_dofs`` unknowns.

    ``assembly_flops_per_dof`` / ``solver_flops_per_dof`` are per outer
    iteration; ``solver_iters`` the Krylov iteration count; ``nnz_per_row``
    the matrix stencil (7 for the cavity).

    The ``*_scale`` fields are multiplicative calibration factors
    (measured-over-modelled time ratios) fitted online by the adaptive
    controller (:mod:`repro_torch.core.controller`); 1.0 means "trust the
    machine constants".
    """

    hw: HardwareSpec
    n_dofs: float
    # calibrated against the paper's fig. 5/6 (phi → 15–30 at large alpha x
    # nodes) and fig. 8 (max speed-up ~10x): lidDrivenCavity spends the
    # majority of its time in the linear solver
    assembly_flops_per_dof: float = 250.0
    assembly_bytes_per_dof: float = 200.0
    solver_iters: int = 120
    nnz_per_row: int = 7
    bytes_per_val: int = 8
    # online-calibrated machine-constant corrections (controller-owned)
    assembly_scale: float = 1.0
    solve_scale: float = 1.0
    comm_scale: float = 1.0
    # Krylov-iteration fusion: the fused backend streams the bands and each
    # vector once per iteration — the reference op sequence re-reads
    # vectors across the SpMV, three dots, three axpys and the Jacobi
    # divide.  ``vector_passes`` is the model's per-iteration
    # vector-traffic normalization; the fused value is the reference's
    # scaled by the dataflow ratio (~20 -> 13 full-vector transits).
    fused_solver: bool = False
    vector_passes: float = 8.0
    vector_passes_fused: float = 5.0
    # Mixed-precision Krylov policy (repro_torch.solvers.precision): the
    # inner sweeps stream bands + vectors at the policy's *storage* width
    # (f32_ir: 4 B, bf16_ir: 2 B), plus ``refine_outers`` f64
    # residual-replay passes (one full-width SpMV + correction axpy each).
    # Under the default "f64" policy the bytes expression is the plain
    # one.  ``solver_iters`` counts *inner* iterations for refined
    # policies.
    precision: str = "f64"
    refine_outers: int = 4
    # Host launch overhead per *dispatched* step.  A window of n timesteps
    # dispatched as one retires it n-fold.  The four PhaseBreakdown phases
    # exclude it (it is a host constant, not a partition cost — folding it
    # into a phase would bias the online calibration's measured-over-
    # modelled ratios); use t_dispatch / T_step for whole-step projections.
    dispatch_latency: float = 50e-6

    def t_dispatch(self, steps_per_dispatch: int = 1) -> float:
        """Per-timestep host dispatch overhead, amortized over the
        window (``steps_per_dispatch = 1`` is the per-step stepper)."""
        return self.dispatch_latency / max(int(steps_per_dispatch), 1)

    # ---- speed-up laws (paper §2: S_AS, S_LS) -------------------------------
    def t_assembly(self, n_ranks: int) -> float:
        """Host-side assembly time; bandwidth-bound with Amdahl serial 0.1%."""
        serial = 0.001
        per_rank = self.n_dofs / n_ranks
        t_bw = self.assembly_bytes_per_dof * per_rank / self.hw.host_bw
        t_fl = self.assembly_flops_per_dof * per_rank / self.hw.host_flops
        t1 = self.assembly_bytes_per_dof * self.n_dofs / self.hw.host_bw
        return self.assembly_scale * (serial * t1 + max(t_bw, t_fl))

    def solver_flops(self) -> float:
        # CG: SpMV (2*nnz) + 5 axpy/dot-like ops (2 flops/dof) per iteration
        per_iter = 2 * self.nnz_per_row * self.n_dofs + 10 * self.n_dofs
        return per_iter * self.solver_iters

    def solver_bytes(self) -> float:
        vec = (self.vector_passes_fused if self.fused_solver
               else self.vector_passes)
        if self.precision == "f64":
            per_iter = (self.nnz_per_row + vec) * self.n_dofs \
                * self.bytes_per_val
            return per_iter * self.solver_iters
        # refined policy: inner sweeps at the storage width, plus
        # refine_outers full-width replay passes (bands + x read, r
        # written, correction axpy: ~nnz + 3 vector transits each)
        pol = get_policy(self.precision)
        inner = (self.nnz_per_row + vec) * self.n_dofs \
            * pol.storage_itemsize * self.solver_iters
        outer = (self.nnz_per_row + 3) * self.n_dofs * self.bytes_per_val \
            * self.refine_outers
        return inner + outer

    def t_solve_core(self, n_dev: int, ranks_per_dev: int = 1) -> float:
        """Device solve sans halo; memory-bound SpMV with DOFs/device knee."""
        dofs_per_dev = self.n_dofs / n_dev
        eff = min(1.0, dofs_per_dev / self.hw.dofs_sat) ** 0.5
        t = self.solver_bytes() / (n_dev * self.hw.hbm_bw * eff)
        if ranks_per_dev > 1 and self.hw.oversub_penalty > 0:
            t *= 1.0 + self.hw.oversub_penalty * (ranks_per_dev - 1)
        return self.solve_scale * t

    def t_halo(self, n_dev: int) -> float:
        """Per-solve halo traffic: one plane per neighbour per iteration."""
        plane = (self.n_dofs / n_dev) ** (2 / 3)
        t = 2 * plane * self.bytes_per_val * self.solver_iters / self.hw.link_bw
        return self.comm_scale * t

    def t_solver(self, n_dev: int, ranks_per_dev: int = 1) -> float:
        """Device solve; memory-bound SpMV with DOFs/device efficiency knee."""
        return self.t_solve_core(n_dev, ranks_per_dev) + self.t_halo(n_dev)

    def t_solver_cpu(self, n_ranks: int) -> float:
        """Unaccelerated reference: PCG on the host ranks (paper's 'CPU').

        Bandwidth-bound with the superlinear cache window at 10k–30k
        DOFs/core [Galeazzo et al. 2024] and a per-iteration allreduce
        latency term that erodes scaling at small DOFs/core.
        """
        dofs_per_core = self.n_dofs / n_ranks
        eff = 1.3 if 1e4 <= dofs_per_core <= 3e4 else 1.0
        bw_per_core = self.hw.host_bw / 8.0
        # the CPU baseline never runs the fused kernels or a mixed-
        # precision policy: always the reference full-width pass count
        cpu_bytes = dataclasses.replace(self, fused_solver=False,
                                        precision="f64").solver_bytes()
        t = cpu_bytes / (n_ranks * bw_per_core * eff)
        t += 5e-6 * math.log2(max(n_ranks, 2)) * self.solver_iters
        return t

    def t_repartition(self, n_as: int, n_ls: int, device_direct: bool = True
                      ) -> float:
        """T_R: ship all LDU coefficients fine→coarse once per assembly.

        Bandwidth term plus ``msg_latency * alpha`` per coarse part — one
        message per fused fine buffer (paper fig. 5/6: the update share phi
        grows with alpha), which bounds how far raising alpha can pay off.
        """
        bytes_total = (self.nnz_per_row + 1) * self.n_dofs * self.bytes_per_val
        bw = self.hw.link_bw if device_direct else self.hw.h2d_bw
        t = bytes_total / (n_ls * bw)
        if not device_direct:
            t *= 2.0  # two-hop host-buffer staging (paper fig. 9)
        t += self.hw.msg_latency * (n_as / max(n_ls, 1))
        return self.comm_scale * t

    # ---- paper equations ----------------------------------------------------
    def T_single(self, n: int, n_dev: int) -> float:
        """Eq. (1)/(2): one partition of n ranks on n_dev devices."""
        return self.t_assembly(n) + self.t_solver(
            n_dev, ranks_per_dev=max(1, math.ceil(n / n_dev)))

    def T_repartitioned(self, n_as: int, n_ls: int,
                        device_direct: bool = True) -> float:
        """Eq. (3): independent partitions + repartition cost."""
        return (self.t_assembly(n_as) + self.t_solver(n_ls)
                + self.t_repartition(n_as, n_ls, device_direct))

    def T_step(self, n_as: int, n_ls: int, device_direct: bool = True,
               steps_per_dispatch: int = 1) -> float:
        """Whole-timestep wall projection: eq. (3) plus the amortized host
        dispatch overhead.  Constant across alpha, so it never changes the
        argmin."""
        return (self.T_repartitioned(n_as, n_ls, device_direct)
                + self.t_dispatch(steps_per_dispatch))

    def T_pipelined(self, n_as: int, n_ls: int,
                    device_direct: bool = True) -> float:
        """Eq. (3) under software pipelining: assembly hides behind the
        solve (or vice versa), so the serial ``t_assembly + t_solver`` sum
        collapses to a ``max``, while the coefficient update stays serial:
        it both consumes the freshly assembled coefficients and gates the
        next solve."""
        return (max(self.t_assembly(n_as), self.t_solver(n_ls))
                + self.t_repartition(n_as, n_ls, device_direct))

    def T_step_pipelined(self, n_as: int, n_ls: int,
                         device_direct: bool = True,
                         steps_per_dispatch: int = 1) -> float:
        """Pipelined whole-timestep wall projection:
        ``max(t_assembly, t_solver) + t_update + t_dispatch``."""
        return (self.T_pipelined(n_as, n_ls, device_direct)
                + self.t_dispatch(steps_per_dispatch))

    def optimal_alpha(self, n_cpu: int, n_gpu: int,
                      candidates=(1, 2, 4, 8, 16, 32),
                      pipelined: bool = False) -> int:
        """Best repartitioning ratio: fine parts = n_gpu * alpha ranks.

        The paper's parametrization (``n_as = n_gpu * alpha <= n_cpu``):
        the pick need not divide ``n_cpu``.  ``pipelined`` scores
        candidates with the overlap objective :meth:`T_pipelined` instead
        of the serial sum."""
        best, best_t = 1, float("inf")
        objective = self.T_pipelined if pipelined else self.T_repartitioned
        for a in candidates:
            n_as = n_gpu * a
            if n_as > n_cpu:
                break
            t = objective(n_as, n_gpu)
            if t < best_t:
                best, best_t = a, t
        return best

    # ---- controller API (calibration + inverse model) -----------------------
    def predict_phases(self, n_as: int, n_ls: int,
                       device_direct: bool = True) -> PhaseBreakdown:
        """Eq. (3) split into the controller's four instrumented phases."""
        return PhaseBreakdown(
            assembly=self.t_assembly(n_as),
            update=self.t_repartition(n_as, n_ls, device_direct),
            halo=self.t_halo(n_ls),
            solve=self.t_solve_core(n_ls),
        )

    def with_fused_solver(self, fused: bool = True) -> "CostModel":
        """A copy with the fused-iteration bytes/iter term toggled."""
        return dataclasses.replace(self, fused_solver=fused)

    def with_precision(self, precision: str,
                       refine_outers: int | None = None) -> "CostModel":
        """A copy priced under a named precision policy.

        ``refine_outers`` overrides the modelled outer-refinement count;
        ``None`` keeps the current one.  Raises on an unknown policy name.
        """
        get_policy(precision)
        return dataclasses.replace(
            self, precision=precision,
            refine_outers=(self.refine_outers if refine_outers is None
                           else refine_outers))

    def with_scales(self, assembly: float | None = None,
                    solve: float | None = None,
                    comm: float | None = None) -> "CostModel":
        """A copy with replaced calibration factors (None keeps current)."""
        return dataclasses.replace(
            self,
            assembly_scale=self.assembly_scale if assembly is None else assembly,
            solve_scale=self.solve_scale if solve is None else solve,
            comm_scale=self.comm_scale if comm is None else comm,
        )

    def scales_from_measurement(self, measured: PhaseBreakdown, n_as: int,
                                n_ls: int, device_direct: bool = True
                                ) -> tuple[float, float, float]:
        """Raw measured-over-modelled ratios (assembly, solve, comm).

        The *base* prediction (scales forced to 1) is the reference, so the
        returned ratios are absolute machine-constant corrections rather than
        increments on the current calibration — the controller EMA-smooths
        them in log space (:class:`repro_torch.core.controller.
        OnlineCalibration`).
        """
        base = self.with_scales(1.0, 1.0, 1.0).predict_phases(
            n_as, n_ls, device_direct)
        comm_meas = measured.update + measured.halo
        comm_base = base.update + base.halo
        eps = 1e-30
        return (max(measured.assembly, eps) / max(base.assembly, eps),
                max(measured.solve, eps) / max(base.solve, eps),
                max(comm_meas, eps) / max(comm_base, eps))

    def alpha_star(self, n_cpu: int, n_gpu: int) -> float:
        """Continuous inverse model: the alpha balancing assembly vs update.

        With the bandwidth-bound assembly term ``C_a / alpha`` and the
        latency term ``lat * alpha`` of the update, the unconstrained
        optimum is ``alpha* = sqrt(C_a / lat)``; clamped to the feasible
        range ``[1, n_cpu / n_gpu]``.
        """
        per_dof = max(
            self.assembly_bytes_per_dof / self.hw.host_bw,
            self.assembly_flops_per_dof / self.hw.host_flops)
        c_a = self.assembly_scale * per_dof * self.n_dofs / n_gpu
        lat = self.comm_scale * self.hw.msg_latency
        a = math.sqrt(c_a / max(lat, 1e-30))
        return min(max(a, 1.0), n_cpu / n_gpu)
