"""Adaptive repartitioning controller — the port's own copy of the JAX
package's ``src/repro/core/controller.py``.

The paper (§2) picks the fusion factor alpha *once*, from a cost model with
machine constants.  That leaves two gaps this module closes:

1. **Model error** — real assembly/solve/update rates differ from the
   constants (and drift: turbulence models switch on, meshes refine,
   co-tenants appear).  :class:`OnlineCalibration` fits multiplicative
   corrections to the model's machine constants from measured per-phase
   times, EMA-smoothed in log space.
2. **Re-planning cost** — re-selecting alpha means building a new
   :class:`~repro_torch.core.repartition.RepartitionPlan` (symbolic
   fusion, gather indices).  :class:`PlanCache` amortizes it: an LRU keyed
   by ``(mesh fingerprint, alpha, target)`` reuses the symbolic plan, and
   a shared :class:`~repro_torch.core.update.UpdaterPool` reuses the
   update's output buffer across plans of equal shape.

:class:`RepartitionController` ties them together as a feedback loop around
the PISO pressure solve (``SegregatedSolver.timed_step`` produces the
per-phase :class:`~repro_torch.core.cost_model.PhaseBreakdown` samples):

.. code-block:: text

      measure phases ──> calibrate model ──> argmin_alpha T(alpha)
            ^                                     │ (hysteresis: switch only
            │                                     │  on persistent, material
      apply plan  <── PlanCache lookup  <─────────┘  predicted gain)

Switching is guarded by **hysteresis** so measurement noise cannot thrash
plans: a candidate alpha must (a) be predicted to beat the incumbent by at
least ``config.hysteresis`` relative margin, (b) win ``config.patience``
observations in a row, and (c) not arrive within ``config.min_dwell`` steps
of the previous switch.
"""
from __future__ import annotations

import collections
import dataclasses
import math

from repro_torch.core.cost_model import CostModel, PhaseBreakdown
from repro_torch.core.repartition import (RepartitionPlan, build_plan,
                                          layout_fingerprint,
                                          mesh_fingerprint, plan_for_mesh)
from repro_torch.core.update import UpdaterPool
from repro_torch.solvers.ops import BACKENDS
from repro_torch.solvers.precision import get_policy

__all__ = [
    "OnlineCalibration",
    "PlanCache",
    "ControllerConfig",
    "SwitchEvent",
    "RepartitionController",
]


# ---------------------------------------------------------------------------
# Online calibration
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OnlineCalibration:
    """Log-space EMA fit of the cost model's machine-constant corrections.

    Each observation yields raw measured-over-modelled ratios per phase
    group (assembly / solve / comm).  Ratios are multiplicative and noise is
    roughly multiplicative too, so the EMA runs on ``log`` ratios: the
    estimate is a geometric moving average, immune to the bias an arithmetic
    mean of ratios picks up from outliers.

    ``decay`` is the weight of history: 0 trusts only the latest sample,
    →1 freezes the fit.  The default 0.6 reaches ~95% of a step change in
    about 6 observations while averaging ±20% noise down to a few percent.
    """

    decay: float = 0.6
    _log_scales: list[float] = dataclasses.field(
        default_factory=lambda: [0.0, 0.0, 0.0])
    n_obs: int = 0

    def observe(self, model: CostModel, measured: PhaseBreakdown,
                n_as: int, n_ls: int, device_direct: bool = True) -> None:
        raw = model.scales_from_measurement(measured, n_as, n_ls,
                                            device_direct)
        # first observation seeds the fit exactly; later ones blend
        w = self.decay if self.n_obs else 0.0
        self._log_scales = [
            w * s + (1.0 - w) * math.log(max(r, 1e-30))
            for s, r in zip(self._log_scales, raw)
        ]
        self.n_obs += 1

    @property
    def scales(self) -> tuple[float, float, float]:
        """(assembly, solve, comm) multiplicative corrections."""
        return tuple(math.exp(s) for s in self._log_scales)

    def apply(self, model: CostModel) -> CostModel:
        a, s, c = self.scales
        return model.with_scales(assembly=a, solve=s, comm=c)


# ---------------------------------------------------------------------------
# Plan cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _CacheEntry:
    plan: RepartitionPlan
    updaters: dict = dataclasses.field(default_factory=dict)


class PlanCache:
    """LRU cache of repartition plans keyed by ``(fingerprint, alpha, target)``.

    Building a plan is symbolic numpy work that scales with nnz.  Revisiting
    an alpha (the common case for an adapting controller oscillating
    between neighbours) must not pay it again.  The cache is safe to share
    across solvers: plans are immutable, and the fingerprint covers the
    full sparsity structure, so equal keys imply interchangeable plans.

    ``updaters`` memoizes plan-bound update callables per (target,
    schedule); the shared :class:`UpdaterPool` additionally shares one
    output buffer across different plans of equal shape.
    """

    def __init__(self, capacity: int = 16, pool: UpdaterPool | None = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.pool = UpdaterPool() if pool is None else pool
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    # -- plan lookup ------------------------------------------------------
    @staticmethod
    def _key(fingerprint: str, alpha: int, target: str, mode: str,
             backend: str = "auto", precision: str = "f64"):
        """Cache key.  ``mode`` is the solve layout ("stacked" |
        "full_mesh"), ``backend`` the Krylov per-iteration backend
        ("auto" | "fused" | "reference", :mod:`repro_torch.solvers.ops`)
        and ``precision`` the mixed-precision policy name
        (:mod:`repro_torch.solvers.precision`): all are separate key
        *components*, never folded into the target string — ``target``
        also dispatches the DIA-vs-ELL source arrays in
        :class:`UpdaterPool` and must stay a clean target name.  The
        stacked/auto/f64 key keeps its 3-tuple shape; the optional
        components cannot collide (disjoint value sets)."""
        key = (fingerprint, alpha, target)
        if mode != "stacked":
            key += (mode,)
        if backend != "auto":
            key += (backend,)
        if precision != "f64":
            key += (precision,)
        return key

    def plan_for_mesh(self, mesh, alpha: int, target: str = "dia",
                      mode: str = "stacked", backend: str = "auto",
                      precision: str = "f64") -> RepartitionPlan:
        return self.get(mesh_fingerprint(mesh), alpha, target,
                        lambda: plan_for_mesh(mesh, alpha), mode=mode,
                        backend=backend, precision=precision)

    def plan_for_layout(self, layout, alpha: int, *, nx=None, plane=None,
                        target: str = "dia", mode: str = "stacked",
                        backend: str = "auto",
                        precision: str = "f64") -> RepartitionPlan:
        return self.get(layout_fingerprint(layout), alpha, target,
                        lambda: build_plan(layout, alpha, nx=nx, plane=plane),
                        mode=mode, backend=backend, precision=precision)

    def get(self, fingerprint: str, alpha: int, target: str,
            builder, mode: str = "stacked", backend: str = "auto",
            precision: str = "f64") -> RepartitionPlan:
        """Return the cached plan for the key, building via ``builder`` on miss."""
        key = self._key(fingerprint, alpha, target, mode, backend, precision)
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            self._entries.move_to_end(key)
            return entry.plan
        self.misses += 1
        plan = builder()
        self._entries[key] = _CacheEntry(plan=plan)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
        return plan

    # -- update reuse -----------------------------------------------------
    def updater(self, fingerprint: str, alpha: int, target: str = "dia",
                schedule: str = "device_direct", mode: str = "stacked",
                backend: str = "auto", precision: str = "f64"):
        """Plan-bound ``buffers -> values`` callable (memoized per entry)."""
        key = self._key(fingerprint, alpha, target, mode, backend, precision)
        entry = self._entries.get(key)
        if entry is None:
            raise KeyError(
                f"no cached plan for {key}: it was evicted or never built — "
                "fetch it first via plan_for_mesh/plan_for_layout/get")
        self._entries.move_to_end(key)  # an updater access is a use
        ukey = (target, schedule)
        fn = entry.updaters.get(ukey)
        if fn is None:
            fn = entry.updaters[ukey] = self.pool.updater(
                entry.plan, target, schedule)
        return fn

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "pool_hits": self.pool.hits,
            "pool_misses": self.pool.misses,
        }

    def reset_stats(self) -> None:
        """Zero the hit/miss/eviction meters without dropping any cached
        plan or pooled update — accounting only."""
        self.hits = self.misses = self.evictions = 0
        self.pool.hits = self.pool.misses = 0


# ---------------------------------------------------------------------------
# Controller
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Adaptation policy knobs (see module doc for the switching rule).

    ``sample_every`` is the instrumentation cadence: the adaptive launcher
    (:func:`repro_torch.launch.case.run_adaptive`) takes a per-phase
    instrumented sample — one ``SegregatedSolver.timed_step`` — only every
    ``sample_every``-th timestep and advances the steps in between in
    windows.  The controller itself only ever sees the sampled
    subsequence, so ``warmup``, ``patience`` and ``min_dwell`` all count
    *sampled observations*, not raw timesteps.
    """

    alphas: tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    hysteresis: float = 0.10   # min relative predicted gain to switch
    patience: int = 3          # consecutive wins a challenger needs
    min_dwell: int = 5         # sampled steps between switches (cool-down)
    ema_decay: float = 0.6     # calibration memory (OnlineCalibration.decay)
    warmup: int = 2            # sampled observations before adapting at all
    device_direct: bool = True
    sample_every: int = 4      # timesteps per instrumented sample (>= 1)


@dataclasses.dataclass
class SwitchEvent:
    step: int
    old_alpha: int
    new_alpha: int
    predicted_gain: float      # relative predicted improvement


class RepartitionController:
    """Feedback-driven alpha selection with hysteresis and plan caching.

    One controller instance governs one simulation; the :class:`PlanCache`
    may be shared freely across controllers.
    """

    def __init__(self, model: CostModel, n_cpu: int, n_gpu: int,
                 alpha0: int | None = None,
                 config: ControllerConfig | None = None,
                 cache: PlanCache | None = None,
                 fixed_fine: bool = False,
                 solve_mode: str = "stacked",
                 solver_backend: str = "auto",
                 pipelined: bool = False,
                 precision: str = "f64"):
        """``fixed_fine`` selects the partition parametrization:

        * ``False`` (paper §2): the solve side is pinned to ``n_gpu``
          devices and alpha recruits assembly ranks, ``n_as = alpha*n_gpu``.
        * ``True``: the fine part count ``n_cpu`` is fixed and alpha
          *fuses*, ``n_ls = n_cpu / alpha`` — fewer, denser solve parts,
          each priced as a device of its own.

        ``solve_mode`` ("stacked" or "full_mesh") and ``solver_backend``
        ("auto" | "fused" | "reference", :mod:`repro_torch.solvers.ops`)
        become part of the plan-cache key.  An explicit ``"fused"`` request
        also flips the cost model's fused-iteration bytes/iter term
        (:meth:`CostModel.with_fused_solver`); ``"auto"`` leaves a
        caller-supplied model untouched (which backend auto resolves to
        depends on the part size, so on alpha) — the launcher resolves it
        at the fine part size itself.

        ``pipelined`` scores candidates with the overlap objective
        ``max(assembly, solve + halo) + update`` instead of the serial sum
        (the launcher and the serving engine pass what the solver's
        ``pipeline`` knob resolved to).  ``precision`` names the session's
        mixed-precision policy; it becomes a plan-cache key component and,
        when not "f64", re-prices the model's bytes/iter term
        (:meth:`CostModel.with_precision`).
        """
        if solve_mode not in ("stacked", "full_mesh"):
            raise ValueError(f"unknown solve_mode {solve_mode!r}")
        # per-instance default: a ControllerConfig() *instance* default
        # argument would be one shared object across every controller
        config = ControllerConfig() if config is None else config
        if config.sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        if solver_backend not in BACKENDS:
            raise ValueError(f"unknown solver_backend {solver_backend!r}")
        get_policy(precision)
        if solver_backend == "fused" and not model.fused_solver:
            model = model.with_fused_solver(True)
        if precision != "f64" and model.precision == "f64":
            model = model.with_precision(precision)
        self.base_model = model
        self.precision = precision
        self.n_cpu = n_cpu
        self.n_gpu = n_gpu
        self.fixed_fine = fixed_fine
        self.solve_mode = solve_mode
        self.solver_backend = solver_backend
        self.pipelined = pipelined
        self.config = config
        # explicit None test: an empty PlanCache is falsy (it has __len__)
        self.cache = PlanCache() if cache is None else cache
        self.calibration = OnlineCalibration(decay=config.ema_decay)
        self.step_count = 0
        self.last_switch_step = 0
        self.switches: list[SwitchEvent] = []
        self.history: list[PhaseBreakdown] = []
        self._challenger: int | None = None
        self._challenger_wins = 0
        self.alpha = alpha0 if alpha0 is not None else self.recommend()

    # -- model views ------------------------------------------------------
    @property
    def model(self) -> CostModel:
        """The cost model with the current online calibration applied."""
        return self.calibration.apply(self.base_model)

    def partition_counts(self, alpha: int) -> tuple[int, int]:
        """(n_as, n_ls) realized by ``alpha`` under the parametrization."""
        if self.fixed_fine:
            return self.n_cpu, max(self.n_cpu // alpha, 1)
        return self.n_gpu * alpha, self.n_gpu

    def feasible_alphas(self) -> tuple[int, ...]:
        if self.fixed_fine:
            return tuple(a for a in self.config.alphas
                         if a <= self.n_cpu and self.n_cpu % a == 0)
        return tuple(a for a in self.config.alphas
                     if self.n_gpu * a <= self.n_cpu)

    def predicted_phases(self, alpha: int | None = None) -> PhaseBreakdown:
        a = self.alpha if alpha is None else alpha
        n_as, n_ls = self.partition_counts(a)
        return self.model.predict_phases(n_as, n_ls,
                                         self.config.device_direct)

    def predicted_total(self, alpha: int | None = None) -> float:
        """The per-step objective alpha selection minimizes.

        Serial sessions pay the sum of the four phases; pipelined ones
        pay ``max(assembly, solve + halo) + update`` (``solve + halo`` IS
        the model's ``t_solver``; :meth:`CostModel.T_pipelined`)."""
        ph = self.predicted_phases(alpha)
        if self.pipelined:
            return max(ph.assembly, ph.solve + ph.halo) + ph.update
        return ph.total

    def recommend(self) -> int:
        """Unfiltered argmin over feasible alphas on the calibrated model."""
        return min(self.feasible_alphas(), key=self.predicted_total)

    # -- the feedback step ------------------------------------------------
    def observe(self, measured: PhaseBreakdown) -> None:
        """Fold one measured per-phase sample into the calibration.

        A sample with ``overlapped=True`` (phase walls that hide behind
        each other) must never calibrate the serial per-phase model — it
        is recorded in the history but skipped by the calibration.  The
        instrumented executor is serial and emits ``overlapped=False``.
        """
        if not getattr(measured, "overlapped", False):
            n_as, n_ls = self.partition_counts(self.alpha)
            self.calibration.observe(
                self.base_model, measured, n_as, n_ls,
                self.config.device_direct)
        self.history.append(measured)

    def step(self, measured: PhaseBreakdown) -> int:
        """Observe one sample, maybe switch alpha; returns the alpha to use.

        A switch happens only when the hysteresis conditions hold (module
        doc) — noisy measurements around a near-tie must not thrash plans.
        """
        self.observe(measured)
        self.step_count += 1
        cfg = self.config
        if self.calibration.n_obs < cfg.warmup:
            return self.alpha
        if self.step_count - self.last_switch_step < cfg.min_dwell:
            # cool-down: a fresh plan's transients would pollute the fit
            self._challenger, self._challenger_wins = None, 0
            return self.alpha

        best = self.recommend()
        if best == self.alpha:
            self._challenger, self._challenger_wins = None, 0
            return self.alpha

        t_now = self.predicted_total(self.alpha)
        t_best = self.predicted_total(best)
        gain = (t_now - t_best) / max(t_now, 1e-30)
        if gain < cfg.hysteresis:
            self._challenger, self._challenger_wins = None, 0
            return self.alpha

        if best == self._challenger:
            self._challenger_wins += 1
        else:
            self._challenger, self._challenger_wins = best, 1
        if self._challenger_wins < cfg.patience:
            return self.alpha

        self.switches.append(SwitchEvent(
            step=self.step_count, old_alpha=self.alpha, new_alpha=best,
            predicted_gain=gain))
        self.alpha = best
        self.last_switch_step = self.step_count
        self._challenger, self._challenger_wins = None, 0
        return self.alpha

    # -- plan access ------------------------------------------------------
    def plan(self, mesh, target: str = "dia") -> RepartitionPlan:
        """The current alpha's plan for ``mesh``, through the cache (the
        solve mode, backend and policy as key components)."""
        return self.cache.plan_for_mesh(mesh, self.alpha, target,
                                        mode=self.solve_mode,
                                        backend=self.solver_backend,
                                        precision=self.precision)

    def stats(self) -> dict:
        a, s, c = self.calibration.scales
        return {
            "alpha": self.alpha,
            "solve_mode": self.solve_mode,
            "solver_backend": self.solver_backend,
            "precision": self.precision,
            "pipelined": self.pipelined,
            "steps": self.step_count,
            "switches": [dataclasses.asdict(e) for e in self.switches],
            "scales": {"assembly": a, "solve": s, "comm": c},
            "cache": self.cache.stats(),
        }
