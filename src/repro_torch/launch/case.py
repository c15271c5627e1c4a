"""CFD launcher: any registered flow case under any registered program.

  python -m repro_torch.launch.case --n 210 --parts 30 --alpha 30 --steps 3
  python -m repro_torch.launch.case --program simple --case channel --n 8
  python -m repro_torch.launch.case --n 8 --parts 4 --adaptive --steps 6 \
      --device cpu

Builds ``CavityMesh.cube(n, parts)`` and the solver of ``--program`` (its
repartition plans are built once, on the host, and timed apart from the
steps).  A transient program (PISO) advances ``--steps`` timesteps of
``dt = co * h`` in windows of at most ``--scan-steps`` steps
(``roll_schedule``), printing one line per step; a steady program (SIMPLE)
iterates to its convergence predicate, capped at ``--max-outer`` outer
iterations, and prints the verdict and the last residuals.

``--alpha 0`` lets the cost model pick the ratio
(``CostModel(H100, n_dofs=n^3).optimal_alpha``, the paper's
parametrization: the pick need not divide ``--parts``, and the solver then
refuses it).  ``--adaptive`` (transient programs) closes the loop
(:func:`run_adaptive`): every ``--sample-every``-th step is an
instrumented sample (``timed_step``) that feeds the repartitioning
controller, which recalibrates the cost model online and rebinds alpha
when the predicted gain clears ``--hysteresis``; plans come from one
shared plan cache.  ``--pipeline`` (``auto``, as in the JAX launcher)
steps a program that declares a pipelined form (PISO) through the
software-pipelined executor (``on`` demands it, ``off`` steps serially);
the controller scores alphas with the matching objective.
``--solve-mode full_mesh`` solves the pressure system over ``--parts`` row
shards, one per fine part, on ``--mesh-devices`` (a comma list, repeats
allowed: ``cuda:0`` thirty times puts 30 shards on one card; default: the
visible devices, and too few raise).  ``--device`` defaults to ``cuda``;
``--device cpu`` runs the same path on the CPU.
``python -m repro_torch.launch.cavity`` is the same launcher.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.comm import make_cfd_mesh
from repro_torch.core.controller import (ControllerConfig, PlanCache,
                                         RepartitionController)
from repro_torch.core.cost_model import H100, CostModel
from repro_torch.fvm.cases import case_names, get_case
from repro_torch.fvm.mesh import CavityMesh
from repro_torch.fvm.piso import (SOLVERS, PisoState, SegregatedSolver,
                                  StepStats, make_solver)
from repro_torch.fvm.step_program import get_program, roll_schedule
from repro_torch.solvers.ops import resolve_backend

__all__ = ["build_parser", "build_solver", "cost_model", "pipelined",
           "run_transient", "run_adaptive", "run_steady", "main"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default="cavity", choices=case_names(),
                    help="flow case (BC set) from the case registry")
    ap.add_argument("--program", default="piso",
                    choices=tuple(sorted(SOLVERS)),
                    help="timestep program: piso (transient) or simple "
                         "(steady-state outer iteration)")
    ap.add_argument("--re", type=float, default=0.0,
                    help="Reynolds number; > 0 derives --nu from the case "
                         "(nu = u_ref * L / Re at domain length L = n*h)")
    ap.add_argument("--n", type=int, default=12, help="cells per axis")
    ap.add_argument("--parts", type=int, default=4, help="fine parts (n_CPU)")
    ap.add_argument("--alpha", type=int, default=2,
                    help="repartitioning ratio (must divide --parts; "
                         "0 = pick via cost model)")
    ap.add_argument("--steps", type=int, default=10,
                    help="timesteps (transient programs)")
    ap.add_argument("--max-outer", type=int, default=0,
                    help="steady programs: outer-iteration cap "
                         "(0 = solver default)")
    ap.add_argument("--co", type=float, default=0.5, help="CFL number")
    ap.add_argument("--nu", type=float, default=0.01)
    ap.add_argument("--p-tol", type=float, default=1e-8,
                    help="pressure CG relative tolerance")
    ap.add_argument("--p-maxiter", type=int, default=2000,
                    help="pressure CG iteration cap")
    ap.add_argument("--schedule", default="device_direct",
                    choices=["device_direct", "host_buffer"])
    ap.add_argument("--solve-mode", default="stacked",
                    choices=["stacked", "full_mesh"],
                    help="pressure solve layout: stacked keeps each coarse "
                         "part's rows together; full_mesh cuts them into "
                         "--parts row shards over --mesh-devices")
    ap.add_argument("--mesh-devices", default=None,
                    help="full_mesh: comma list of the shards' devices, one "
                         "per fine part, repeats allowed (e.g. cuda:0 "
                         "repeated, or cpu,cpu,...); default: the visible "
                         "devices of --device's type, which must be "
                         "--parts many")
    ap.add_argument("--solver-backend", default="auto",
                    choices=["auto", "fused", "reference"],
                    help="Krylov per-iteration backend: fused = the CUDA "
                         "kernels (one-pass SpMV+dot, axpy-pair+Jacobi+"
                         "dots); reference = plain PyTorch; auto = fused "
                         "on a CUDA device")
    ap.add_argument("--adaptive", action="store_true",
                    help="feedback-driven alpha (overrides --alpha; "
                         "transient programs only)")
    ap.add_argument("--hysteresis", type=float, default=0.10,
                    help="min relative predicted gain to switch alpha")
    ap.add_argument("--sample-every", type=int, default=4,
                    help="adaptive mode: timesteps per instrumented "
                         "per-phase sample; steps in between advance in "
                         "windows")
    ap.add_argument("--scan-steps", type=int, default=8,
                    help="window length: up to this many timesteps per "
                         "run_steps call — the whole run in non-adaptive "
                         "mode, and the stretches between instrumented "
                         "samples in adaptive mode")
    ap.add_argument("--pipeline", default="auto",
                    choices=["auto", "on", "off"],
                    help="software-pipelined stepping (auto: whenever the "
                         "program declares a pipelined form; off: serial)")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    return ap


def pipelined(args) -> bool:
    """What ``--pipeline`` resolves to for ``--program`` (the solver
    resolves it the same way, and raises for ``on`` without a form)."""
    return args.pipeline == "on" or (args.pipeline == "auto"
                                     and get_program(args.program).pipelined)


def cost_model(args) -> CostModel:
    """The launcher's cost model: the H100 spec at ``n^3`` dofs, its
    fused-iteration term set by what ``--solver-backend`` resolves to on
    ``--device``."""
    backend = resolve_backend(args.solver_backend, args.device)
    return CostModel(H100, n_dofs=args.n ** 3,
                     fused_solver=backend == "fused")


def build_solver(args, alpha: int | None = None,
                 plan_cache: PlanCache | None = None) -> SegregatedSolver:
    """The solver for parsed launcher ``args`` at ``alpha`` (default
    ``--alpha``); its plans are built here, or taken from ``plan_cache``."""
    mesh = CavityMesh.cube(args.n, args.parts)
    alpha = args.alpha if alpha is None else alpha
    spmd_mesh = None
    if args.mesh_devices:
        spmd_mesh = make_cfd_mesh(args.parts // alpha, alpha,
                                  devices=args.mesh_devices.split(","))
    nu = args.nu
    if args.re > 0:
        case = get_case(args.case, reynolds=args.re)
        nu = case.nu(args.n * mesh.h)
        print(f"Re={args.re:g}: derived nu={nu:.3e} "
              f"(u_ref={case.u_ref:g}, L={args.n * mesh.h:g})")
    return make_solver(args.program, mesh, alpha=alpha, nu=nu,
                       case=args.case, p_tol=args.p_tol,
                       p_maxiter=args.p_maxiter,
                       update_schedule=args.schedule,
                       solver_backend=args.solver_backend,
                       pipeline=args.pipeline, device=args.device,
                       plan_cache=plan_cache, solve_mode=args.solve_mode,
                       spmd_mesh=spmd_mesh)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_host(stats):
    """A step's stats copied to the host: the one read of them per logged
    step (the step itself keeps them on the device)."""
    return type(stats)(*(t.cpu() for t in stats))


def _cat(windows):
    """Per-window stacked stats concatenated along the step axis."""
    return type(windows[0])(*(torch.cat(f) for f in zip(*windows)))


def run_transient(solver: SegregatedSolver, dt: float, n_steps: int,
                  state: PisoState | None = None, log=print,
                  scan_steps: int = 1
                  ) -> tuple[PisoState, StepStats, list[float]]:
    """Advance ``n_steps`` in windows of at most ``scan_steps`` steps
    (``roll_schedule``, as the JAX launcher does) through the solver's
    stepper (pipelined or serial, as its ``pipeline`` knob resolved);
    returns the final state, the per-step stacked stats (on the solver's
    device) and each window's wall seconds (synchronised; one per step by
    default)."""
    state = solver.initial_state() if state is None else state
    history, walls = [], []
    step = 0
    for _sample, chunk in roll_schedule(0, n_steps, None,
                                        cap=max(scan_steps, 1)):
        _sync(solver.device)
        t0 = time.perf_counter()
        state, stats = solver._stepper.run_steps(state, dt, chunk,
                                                 *solver._extras())
        _sync(solver.device)
        walls.append(time.perf_counter() - t0)
        history.append(stats)
        host = _to_host(stats)
        window = f" for {chunk} steps" if chunk > 1 else ""
        for j in range(chunk):
            wall = f" ({walls[-1]:.3f} s{window})" if j == chunk - 1 else ""
            log(f"step {step + j}: mom_iters={int(host.mom_iters[j])} "
                f"p_iters={host.p_iters[j].tolist()} "
                f"continuity={float(host.continuity_err[j]):.2e} "
                f"converged={bool(host.converged[j])}{wall}")
        step += chunk
    return state, _cat(history), walls


def run_adaptive(solver: SegregatedSolver,
                 controller: RepartitionController, dt: float, n_steps: int,
                 scan_steps: int, state: PisoState | None = None, log=print
                 ) -> tuple[PisoState, StepStats, list[tuple]]:
    """Advance ``n_steps`` under the repartitioning controller (the JAX
    launcher's adaptive branch).

    On the sampling grid of ``roll_schedule(0, n_steps,
    controller.config.sample_every, cap=scan_steps)`` a step is one
    instrumented ``timed_step`` whose ``PhaseBreakdown`` feeds
    ``controller.step``; a switch rebinds the solver's alpha (its plan
    from the solver's plan cache) for the steps after it.  The stretches
    in between run as windows of ``run_steps``.  The solver starts at the
    controller's alpha.  Returns the final state, the per-step stacked
    stats and the windows as ``(first step, is_sample, steps, alpha the
    window ran at)``.
    """
    cfg = controller.config
    if solver.alpha != controller.alpha:
        solver.rebind_alpha(controller.alpha)
    log(f"controller start: alpha={controller.alpha} "
        f"solve_mode={solver.solve_mode} "
        f"solver_backend={solver.solver_backend} "
        f"sample_every={cfg.sample_every}")
    state = solver.initial_state() if state is None else state
    t0 = time.perf_counter()
    history, windows = [], []
    step = 0
    for is_sample, chunk in roll_schedule(0, n_steps, cfg.sample_every,
                                          cap=max(scan_steps, 1)):
        windows.append((step, is_sample, chunk, solver.alpha))
        if is_sample:
            # instrumented sample: per-phase timers feed the controller
            state, stats, sample = solver.timed_step(state, dt)
            new_alpha = controller.step(sample)
            if new_alpha != solver.alpha:
                log(f"step {step}: controller switch alpha "
                    f"{solver.alpha} -> {new_alpha}")
                solver.rebind_alpha(new_alpha)
            host = _to_host(stats)
            log(f"step {step}: alpha={solver.alpha} "
                f"p_iters={[int(i) for i in host.p_iters]} "
                f"continuity={float(host.continuity_err):.2e} "
                f"phases(ms)=[as {sample.assembly*1e3:.1f} "
                f"up {sample.update*1e3:.1f} ha {sample.halo*1e3:.1f} "
                f"so {sample.solve*1e3:.1f}]")
            stats = type(stats)(*(t.unsqueeze(0) for t in stats))
        else:
            state, stats = solver._stepper.run_steps(state, dt, chunk,
                                                     *solver._extras())
            host = _to_host(stats)
            log(f"steps {step}..{step + chunk - 1}: "
                f"alpha={solver.alpha} rolled x{chunk} "
                f"p_iters={[int(i) for i in host.p_iters[-1]]} "
                f"continuity={float(host.continuity_err[-1]):.2e}")
        history.append(stats)
        step += chunk
    _sync(solver.device)
    s = controller.stats()
    log(f"{n_steps} steps in {time.perf_counter() - t0:.2f}s "
        f"({solver.mesh.n_cells_global} cells); final alpha="
        f"{controller.alpha}, {len(s['switches'])} switch(es), "
        f"plan cache {s['cache']['hits']} hits / "
        f"{s['cache']['misses']} misses")
    return state, _cat(history), windows


def run_steady(solver: SegregatedSolver, dt: float,
               max_outer: int | None = None, state: PisoState | None = None,
               log=print):
    """Iterate a steady program to its convergence predicate (at most
    ``max_outer`` outer iterations, default the solver's); returns
    ``(state, stats, n_outer, seconds)`` (synchronised wall)."""
    _sync(solver.device)
    t0 = time.perf_counter()
    state, stats, n_outer = solver.run_steady(dt=dt, state=state,
                                              max_outer=max_outer)
    _sync(solver.device)
    wall = time.perf_counter() - t0
    done = bool(solver.program.converged(stats))
    host = _to_host(stats)
    log(f"{solver.case}/{solver.program_name}: "
        f"{'converged' if done else 'CAPPED'} after {n_outer} outer "
        f"iterations in {wall:.2f}s "
        f"({wall / max(n_outer, 1) * 1e3:.1f} ms/outer)")
    log(f"  continuity={float(host.continuity_err):.2e} "
        f"(tol {solver.tol_continuity:.0e}) "
        f"u_delta={float(host.u_delta):.2e} (tol {solver.tol_u:.0e}) "
        f"mom_iters={int(host.mom_iters)} "
        f"p_iters={[int(i) for i in host.p_iters]}")
    log(f"  ({solver.mesh.n_cells_global} cells, alpha={solver.alpha}, "
        f"relax_u={solver.relax_u}, relax_p={solver.relax_p}, "
        f"solver_backend={solver.solver_backend}, "
        f"precision={solver.precision}, device={solver.device})")
    return state, stats, n_outer, wall


def main(argv=None):
    args = build_parser().parse_args(argv)
    cm = cost_model(args)
    transient = get_program(args.program).transient
    alpha = None if args.alpha == 0 or args.adaptive else args.alpha
    ctl = None
    if args.adaptive and transient:
        # fixed_fine: the fine part count is --parts and alpha fuses, so
        # only divisors of --parts are feasible
        cfg = ControllerConfig(hysteresis=args.hysteresis,
                               sample_every=max(args.sample_every, 1))
        ctl = RepartitionController(cm, n_cpu=args.parts, n_gpu=1,
                                    alpha0=alpha, config=cfg,
                                    cache=PlanCache(), fixed_fine=True,
                                    solve_mode=args.solve_mode,
                                    solver_backend=args.solver_backend,
                                    pipelined=pipelined(args))
        alpha = ctl.alpha
    elif alpha is None:
        if args.adaptive:
            print("note: --adaptive applies to transient programs only; "
                  "running the steady outer loop at the fixed alpha")
        alpha = cm.optimal_alpha(n_cpu=args.parts, n_gpu=1)
        print(f"cost model picked alpha={alpha}")
    t0 = time.perf_counter()
    solver = build_solver(args, alpha=alpha,
                          plan_cache=None if ctl is None else ctl.cache)
    print(f"setup {time.perf_counter() - t0:.2f} s (repartition plans "
          f"{solver.plan_seconds:.2f} s) on {solver.device}")
    mesh = solver.mesh
    dt = args.co * mesh.h  # u_ref 1 -> dt = Co*h (steady programs: unused)
    if not transient:
        state, stats, _, _ = run_steady(solver, dt, args.max_outer or None)
        return state, stats
    if ctl is not None:
        state, stats, _ = run_adaptive(solver, ctl, dt, args.steps,
                                       args.scan_steps)
        return state, stats
    state, stats, walls = run_transient(solver, dt, args.steps,
                                        scan_steps=args.scan_steps)
    print(f"{args.steps} steps in {sum(walls):.2f} s "
          f"({mesh.n_cells_global} cells, alpha={solver.alpha}, "
          f"solver_backend={args.solver_backend}, "
          f"solve_mode={solver.solve_mode}, device={solver.device}, "
          f"scan_steps={max(args.scan_steps, 1)}, "
          f"pipelined={solver.pipelined})")
    return state, stats


if __name__ == "__main__":
    main()
