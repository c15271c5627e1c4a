"""CFD launcher: any registered flow case under any registered program.

  python -m repro_torch.launch.case --n 210 --parts 30 --alpha 30 --steps 3
  python -m repro_torch.launch.case --program simple --case channel --n 8

Builds ``CavityMesh.cube(n, parts)`` and the solver of ``--program`` (its
repartition plans are built once, on the host, and timed apart from the
steps).  A transient program (PISO) advances ``--steps`` timesteps of
``dt = co * h``, printing one line per step; a steady program (SIMPLE)
iterates to its convergence predicate, capped at ``--max-outer`` outer
iterations, and prints the verdict and the last residuals.
``--device`` defaults to ``cuda``; ``--device cpu`` runs the same path on
the CPU.  ``python -m repro_torch.launch.cavity`` is the same launcher.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.fvm.cases import case_names, get_case
from repro_torch.fvm.mesh import CavityMesh
from repro_torch.fvm.piso import (SOLVERS, PisoState, SegregatedSolver,
                                  StepStats, make_solver)
from repro_torch.fvm.step_program import get_program

__all__ = ["build_parser", "build_solver", "run_transient", "run_steady",
           "main"]


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
                    help="repartitioning ratio (must divide --parts)")
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
    ap.add_argument("--solver-backend", default="auto",
                    choices=["auto", "fused", "reference"],
                    help="Krylov per-iteration backend: fused = the CUDA "
                         "kernels (one-pass SpMV+dot, axpy-pair+Jacobi+"
                         "dots); reference = plain PyTorch; auto = fused "
                         "on a CUDA device")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    return ap


def build_solver(args) -> SegregatedSolver:
    """The solver for parsed launcher ``args`` (plans built here)."""
    mesh = CavityMesh.cube(args.n, args.parts)
    nu = args.nu
    if args.re > 0:
        case = get_case(args.case, reynolds=args.re)
        nu = case.nu(args.n * mesh.h)
        print(f"Re={args.re:g}: derived nu={nu:.3e} "
              f"(u_ref={case.u_ref:g}, L={args.n * mesh.h:g})")
    return make_solver(args.program, mesh, alpha=args.alpha, nu=nu,
                       case=args.case, p_tol=args.p_tol,
                       p_maxiter=args.p_maxiter,
                       update_schedule=args.schedule,
                       solver_backend=args.solver_backend,
                       device=args.device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_host(stats):
    """A step's stats copied to the host: the one read of them per logged
    step (the step itself keeps them on the device)."""
    return type(stats)(*(t.cpu() for t in stats))


def run_transient(solver: SegregatedSolver, dt: float, n_steps: int,
                  state: PisoState | None = None, log=print
                  ) -> tuple[PisoState, StepStats, list[float]]:
    """Advance ``n_steps`` one at a time; returns the final state, the
    per-step stacked stats (on the solver's device) and each step's wall
    seconds (synchronised)."""
    state = solver.initial_state() if state is None else state
    history, walls = [], []
    for i in range(n_steps):
        _sync(solver.device)
        t0 = time.perf_counter()
        state, stats = solver.step(state, dt)
        _sync(solver.device)
        walls.append(time.perf_counter() - t0)
        history.append(stats)
        host = _to_host(stats)
        log(f"step {i}: mom_iters={int(host.mom_iters)} "
            f"p_iters={host.p_iters.tolist()} "
            f"continuity={float(host.continuity_err):.2e} "
            f"converged={bool(host.converged)} "
            f"({walls[-1]:.3f} s)")
    stacked = StepStats(*(torch.stack(f) for f in zip(*history)))
    return state, stacked, walls


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
    t0 = time.perf_counter()
    solver = build_solver(args)
    print(f"setup {time.perf_counter() - t0:.2f} s (repartition plans "
          f"{solver.plan_seconds:.2f} s) on {solver.device}")
    mesh = solver.mesh
    dt = args.co * mesh.h  # u_ref 1 -> dt = Co*h (steady programs: unused)
    if not get_program(args.program).transient:
        state, stats, _, _ = run_steady(solver, dt, args.max_outer or None)
        return state, stats
    state, stats, walls = run_transient(solver, dt, args.steps)
    print(f"{args.steps} steps in {sum(walls):.2f} s "
          f"({mesh.n_cells_global} cells, alpha={solver.alpha}, "
          f"solver_backend={args.solver_backend}, device={solver.device})")
    return state, stats


if __name__ == "__main__":
    main()
