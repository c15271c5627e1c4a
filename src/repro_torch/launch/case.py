"""CFD launcher: the lid-driven cavity under the PISO program, on a device.

  python -m repro_torch.launch.cavity --n 210 --parts 30 --alpha 30 --steps 3

Builds ``CavityMesh.cube(n, parts)`` and a :class:`~repro_torch.fvm.piso.
PisoSolver` (its repartition plans are built once, on the host, and timed
apart from the steps), then advances ``--steps`` timesteps of ``dt = co *
h``, printing one line per step.  ``--device`` defaults to ``cuda``;
``--device cpu`` runs the same path on the CPU.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.fvm.mesh import CavityMesh
from repro_torch.fvm.piso import PisoSolver, PisoState, StepStats

__all__ = ["build_parser", "build_solver", "run_transient", "main"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=12, help="cells per axis")
    ap.add_argument("--parts", type=int, default=4, help="fine parts (n_CPU)")
    ap.add_argument("--alpha", type=int, default=2,
                    help="repartitioning ratio (must divide --parts)")
    ap.add_argument("--steps", type=int, default=10, help="timesteps")
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


def build_solver(args) -> PisoSolver:
    """The solver for parsed launcher ``args`` (plans built here)."""
    mesh = CavityMesh.cube(args.n, args.parts)
    return PisoSolver(mesh, alpha=args.alpha, nu=args.nu,
                      p_tol=args.p_tol, p_maxiter=args.p_maxiter,
                      update_schedule=args.schedule,
                      solver_backend=args.solver_backend, device=args.device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_transient(solver: PisoSolver, dt: float, n_steps: int,
                  state: PisoState | None = None, log=print
                  ) -> tuple[PisoState, StepStats, list[float]]:
    """Advance ``n_steps`` one at a time; returns the final state, the
    per-step stacked stats and each step's wall seconds (synchronised)."""
    state = solver.initial_state() if state is None else state
    history, walls = [], []
    for i in range(n_steps):
        _sync(solver.device)
        t0 = time.perf_counter()
        state, stats = solver.step(state, dt)
        _sync(solver.device)
        walls.append(time.perf_counter() - t0)
        history.append(stats)
        log(f"step {i}: mom_iters={int(stats.mom_iters)} "
            f"p_iters={stats.p_iters.tolist()} "
            f"continuity={float(stats.continuity_err):.2e} "
            f"converged={bool(stats.converged)} "
            f"({walls[-1]:.3f} s)")
    stacked = StepStats(*(torch.stack(f) for f in zip(*history)))
    return state, stacked, walls


def main(argv=None):
    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()
    solver = build_solver(args)
    print(f"setup {time.perf_counter() - t0:.2f} s (repartition plans "
          f"{solver.plan_seconds:.2f} s) on {solver.device}")
    mesh = solver.mesh
    dt = args.co * mesh.h  # u_ref 1 -> dt = Co*h
    state, stats, walls = run_transient(solver, dt, args.steps)
    print(f"{args.steps} steps in {sum(walls):.2f} s "
          f"({mesh.n_cells_global} cells, alpha={solver.alpha}, "
          f"solver_backend={args.solver_backend}, device={solver.device})")
    return state, stats


if __name__ == "__main__":
    main()
