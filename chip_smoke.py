#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card; with no card, or
without the rest of the checkout beside it, it exits nonzero and prints no
result.  Phases, in order (any failure exits nonzero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of every kernel from ``src/repro_torch/csrc`` (``nvcc``, in
   parallel), with its seconds and the register counts ``ptxas`` reports;
3. each kernel against its plain PyTorch version on the card, for every
   (storage, accum) pair, at the main path's two shapes and one small
   ragged shape; then each kernel's time at the pressure shape beside its
   byte floor, the plain version's time and, for the SpMV, a
   ``torch.sparse`` CSR product's (a yardstick the port never calls);
4. the main path at full size: 3 PISO steps of the 210^3 cavity, 30 fine
   parts fused with alpha = 30, through the launcher's code path, with the
   kernels: every launch counter must move, every step converge with a
   continuity error below 1e-6;
5. determinism: the kernel run again, step by step, bitwise equal;
6. parity: the plain-PyTorch backend takes each step from the kernel run's
   state (step 0 from the shared initial state) and must agree within
   1e-10 of each field's max, with identical Krylov counts and flags; its
   free run from the initial state is reported and held to the solver
   tolerance (the two backends round their dot products in different
   orders, and a Krylov solve only pins its answer to its tolerance, so
   free runs drift apart at that level); a small mesh on the card is held
   against the port's CPU run; one step is timed phase by phase.

The line before the last is the card's ``nvidia-smi`` name and power
limit, the one before that the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the main path: the paper's smallest mesh, (2*3*5*7)^3 cells, 30 fine
# slabs fused into one coarse part.  At this size the pressure CG needs
# more than the default 2000 iterations and a 1e-8 relative tolerance
# leaves a continuity error above 1e-6, so the run tightens both.
MAIN_ARGS = ["--n", "210", "--parts", "30", "--alpha", "30", "--steps", "3",
             "--co", "0.5", "--p-tol", "1e-10", "--p-maxiter", "6000",
             "--device", "cuda"]
PARITY = 1e-10        # fused vs plain backend, one step from one state,
#                       relative to the field's max
FREE_RUN_DRIFT = 1e-5  # free runs of the two backends: 100x mom_tol
CONTINUITY = 1e-6
# kernel vs plain version, relative to the output's max, per storage dtype
TOLERANCE = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 2e-2}
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
FLOPS_PER_S = {"float64": 34e12,    # FP64 outside the tensor cores
               "float32": 67e12, "bfloat16": 67e12}
SOURCES = {"spmv_dia": "src/repro_torch/csrc/spmv_dia.cu",
           "spmv_dot": "src/repro_torch/csrc/krylov_fused.cu",
           "axpy_precond": "src/repro_torch/csrc/krylov_fused.cu"}
REPLACES = {"spmv_dia": "src/repro/kernels/spmv_dia/spmv_dia.py:53",
            "spmv_dot": "src/repro/kernels/krylov_fused/krylov_fused.py:118",
            "axpy_precond":
                "src/repro/kernels/krylov_fused/krylov_fused.py:189"}


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def offsets_for(nx: int, plane: int) -> tuple[int, ...]:
    return (-plane, -nx, -1, 0, 1, nx, plane)


def make_inputs(torch, P, m, gen, dev):
    """Positive random operands (every dot is a sum of positive terms, so a
    relative error is well defined), in float64."""
    def rnd(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           dtype=torch.float64, device=dev)
    return {"bands": rnd(P, 7, m), "x": rnd(P, m), "r": rnd(P, m),
            "p": rnd(P, m), "Ap": rnd(P, m), "inv": rnd(P, m, lo=0.5, hi=1.5),
            "alpha": torch.tensor(0.3, dtype=torch.float64, device=dev)}


def compare(torch, got, want) -> tuple[float, float]:
    """(max abs error, max error relative to the output's max |want|) over
    matching outputs."""
    abs_err = rel = 0.0
    for g, w in zip(got, want):
        err = float((g.double() - w.double()).abs().max())
        abs_err = max(abs_err, err)
        rel = max(rel, err / max(float(w.double().abs().max()), 1e-300))
    return abs_err, rel


def kernel_calls(kernels, plain, inputs, offsets, plane, storage, accum):
    """{kernel: (kernel call, plain call)} on ``inputs`` cast to storage."""
    b = inputs["bands"].to(storage)
    x = inputs["x"].to(storage)
    vecs = [inputs[k].to(storage) for k in ("x", "r", "p", "Ap", "inv")]
    alpha = inputs["alpha"].to(accum)
    kw = dict(offsets=offsets, plane=plane, accum_dtype=accum)
    return {
        "spmv_dia": (lambda: (kernels["spmv_dia"](b, x, **kw),),
                     lambda: (plain["spmv_dia"](b, x, **kw),)),
        "spmv_dot": (lambda: kernels["spmv_dot"](b, x, **kw),
                     lambda: plain["spmv_dot"](b, x, **kw)),
        "axpy_precond": (
            lambda: kernels["axpy_precond"](*vecs, alpha, accum_dtype=accum),
            lambda: plain["axpy_precond"](*vecs, alpha, accum_dtype=accum)),
    }


def time_ms(torch, fn, n=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def csr_of_bands(torch, bands, offsets):
    """The (n, n) CSR matrix of one part's DIA bands (P = 1)."""
    _, nb, n = bands.shape
    rows = torch.arange(n, device=bands.device)
    cols = rows[:, None] + torch.tensor(offsets, device=bands.device)[None, :]
    valid = (cols >= 0) & (cols < n)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=bands.device)
    crow[1:] = torch.cumsum(valid.sum(dim=1), dim=0)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, cols[valid], bands[0].T[valid],
                                       size=(n, n), check_invariants=False)


def check_kernels(torch, dev) -> dict:
    from repro_torch.kernels import WRAPPERS
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        fused_axpy_precond_cost, fused_axpy_precond_plain, spmv_dot_cost,
        spmv_dot_plain)
    from repro_torch.kernels.spmv_dia.spmv_dia import (KERNEL_BLOCK_ROWS,
                                                       spmv_dia_cost,
                                                       spmv_dia_plain)

    from repro_torch.solvers.precision import POLICIES

    plain = {"spmv_dia": spmv_dia_plain, "spmv_dot": spmv_dot_plain,
             "axpy_precond": fused_axpy_precond_plain}
    # (storage, accum) of every precision policy: f64, f32_ir, bf16_ir
    pairs = [(p.storage_dtype, p.accum_dtype) for p in POLICIES.values()]
    # (label, P, m, nx, plane): the pressure and momentum systems of the
    # main path, and a ragged shape (P*m not a multiple of the block)
    shapes = [("pressure", 1, 210 ** 3, 210, 210 ** 2),
              ("momentum", 30, 210 ** 3 // 30, 210, 210 ** 2),
              ("ragged", 3, 777, 4, 16)]
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {name: {} for name in WRAPPERS}
    for label, P, m, nx, plane in shapes:
        inputs = make_inputs(torch, P, m, gen, dev)
        offsets = offsets_for(nx, plane)
        for storage, accum in pairs:
            sname = str(storage).removeprefix("torch.")
            calls = kernel_calls(WRAPPERS, plain, inputs, offsets, plane,
                                 storage, accum)
            for name, (k_fn, p_fn) in calls.items():
                got = k_fn()
                torch.cuda.synchronize()
                abs_err, rel = compare(torch, got, p_fn())
                ok = rel <= TOLERANCE[sname]
                print(f"  {name:13s} {label:9s} {sname:8s}/"
                      f"{str(accum).removeprefix('torch.'):8s} "
                      f"max_abs_err={abs_err:.3e} rel={rel:.3e} "
                      f"(tol {TOLERANCE[sname]:.0e}) {'ok' if ok else 'FAIL'}")
                require(ok, f"{name} disagrees with its plain version at "
                            f"{label} {sname}: rel {rel:.3e}")
                if label == "pressure" and storage == torch.float64:
                    report[name]["max_abs_err"] = abs_err
        if label == "pressure":
            # times at the pressure shape, f64, cold in the 50 MB L2
            n = P * m
            b, x = inputs["bands"], inputs["x"]
            calls = kernel_calls(WRAPPERS, plain, inputs, offsets, plane,
                                 torch.float64, torch.float64)
            costs = {
                "spmv_dia": spmv_dia_cost(7, n),
                "spmv_dot": spmv_dot_cost(7, n, 0,
                                          block_rows=KERNEL_BLOCK_ROWS),
                "axpy_precond": fused_axpy_precond_cost(
                    n, block_rows=KERNEL_BLOCK_ROWS),
            }
            csr = csr_of_bands(torch, b, offsets)
            x_flat = x.reshape(-1)
            lib = {"spmv_dia": time_ms(torch, lambda: csr @ x_flat)}
            del csr
            for name, (k_fn, p_fn) in calls.items():
                c = costs[name]
                t_bytes = c["bytes_accessed"] / HBM_BYTES_PER_S * 1e3
                t_ops = c["flops"] / FLOPS_PER_S["float64"] * 1e3
                rep = report[name]
                rep.update(
                    ms=time_ms(torch, k_fn), plain_ms=time_ms(torch, p_fn),
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    library_ms=lib.get(name), bytes=c["bytes_accessed"])
                print(f"  {name:13s} ms={rep['ms']:.4f} "
                      f"plain_ms={rep['plain_ms']:.4f} "
                      f"bound_ms={rep['bound_ms']:.4f} ({rep['bound_by']}, "
                      f"{c['bytes_accessed']} B) library_ms="
                      f"{rep['library_ms']}")
        del inputs
        torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def timed_step(torch, solver, state, dt) -> dict:
    """One step walked phase by phase with synchronised wall timers."""
    from repro_torch.fvm.step_program import _bind

    prog = solver.program
    env = prog.seed(state, dt)
    walls = {}
    for ph in prog.phases:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _bind(env, ph, ph.fn(*(env[k] for k in ph.inputs)))
        torch.cuda.synchronize()
        walls[ph.label] = time.perf_counter() - t0
    _, stats = prog.finalize(env)
    return {"walls": walls, "p_iters": stats.p_iters.tolist(),
            "mom_iters": int(stats.mom_iters)}


def check_steps(torch, stats, tag: str) -> None:
    require(bool(stats.converged.all()), f"{tag}: a step did not converge")
    require(not bool(stats.diverged.any()), f"{tag}: a step diverged")
    cont = float(stats.continuity_err.max())
    require(cont < CONTINUITY, f"{tag}: continuity {cont:.3e} >= {CONTINUITY}")


def small_mesh_parity(torch) -> None:
    """The kernels' main path on a small mesh against the port on the CPU."""
    from repro_torch.fvm.mesh import CavityMesh
    from repro_torch.fvm.piso import PisoSolver

    runs = {}
    for dev, backend in (("cuda", "fused"), ("cpu", "reference")):
        s = PisoSolver(CavityMesh.cube(8, 4), alpha=2, solver_backend=backend,
                       device=dev)
        state, stats = s.run(3, 2e-4)
        runs[dev] = (state, stats)
    (sg, tg), (sc, tc) = runs["cuda"], runs["cpu"]
    for f in sg._fields:
        a, b = getattr(sg, f).cpu(), getattr(sc, f)
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)
        require(err <= PARITY, f"small mesh: {f} differs by {err:.3e}")
    require(torch.equal(tg.p_iters.cpu(), tc.p_iters)
            and torch.equal(tg.mom_iters.cpu(), tc.mom_iters),
            "small mesh: Krylov counts differ from the CPU run")
    print(f"  small mesh 8^3/4 parts/alpha 2: card == cpu within {PARITY:.0e}, "
          f"p_iters {tc.p_iters.tolist()}")


def rel_diff(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def main_path(torch) -> dict:
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.case import (build_parser, build_solver,
                                         run_transient)
    from repro_torch.solvers.ops import resolve_backend

    args = build_parser().parse_args(MAIN_ARGS)
    t0 = time.perf_counter()
    solver = build_solver(args)
    print(f"  setup {time.perf_counter() - t0:.2f} s, repartition plans "
          f"(host) {solver.plan_seconds:.2f} s")
    require(resolve_backend(solver.solver_backend, solver.device) == "fused",
            "the default backend does not resolve to fused on the card")
    dt = args.co * solver.mesh.h
    n = args.steps

    def steps(backend, state, n_steps, at=0):
        solver.solver_backend = backend
        return run_transient(
            solver, dt, n_steps, state=state,
            log=lambda line: print(f"  {backend} from step {at}: {line}"))

    # the main drive: the launcher's loop with the kernels, counters from 0
    state0 = solver.initial_state()
    reset_launch_counts()
    state_f, stats_f, walls_f = steps("auto", state0, n)
    counts = launch_counts()
    print(f"  kernel launches over {n} steps: {counts}")
    require(all(c > 0 for c in counts.values()),
            f"a kernel of the main path was never launched: {counts}")
    check_steps(torch, stats_f, "fused")

    # determinism: the same steps again, one at a time, bitwise equal; the
    # per-step states feed the parity check below
    print("  determinism: the kernel run again, step by step")
    fused = [(state0, None)]
    for k in range(n):
        st, stt, _ = steps("auto", fused[-1][0], 1, at=k)
        fused.append((st, stt))
    same = all(torch.equal(getattr(state_f, f), getattr(fused[-1][0], f))
               for f in state_f._fields)
    for k in range(n):
        same = same and all(torch.equal(a[k], b[0])
                            for a, b in zip(stats_f, fused[k + 1][1]))
    require(same, "the repeated kernel run is not bitwise equal")
    print("  repeated run bitwise equal: True")

    # parity, step by step: the plain-PyTorch backend takes each step from
    # the kernel run's state (step 0 from the shared initial state)
    print("  parity: plain-PyTorch backend, each step from the kernel "
          "run's state")
    per_step, walls_r = [], []
    for k in range(n):
        st_r, stt_r, w = steps("reference", fused[k][0], 1, at=k)
        walls_r += w
        if k == 0:
            first_ref = (st_r, stt_r)
        st_f, stt_f = fused[k + 1]
        check_steps(torch, stt_r, f"reference step {k}")
        diffs = {f: rel_diff(getattr(st_f, f), getattr(st_r, f))
                 for f in st_f._fields if f != "phi_b"}
        per_step.append(diffs)
        print(f"  step {k}: max|d|/max over U, p, phi, phi_if: "
              + ", ".join(f"{v:.3e}" for v in diffs.values()))
        require(max(diffs.values()) <= PARITY,
                f"step {k}: fused vs reference differ by {diffs}")
        for f in ("mom_iters", "p_iters", "converged", "hit_cap"):
            require(torch.equal(getattr(stt_f, f)[0], getattr(stt_r, f)[0]),
                    f"step {k}: {f} differs between the backends")

    # free run of the plain backend from the initial state: reported, and
    # held to the solver tolerances (each BiCGStab answer is only within
    # mom_tol of the exact one, so two free runs that round differently
    # drift apart at about that level and not at round-off)
    st_r, stt_r = first_ref
    free_stats = [stt_r]
    for k in range(1, n):
        st_r, stt_r, _ = steps("reference", st_r, 1, at=k)
        free_stats.append(stt_r)
    free = {f: rel_diff(getattr(state_f, f), getattr(st_r, f))
            for f in ("U", "p")}
    free_iters = {f: [int(x) for s_ in free_stats
                      for x in getattr(s_, f).reshape(-1)]
                  for f in ("mom_iters", "p_iters")}
    print(f"  free run after {n} steps: max|dU|/max|U| {free['U']:.3e}, "
          f"max|dp|/max|p| {free['p']:.3e}; reference counts {free_iters}")
    for s_ in free_stats:
        check_steps(torch, s_, "reference free run")
    require(max(free.values()) <= FREE_RUN_DRIFT,
            f"free runs drift apart by {free}")

    small_mesh_parity(torch)

    solver.solver_backend = "auto"
    breakdown = timed_step(torch, solver, state_f, dt)
    cg_s = sum(v for k, v in breakdown["walls"].items()
               if k.startswith("solve_p"))
    print("  timed step: " + ", ".join(
        f"{k} {v:.4f}" for k, v in breakdown["walls"].items())
        + f" s; p_iters {breakdown['p_iters']}")
    summary = {
        "plan_s": solver.plan_seconds,
        "s_per_step_fused": walls_f, "s_per_step_reference": walls_r,
        "mom_iters": stats_f.mom_iters.tolist(),
        "p_iters": stats_f.p_iters.tolist(),
        "continuity": stats_f.continuity_err.tolist(),
        "launches": counts,
        "launches_per_step": {k: v / n for k, v in counts.items()},
        "ms_per_cg_iter": 1e3 * cg_s / sum(breakdown["p_iters"]),
        "timed_step_s": breakdown["walls"],
        "per_step_parity": per_step, "free_run_drift": free,
        "free_run_reference_iters": free_iters,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"  seconds per step (kernels) {[round(w, 3) for w in walls_f]}, "
          f"(plain) {[round(w, 3) for w in walls_r]}; "
          f"{int(stats_f.p_iters.sum())} CG iterations; "
          f"{summary['ms_per_cg_iter']:.4f} ms per CG iteration (timed step)")
    return summary


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not importable", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False — this smoke test "
              "needs a CUDA card", file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels._build import build_all
    except ImportError as e:
        print(f"FAIL: the port is not importable beside chip_smoke.py ({e})",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    try:
        dev = torch.device("cuda")
        smi = smi_line()
        print(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
        print("[2] build")
        info = build_all()
        print(f"  built {info['built'] or 'nothing (cached)'} in "
              f"{info['seconds']:.1f} s")
        for name, log in info["ptxas"].items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
        print("[3] kernels vs plain versions")
        report = check_kernels(torch, dev)
        print("[4-6] main path: 210^3 cavity, 30 parts, alpha 30, 3 PISO "
              "steps; determinism; parity")
        torch.cuda.reset_peak_memory_stats()
        summary = main_path(torch)
        print(f"done in {time.perf_counter() - t_start:.1f} s")
        print("summary " + json.dumps(summary))
        kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                    "replaces": REPLACES[name],
                    "launches": summary["launches"][name],
                    **{k: report[name][k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")}}
                   for name in report]
        print(json.dumps({"kernels": kernels}))
        print(smi_line())
    except Exception:  # noqa: BLE001 — the smoke test's boundary: report, fail
        traceback.print_exc()
        print("FAIL", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
