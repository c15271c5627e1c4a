#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card; with no card, or
without the rest of the checkout beside it, it exits nonzero and prints no
result.  Phases, in order (any failure exits nonzero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of every kernel from ``src/repro_torch/csrc`` (``nvcc``, in
   parallel), with its seconds and the register counts ``ptxas`` reports;
3. each kernel against its plain PyTorch version on the card: the three
   Krylov kernels for every (storage, accum) pair at the main path's two
   shapes and one small ragged shape; the value-update gather on the real
   210^3 plans (pressure, alpha 30, and momentum, alpha 1) and a ragged
   shape, for float64/float32/bfloat16, bitwise; the momentum-assembly
   kernel at the coarse and fine 210^3 shapes, float64 and float32.  Then
   each kernel's time at the pressure shape beside its byte floor, the
   plain version's time and, where one PyTorch call computes the same
   function, that call's (a yardstick the port never calls);
4. the main path at full size: 3 PISO steps of the 210^3 cavity, 30 fine
   parts fused with alpha = 30, through the launcher's code path, with the
   kernels: the step's four kernels' launch counters must move (the
   value update 3 times a step), every step converge with a continuity
   error below 1e-6;
5. determinism: the kernel run again, step by step, bitwise equal;
6. parity: the plain-PyTorch backend takes each step from the kernel run's
   state (step 0 from the shared initial state) and must agree within
   1e-10 of each field's max, with identical Krylov counts and flags; its
   free run from the initial state is reported and held to the solver
   tolerance (the two backends round their dot products in different
   orders, and a Krylov solve only pins its answer to its tolerance, so
   free runs drift apart at that level); a small mesh on the card is held
   against the port's CPU run; one step is timed phase by phase;
7. rebinding: from the main run's state, ``rebind_alpha(15)`` and one
   step, held to the alpha-30 step from the same state (1e-10, identical
   counts and flags); ``rebind_alpha(30)`` then builds nothing;
8. the refactoring baseline: ``momentum_bands`` from the main run's
   velocity on the coarse mesh (1 part) against fine assembly plus the
   alpha-30 value update, and on the fine mesh against the step's own
   momentum bands, within 1e-12; both paths timed.

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
N, PARTS, ALPHA = 210, 30, 30
MAIN_ARGS = ["--n", str(N), "--parts", str(PARTS), "--alpha", str(ALPHA),
             "--steps", "3",
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
           "axpy_precond": "src/repro_torch/csrc/krylov_fused.cu",
           "coef_update": "src/repro_torch/csrc/coef_update.cu",
           "momentum_bands": "src/repro_torch/csrc/stencil_assembly.cu"}
REPLACES = {"spmv_dia": "src/repro/kernels/spmv_dia/spmv_dia.py:53",
            "spmv_dot": "src/repro/kernels/krylov_fused/krylov_fused.py:118",
            "axpy_precond":
                "src/repro/kernels/krylov_fused/krylov_fused.py:189",
            "coef_update": "src/repro/kernels/coef_update/coef_update.py:37",
            "momentum_bands": "src/repro/kernels/stencil_assembly/"
                              "stencil_assembly.py:74"}
# the kernels a PISO step launches; the momentum-assembly kernel belongs to
# the refactoring baseline's entry point (phase 8)
STEP_KERNELS = ("spmv_dia", "spmv_dot", "axpy_precond", "coef_update")
ASSEMBLY_PARITY = 1e-12  # momentum_bands vs assembly + update, elementwise
#                          rtol = atol (tests/test_kernels.py's bar)


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
    shapes = [("pressure", PARTS // ALPHA, N ** 3 * ALPHA // PARTS, N, N ** 2),
              ("momentum", PARTS, N ** 3 // PARTS, N, N ** 2),
              ("ragged", 3, 777, 4, 16)]
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {name: {} for name in plain}
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
            lib = {"spmv_dia": lambda: csr @ x_flat}
            for name, (k_fn, p_fn) in calls.items():
                report[name].update(timing_report(
                    torch, name, k_fn, p_fn, costs[name], lib.get(name)))
            del csr, lib
        del inputs
        torch.cuda.empty_cache()
    report["coef_update"] = check_coef_update(torch, dev)
    torch.cuda.empty_cache()
    report["momentum_bands"] = check_momentum_bands(torch, dev)
    torch.cuda.empty_cache()
    return report


def timing_report(torch, name, k_fn, p_fn, cost, library=None) -> dict:
    """Kernel, plain and library times (CUDA events) beside the bound."""
    t_bytes = cost["bytes_accessed"] / HBM_BYTES_PER_S * 1e3
    t_ops = cost["flops"] / FLOPS_PER_S["float64"] * 1e3
    rep = {"ms": time_ms(torch, k_fn), "plain_ms": time_ms(torch, p_fn),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None if library is None else time_ms(torch, library),
           "bytes": cost["bytes_accessed"]}
    print(f"  {name:13s} ms={rep['ms']:.4f} plain_ms={rep['plain_ms']:.4f} "
          f"bound_ms={rep['bound_ms']:.4f} ({rep['bound_by']}, "
          f"{rep['bytes']} B) library_ms={rep['library_ms']}")
    return rep


def check_coef_update(torch, dev) -> dict:
    """The value-update gather on the real 210^3 plans: bitwise equal to
    its plain version (a gather does no arithmetic) for every dtype."""
    from repro_torch.core.repartition import plan_for_mesh
    from repro_torch.fvm.mesh import CavityMesh
    from repro_torch.kernels.coef_update.coef_update import (
        coef_update_cost, coef_update_plain, coef_update_stacked)

    mesh = CavityMesh.cube(N, PARTS)
    t0 = time.perf_counter()
    plans = {"pressure": plan_for_mesh(mesh, ALPHA),
             "momentum": plan_for_mesh(mesh, 1)}
    print(f"  coef_update: the two {N}^3 plans built in "
          f"{time.perf_counter() - t0:.2f} s (host)")
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [(label, mesh.n_parts // plan.alpha, plan.sentinel + 1,
              plan.src_on(dev)) for label, plan in plans.items()]
    ragged = torch.randint(0, 1001, (777,), generator=gen, device=dev,
                           dtype=torch.int32)
    ragged[::7] = 1000  # the sentinel slot
    cases.append(("ragged", 3, 1001, ragged))
    rep = {}
    for label, n_c, n_buf, src in cases:
        buf64 = torch.rand((n_c, n_buf), generator=gen, dtype=torch.float64,
                           device=dev)
        buf64[:, -1] = 0.0
        for dtype in (torch.float64, torch.float32, torch.bfloat16):
            buf = buf64.to(dtype)
            got = coef_update_stacked(buf, src)
            want = coef_update_plain(buf, src)
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            abs_err = float((got.double() - want.double()).abs().max())
            print(f"  coef_update   {label:9s} {str(dtype)[6:]:8s} "
                  f"({n_c}, {n_buf}) -> {tuple(got.shape)} "
                  f"max_abs_err={abs_err:.3e} bitwise={same}")
            require(same, f"coef_update differs from its plain version at "
                          f"{label} {dtype}")
            if label == "pressure" and dtype == torch.float64:
                rep["max_abs_err"] = abs_err
            del buf, got, want
        if label == "pressure":
            n_out = src.shape[0]
            src64 = src.long()
            rep.update(timing_report(
                torch, "coef_update", lambda: coef_update_stacked(buf64, src),
                lambda: coef_update_plain(buf64, src),
                coef_update_cost(n_c, n_buf, n_out),
                library=lambda: torch.index_select(buf64, 1, src)))
            rep["int64_index_select_ms"] = time_ms(
                torch, lambda: buf64.index_select(1, src64))
            print(f"    int64-index index_select (the update before the "
                  f"kernel) {rep['int64_index_select_ms']:.4f} ms")
            del src64
        del buf64
    return rep


def check_momentum_bands(torch, dev) -> dict:
    """The momentum-assembly kernel at the coarse (1 part) and fine (30
    parts) 210^3 shapes against its plain version."""
    from repro_torch.kernels.stencil_assembly.stencil_assembly import (
        momentum_bands_cost, momentum_bands_plain, momentum_bands_stacked)

    nx, plane = N, N ** 2
    h = 0.1 / N
    kw = dict(nx=nx, plane=plane, vdt=h ** 3 / (0.5 * h))  # V/dt, dt = 0.5 h
    gen = torch.Generator(device=dev).manual_seed(2)
    rep = {}
    for label, P, m in (("pressure", PARTS // ALPHA, N ** 3 * ALPHA // PARTS),
                        ("momentum", PARTS, N ** 3 // PARTS)):
        faces64 = [torch.rand((P, m), generator=gen, dtype=torch.float64,
                              device=dev) * 2 - 1 for _ in range(7)]
        for dtype in (torch.float64, torch.float32):
            faces = [f.to(dtype) for f in faces64]
            got = momentum_bands_stacked(*faces, **kw)
            want = momentum_bands_plain(*faces, **kw)
            torch.cuda.synchronize()
            abs_err, rel = compare(torch, [got], [want])
            sname = str(dtype).removeprefix("torch.")
            ok = rel <= TOLERANCE[sname]
            print(f"  momentum_bands {label:9s} {sname:8s} ({P}, {m}) "
                  f"max_abs_err={abs_err:.3e} rel={rel:.3e} (tol "
                  f"{TOLERANCE[sname]:.0e}) bitwise={torch.equal(got, want)} "
                  f"{'ok' if ok else 'FAIL'}")
            require(ok, f"momentum_bands disagrees with its plain version at "
                        f"{label} {sname}: rel {rel:.3e}")
            if label == "pressure" and dtype == torch.float64:
                rep["max_abs_err"] = abs_err
            del faces, got, want
        if label == "pressure":
            rep.update(timing_report(
                torch, "momentum_bands",
                lambda: momentum_bands_stacked(*faces64, **kw),
                lambda: momentum_bands_plain(*faces64, **kw),
                momentum_bands_cost(P * m)))
        del faces64
    return rep


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
    state, stats = prog.finalize(env)
    return {"walls": walls, "p_iters": stats.p_iters.tolist(),
            "mom_iters": int(stats.mom_iters), "state": state,
            "stats": stats}


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
    require(all(counts[k] > 0 for k in STEP_KERNELS),
            f"a kernel of the main path was never launched: {counts}")
    require(counts["coef_update"] == 3 * n,
            f"the value update launched {counts['coef_update']} times in "
            f"{n} steps, not 3 a step")
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
    summary["rebind"] = rebind_phase(torch, solver, state_f, dt, breakdown)
    summary["baseline"] = baseline_phase(torch, solver, state_f, dt)
    return summary


def rebind_phase(torch, solver, state, dt, alpha30) -> dict:
    """One step at half the main ratio (alpha 15) from ``state`` against
    the main ratio's step from it (``alpha30``: the timed step); then back
    to the main ratio, memoised."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.case import run_transient

    half = ALPHA // 2
    print(f"[7] rebind_alpha({half}) at full width")
    plan30, prog30, secs = solver.plan_p, solver.program, solver.plan_seconds
    solver.rebind_alpha(half)
    plan_s = solver.plan_seconds - secs
    rows = solver.mesh.n_cells_global * half // PARTS
    require(solver.n_coarse == PARTS // half
            and solver.plan_p.m_coarse == rows,
            f"alpha {half} did not give {PARTS // half} coarse parts of "
            f"{rows} rows")
    print(f"  alpha-{half} plan built in {plan_s:.2f} s (host)")
    reset_launch_counts()
    st, stt, walls = run_transient(
        solver, dt, 1, state=state,
        log=lambda line: print(f"  alpha {half}: {line}"))
    counts = launch_counts()
    check_steps(torch, stt, f"alpha {half}")
    ref_state, ref_stats = alpha30["state"], alpha30["stats"]
    diffs = {f: rel_diff(getattr(st, f), getattr(ref_state, f))
             for f in st._fields if f != "phi_b"}
    bitwise = all(torch.equal(getattr(st, f), getattr(ref_state, f))
                  for f in st._fields)
    print(f"  vs the alpha-{ALPHA} step from the same state: max|d|/max "
          f"over U, "
          f"p, phi, phi_if: " + ", ".join(f"{v:.3e}" for v in diffs.values())
          + f"; bitwise {bitwise}; launches {counts}")
    require(max(diffs.values()) <= PARITY,
            f"alpha {half} vs alpha {ALPHA} differ by {diffs}")
    for f in ("mom_iters", "p_iters", "converged", "hit_cap"):
        require(torch.equal(getattr(stt, f)[0], getattr(ref_stats, f)),
                f"alpha {half} vs alpha {ALPHA}: {f} differs")
    secs_half = solver.plan_seconds
    solver.rebind_alpha(ALPHA)
    require(solver.plan_p is plan30 and solver.program is prog30
            and solver.plan_seconds == secs_half,
            f"rebind_alpha({ALPHA}) rebuilt what it had bound")
    print(f"  rebind_alpha({ALPHA}): memoised plan, index and program, "
          "no build")
    return {"plan_s": plan_s, "step_s": walls[0], "diffs": diffs,
            "bitwise": bitwise, "p_iters": stt.p_iters[0].tolist(),
            "launches": counts}


def baseline_phase(torch, solver, state, dt) -> dict:
    """The refactoring baseline at full width against the plugin path."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.stencil_assembly import momentum_bands

    print("[8] refactoring baseline: momentum_bands vs assembly + update")
    mesh, asm, U = solver.mesh, solver.asm, state.U
    plan30 = solver.plan_p
    require(plan30.alpha == ALPHA, f"the solver is not bound to alpha "
                                   f"{ALPHA}")
    coarse = mesh.with_parts(mesh.n_parts // ALPHA)

    def plugin(plan):  # fine assembly, then the plan's value update
        phi, phi_if = asm.face_flux(U)
        sysM = asm.assemble_momentum(U, phi, phi_if, state.p, dt,
                                     phi_b=state.phi_b)
        return solver._bands(plan, sysM.diag, sysM.upper, sysM.lower,
                             sysM.iface)

    def refactored(m):
        return momentum_bands(U.reshape(m.n_parts, m.n_cells, 3), mesh=m,
                              nu=solver.nu, dt=dt)

    reset_launch_counts()
    pairs = {f"coarse ({coarse.n_parts} part) vs fine + alpha-{ALPHA} update":
             (refactored(coarse), plugin(plan30)),
             f"fine ({mesh.n_parts} parts) vs the step's bandsM":
             (refactored(mesh), plugin(solver.plan_mom))}
    torch.cuda.synchronize()
    counts = launch_counts()
    out = {"launches": counts}
    for label, (b, a) in pairs.items():
        require(b.shape == a.shape, f"{label}: shapes {b.shape} {a.shape}")
        err = (b - a).abs()
        ok = bool((err <= ASSEMBLY_PARITY * (1 + a.abs())).all())
        out[label] = {"max_abs_err": float(err.max()),
                      "bitwise": torch.equal(a, b)}
        print(f"  {label}: max_abs_err {out[label]['max_abs_err']:.3e} "
              f"bitwise {out[label]['bitwise']} (tol {ASSEMBLY_PARITY:.0e}) "
              f"{'ok' if ok else 'FAIL'}")
        require(ok, f"{label}: momentum_bands differs from the assembly")
    del pairs
    print(f"  launches: {counts}")
    require(counts["momentum_bands"] == 2 and counts["coef_update"] == 2,
            f"baseline launches {counts}")

    def wall(fn, n=3):  # best of n synchronised runs
        best = float("inf")
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best

    out["seconds"] = {
        "plugin main ratio (assemble + update)":
            wall(lambda: plugin(plan30)),
        "refactored coarse (momentum_bands)": wall(lambda: refactored(coarse)),
        "plugin alpha 1 (assemble + update)":
            wall(lambda: plugin(solver.plan_mom)),
        "refactored fine (momentum_bands)": wall(lambda: refactored(mesh)),
    }
    print("  seconds (best of 3, synchronised): " + ", ".join(
        f"{k} {v:.4f}" for k, v in out["seconds"].items()))
    return out


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
              "steps; determinism; parity (then 7-8)")
        torch.cuda.reset_peak_memory_stats()
        summary = main_path(torch)
        print(f"done in {time.perf_counter() - t_start:.1f} s")
        print("summary " + json.dumps(summary))
        # launches: the main path's counts; the momentum-assembly kernel's
        # from the refactoring baseline's run (phase 8)
        launches = dict(summary["launches"],
                        momentum_bands=summary["baseline"]["launches"][
                            "momentum_bands"])
        kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                    "replaces": REPLACES[name],
                    "launches": launches[name],
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
