#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py
  python3 chip_smoke.py --compare LABEL=CSRC_DIR [LABEL=CSRC_DIR ...]
  python3 chip_smoke.py --step-timing REPEATS
  python3 chip_smoke.py --profile-cg ITERS

Runs from the root of a checkout and needs one CUDA card; with no card, or
without the rest of the checkout beside it, it exits nonzero and prints no
result.  Phases, in order (any failure exits nonzero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of every kernel from ``src/repro_torch/csrc`` (``nvcc``, in
   parallel), with its seconds and, per kernel, the registers, stack frame
   and spills ``ptxas -v`` reports; every instantiation of the two DIA SpMV
   kernels and of the axpy kernel must have no stack frame and no spills;
3. each kernel against its plain PyTorch version on the card: the three
   Krylov kernels for every (storage, accum) pair at the main path's two
   shapes and one small ragged shape (``n`` not a multiple of 8), the
   SpMV, SpMV+dot and axpy vectors bitwise, the SpMV+dot's and the axpy
   kernel's per-256-row partials bitwise against ``block_partials_plain``
   (the kernels' tree order) and the axpy wrapper's dots bitwise the sums
   of those; the value-update gather on the real 210^3 plans (pressure,
   alpha 30, and momentum, alpha 1) and a ragged shape, for
   float64/float32/bfloat16, bitwise; the momentum-assembly kernel at the
   coarse and fine 210^3 shapes, float64 and float32.  Then each kernel's
   time at the pressure shape for each dtype pair it runs in (the SpMV
   kernel at the momentum shape too, the SpMV+dot there in f64) beside its
   byte floor, the plain version's time, the host's microseconds per
   wrapper call and, where one PyTorch call computes the same function,
   that call's (a yardstick the port never calls); the axpy kernel is
   also timed alone, raw launches on preallocated outputs.  The device
   loop's kernels and forms: ``cg_direction`` bitwise its plain version
   and the eager ``z + beta.to(z.dtype) * p`` it replaces for every dtype
   pair at the three shapes, unguarded, under a True flag and writing
   nothing under a False one; the axpy kernel's in-place form and the
   guarded SpMV+dot and SpMV likewise; ``cg_advance`` against its plain
   version; ``cg_direction`` timed beside its byte floor (wrapper, alone,
   the eager pair, the plain version, ``torch.add``), the in-place axpy
   alone against the out-of-place one in turns, ``cg_advance``;
4. the main path at full size: 3 PISO steps of the 210^3 cavity, 30 fine
   parts fused with alpha = 30, through the launcher's code path, with the
   kernels: the step's six kernels' launch counters must move (the value
   update 3 times a step; the four CG kernels once per CG iteration: a
   launch under the loop's guard is counted by its kernel on the device,
   and every sweep's device counts must equal its iterations times the
   loop body's launches), every step converge with a continuity error
   below 1e-6, and every sweep of the device loop (route, K, its host
   reads, capture ms printed) read the device at most ``ceil(iterations /
   K) + 4`` times; then (4b) the device
   loop against the former host loop from the main run's state, with the
   kernels: the f64 pressure CG sweep, the three f64 momentum BiCGStab
   sweeps and an ``f32_ir`` pressure solve, ``x`` bitwise and identical
   counts and flags, and the pressure and momentum sweeps timed at
   K = 1, 2, 4, 8, 32 and 128 (ms per iteration, capture ms, host reads);
5. determinism: the kernel run again, step by step, bitwise equal;
6. parity: the plain-PyTorch backend takes each step from the kernel run's
   state (step 0 from the shared initial state) and must agree within
   1e-10 of each field's max, with identical Krylov counts and flags; its
   free run from the initial state is reported and held to the solver
   tolerance (the two backends round their dot products in different
   orders, and a Krylov solve only pins its answer to its tolerance, so
   free runs drift apart at that level); a small mesh on the card is held
   against the port's CPU run; one step is timed phase by phase (a
   synchronisation around each phase), and ``solver.timed_step`` (the
   instrumented executor: CUDA events at the phase boundaries) from the
   same state must give a bitwise equal state and a PhaseBreakdown whose
   total lies within 10 % of that walk's;
7. rebinding: from the main run's state, ``rebind_alpha(15)`` and one
   step, held to the alpha-30 step from the same state (1e-10, identical
   counts and flags); ``rebind_alpha(30)`` then builds nothing;
8. the refactoring baseline: ``momentum_bands`` from the main run's
   velocity on the coarse mesh (1 part) against fine assembly plus the
   alpha-30 value update, and on the fine mesh against the step's own
   momentum bands, within 1e-12; both paths timed;
9. precision on the main path: from the main run's state, one cavity
   step under ``f32_ir`` with the kernels (every solve converged, no cap,
   continuity below 1e-6, the step's kernels launched), beside the f64
   step from the same state (no ``bf16_ir`` on the cavity: the reference
   diverges there);
10. the 210^3 channel (inlet at z0, outlet at z1), 30 parts, alpha 30:
    one PISO step from rest under ``f64``, ``f32_ir`` and ``bf16_ir`` with
    the kernels, each converged with continuity below 1e-6; per policy the
    plain-PyTorch backend from the same state (f64: within 1e-10,
    identical counts and flags; refined: equal flags, within 1e-5, both
    counts printed); then the step's first pressure system solved alone
    under each policy, timed (outer and inner iterations, seconds, ms per
    inner iteration), the f64 outer replays counted as ``spmv_dia``
    launches;
11. SIMPLE on the 210^3 channel: ``run_steady(max_outer=4)`` with the
    kernels (capped, every Krylov solve converged), replayed outer
    iteration by outer iteration (bitwise the same end), each outer
    iteration's continuity error, velocity change and counts printed, and
    the plain backend taking each outer iteration from the kernel run's
    state (within 1e-10, identical counts and flags).

In phases 9-11 every kernel wrapper's plain version is made to raise while
the kernel runs go: the card's path launches the kernels only.

The line before the last is the card's ``nvidia-smi`` name and power
limit, the one before that the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.

With ``--compare``, only phases 1 and 2 run, and then this tree's three
Krylov kernels are built beside those of each other ``csrc`` directory
(another checkout's ``src/repro_torch/csrc``), checked bitwise against the
plain versions, and timed in turns on this card (this tree, the others,
the others again in reverse, this tree) for every (storage, accum) pair:
the two SpMV kernels at the pressure and momentum shapes, the axpy kernel
(raw launches) at the pressure shape; the last line is then the
comparison as JSON.  With ``--step-timing``, only phases 1 and 2 run, and then the main
path's first step from rest, walked phase by phase ``REPEATS`` times after
one untimed step, gives the ms per pressure-CG iteration, and phase 10's
pressure solves alone the ms per inner iteration of each policy; the last
line is those as JSON.  With ``--profile-cg``, only phases 1 and 2 run,
and then the main path's first pressure CG, capped at ``ITERS``
iterations, under ``torch.profiler``: device time per iteration by part
(SpMV+dot, axpy, partial sums, the p update, scalar ops, host reads) and
the device's idle share.  Both modes use only what the port has had since
its fourth slice (the refinement loop and the channel), so a copy of this
script beside another such checkout's ``src`` measures that tree the same
way.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import itertools
import json
import re
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
# the Krylov counts of the main path on the H100 (PERF.md): the SpMV
# kernels compute y and the p.Ap partials bit for bit as their plain
# versions do, so other counts mean the solver, not the speed, changed
MAIN_COUNTS = {"mom_iters": [59, 62, 62],
               "p_iters": [[2125, 2160], [2460, 2486], [2444, 2490]]}
PARITY = 1e-10        # fused vs plain backend, one step from one state,
#                       relative to the field's max
FREE_RUN_DRIFT = 1e-5  # free runs of the two backends: 100x mom_tol
CONTINUITY = 1e-6
# kernel vs plain version, relative to the output's max, per storage dtype
TOLERANCE = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 2e-2}
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
L2_BYTES = 50 * 2 ** 20             # H100 SXM L2
FLOPS_PER_S = {"float64": 34e12,    # FP64 outside the tensor cores
               "float32": 67e12, "bfloat16": 67e12}
SOURCES = {"spmv_dia": "src/repro_torch/csrc/spmv_dia.cu",
           "spmv_dot": "src/repro_torch/csrc/krylov_fused.cu",
           "axpy_precond": "src/repro_torch/csrc/krylov_fused.cu",
           "coef_update": "src/repro_torch/csrc/coef_update.cu",
           "momentum_bands": "src/repro_torch/csrc/stencil_assembly.cu",
           "cg_direction": "src/repro_torch/csrc/krylov_loop.cu",
           "cg_advance": "src/repro_torch/csrc/krylov_loop.cu"}
REPLACES = {"spmv_dia": "src/repro/kernels/spmv_dia/spmv_dia.py:53",
            "spmv_dot": "src/repro/kernels/krylov_fused/krylov_fused.py:118",
            "axpy_precond":
                "src/repro/kernels/krylov_fused/krylov_fused.py:189",
            "coef_update": "src/repro/kernels/coef_update/coef_update.py:37",
            "momentum_bands": "src/repro/kernels/stencil_assembly/"
                              "stencil_assembly.py:74",
            # port-only kernels: no TPU kernel does this work; the JAX
            # solver lines they replace
            "cg_direction": "src/repro/solvers/cg.py:74",
            "cg_advance": "src/repro/solvers/cg.py:78"}
# the guarded launches one iteration of each device loop makes: every
# sweep's device counters must read these times its iterations
LOOP_LAUNCHES = {"cg": {"spmv_dot": 1, "axpy_precond": 1, "cg_direction": 1,
                        "cg_advance": 1},
                 "bicgstab": {"spmv_dia": 2}}
# the kernels a PISO step launches; the momentum-assembly kernel belongs to
# the refactoring baseline's entry point (phase 8)
STEP_KERNELS = ("spmv_dia", "spmv_dot", "axpy_precond", "coef_update",
                "cg_direction", "cg_advance")
# kernels whose every instantiation must compile without a stack frame or
# spills (ptxas -v): the SpMV kernels read the band offsets at compile-time
# indices, the axpy kernel indexes its row arrays at compile-time indices
NO_FRAME_KERNELS = ("spmv_dia_kernel", "spmv_dot_kernel",
                    "axpy_precond_kernel")
# ... and, since the device-resident loop, the axpy kernel's in-place form
# and the CG direction update
LOOP_NO_FRAME_KERNELS = ("axpy_precond_inplace_kernel", "cg_direction_kernel")
ASSEMBLY_PARITY = 1e-12  # momentum_bands vs assembly + update, elementwise
#                          rtol = atol (tests/test_kernels.py's bar)
# the policies whose 210^3 channel step must converge.  bf16_ir refines
# with bfloat16 bands (eps 4e-3) on a matrix whose condition number grows
# as n^2: at 210^3 its pressure CG stops at the outer cap (48 passes) on
# the kernels and on the plain backend alike, as the JAX reference's
# bf16_ir already fails on this channel at 16^3
# (tests/test_torch_precision.py); it is run, held to the plain backend's
# verdict and reported.
MUST_CONVERGE = ("f64", "f32_ir")


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
# phase 2: the build
# ---------------------------------------------------------------------------

_PTXAS_FUNCTION = re.compile(
    r"(?:Compiling entry function|Function properties for) '?([\w$.]+)'?")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGISTERS = re.compile(r"Used (\d+) registers")


def ptxas_report(log: str) -> dict:
    """``{function: {"stack", "spill_stores", "spill_loads", "registers"}}``
    (bytes, and registers per thread) from ``nvcc -Xptxas -v`` text; the
    function names are as ``ptxas`` prints them (mangled)."""
    out, name = {}, None
    for line in log.splitlines():
        m = _PTXAS_FUNCTION.search(line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = _PTXAS_FRAME.search(line)
        if m:
            out[name].update(zip(("stack", "spill_stores", "spill_loads"),
                                 map(int, m.groups())))
        m = _PTXAS_REGISTERS.search(line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def base_name(mangled: str) -> str:
    """The unqualified function name of an Itanium-mangled name
    (``_Z15spmv_dia_kernelIddLi7EE...`` -> ``spmv_dia_kernel``)."""
    m = re.match(r"_Z(\d+)", mangled)
    return mangled[m.end():m.end() + int(m.group(1))] if m else mangled


def check_frames(report: dict, kernels=NO_FRAME_KERNELS) -> dict:
    """Require every instantiation of ``kernels`` in a :func:`ptxas_report`
    to have a complete record with no stack frame and no spills; returns
    ``{kernel: number of instantiations}``."""
    counts = {k: 0 for k in kernels}
    for fn, rec in report.items():
        k = base_name(fn)
        if k not in counts:
            continue
        counts[k] += 1
        require(all(f in rec for f in ("stack", "spill_stores",
                                       "spill_loads")),
                f"ptxas printed no frame line for {fn}")
        require(rec["stack"] == rec["spill_stores"] == rec["spill_loads"] == 0,
                f"{fn}: {rec['stack']} bytes stack frame, "
                f"{rec['spill_stores']}/{rec['spill_loads']} bytes spilled")
    require(all(counts.values()), f"ptxas reported no instance of some of "
                                  f"{kernels}: {counts}")
    return counts


def print_record(label: str, fn: str, rec: dict) -> None:
    print(f"  {label}: {fn} {rec.get('registers')} registers, "
          f"{rec.get('stack')} B stack, {rec.get('spill_stores')}/"
          f"{rec.get('spill_loads')} B spill stores/loads")


def build_phase() -> None:
    """Phase 2: build, print each kernel's ptxas record, check the frames."""
    from repro_torch.kernels._build import build_all

    info = build_all()
    print(f"  built {info['built'] or 'nothing (cached)'} in "
          f"{info['seconds']:.1f} s")
    records = {}
    for src, log in info["ptxas"].items():
        for fn, rec in ptxas_report(log).items():
            records[fn] = rec
            if "registers" in rec:
                print_record(src, fn, rec)
    # a tree from before the device loop (timed by a copy of this script)
    # has neither the in-place axpy nor krylov_loop.cu
    from repro_torch.kernels._build import SOURCES as built
    kernels = NO_FRAME_KERNELS + (LOOP_NO_FRAME_KERNELS
                                  if "krylov_loop" in built else ())
    counts = check_frames(records, kernels)
    print(f"  no stack frame, no spills: {counts} instantiations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def shapes() -> list:
    """(label, P, m, nx, plane): the pressure and momentum systems of the
    main path, and a ragged shape (P*m not a multiple of 256)."""
    return [("pressure", PARTS // ALPHA, N ** 3 * ALPHA // PARTS, N, N ** 2),
            ("momentum", PARTS, N ** 3 // PARTS, N, N ** 2),
            ("ragged", 3, 777, 4, 16)]


def policy_pairs() -> list:
    """(storage, accum) of every precision policy: f64, f32_ir, bf16_ir."""
    from repro_torch.solvers.precision import POLICIES

    return [(p.storage_dtype, p.accum_dtype) for p in POLICIES.values()]


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


AXPY_OPERANDS = ("x", "r", "p", "Ap", "inv")


def plain_versions() -> dict:
    """{kernel: plain PyTorch version} of the three Krylov kernels."""
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        fused_axpy_precond_plain, spmv_dot_plain)
    from repro_torch.kernels.spmv_dia.spmv_dia import spmv_dia_plain

    return {"spmv_dia": spmv_dia_plain, "spmv_dot": spmv_dot_plain,
            "axpy_precond": fused_axpy_precond_plain}


def kernel_calls(kernels, plain, inputs, offsets, plane, storage, accum):
    """{kernel: (kernel call, plain call)} on ``inputs`` cast to storage."""
    b = inputs["bands"].to(storage)
    x = inputs["x"].to(storage)
    vecs = [inputs[k].to(storage) for k in AXPY_OPERANDS]
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


def axpy_launcher(torch, lib, vecs, alpha, accum):
    """Raw launches of a loaded ``krylov_fused`` library's
    ``axpy_precond_launch`` into preallocated outputs (no check, no
    allocation, no sum, no launch count): a function that launches once and
    returns ``(x', r', z, rz_partials, rr_partials)``."""
    from repro_torch.kernels._build import dtype_code
    from repro_torch.kernels.spmv_dia.spmv_dia import (KERNEL_BLOCK_ROWS,
                                                       stream_ptr)

    x = vecs[0]
    n = x.numel()
    outs = [torch.empty_like(x) for _ in range(3)] + [
        torch.empty(-(-n // KERNEL_BLOCK_ROWS), dtype=accum, device=x.device)
        for _ in range(2)]
    a = alpha.to(accum)
    args = (dtype_code(x.dtype, accum), *(v.data_ptr() for v in vecs),
            a.data_ptr(), *(o.data_ptr() for o in outs), n, stream_ptr(x))

    def launch(_operands=(a, *vecs)):
        rc = lib.axpy_precond_launch(*args)
        require(rc == 0, f"axpy_precond launch failed ({rc})")
        return outs
    return launch


def axpy_inplace_launchers(torch, vecs, alpha, accum):
    """The axpy kernel in the form the CG loop calls it, on copies of ``x``
    and ``r`` that it updates in place: ``(wrapper, raw, partials)`` —
    ``fused_update_step_into`` (the in-place launch and the two
    ``torch.sum`` of the partials into fixed buffers), a raw launch of
    ``axpy_precond_inplace_launch`` (no check, no sum, no launch count),
    and the two partial rows both write."""
    from repro_torch.kernels._build import dtype_code, load
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        fused_update_step_into, partials_buffers)
    from repro_torch.kernels.spmv_dia.spmv_dia import stream_ptr

    x, r = vecs[0].clone(), vecs[1].clone()
    n = x.numel()
    z = torch.empty_like(x)
    part = partials_buffers(n, accum, x.device)
    rz, rr = (torch.empty((), dtype=accum, device=x.device) for _ in "ab")
    a = alpha.to(accum)
    lib = load("krylov_fused")
    args = (dtype_code(x.dtype, accum), x.data_ptr(), r.data_ptr(),
            *(v.data_ptr() for v in vecs[2:]), a.data_ptr(), z.data_ptr(),
            part["rz"].data_ptr(), part["rr"].data_ptr(), n, 0, 0,
            stream_ptr(x))

    def wrapper():
        fused_update_step_into(x, r, *vecs[2:], a, z, rz, rr, part,
                               accum_dtype=accum)

    def raw(_keep=(x, r, z, a, part, *vecs)):
        rc = lib.axpy_precond_inplace_launch(*args)
        require(rc == 0, f"axpy_precond in-place launch failed ({rc})")

    return wrapper, raw, (part["rz"], part["rr"])


def spmv_launcher(torch, name, bands, x, offsets, accum):
    """Raw launches of this tree's ``spmv_dia_launch`` or
    ``spmv_dot_launch`` (``name``: "spmv_dia" or "spmv_dot") into
    preallocated outputs: a function that launches once."""
    from repro_torch.kernels._build import dtype_code, load
    from repro_torch.kernels.spmv_dia.spmv_dia import (KERNEL_BLOCK_ROWS,
                                                       _offsets_arg,
                                                       stream_ptr)

    P, nb, m = bands.shape
    y = torch.empty_like(x)
    part = torch.empty(-(-P * m // KERNEL_BLOCK_ROWS), dtype=accum,
                       device=x.device)
    head = (dtype_code(bands.dtype, accum), bands.data_ptr(), x.data_ptr(),
            y.data_ptr())
    tail = (P, m, _offsets_arg(offsets), nb, stream_ptr(x))
    if name == "spmv_dia":
        fn, args = load("spmv_dia").spmv_dia_launch, head + tail
    else:
        fn = load("krylov_fused").spmv_dot_launch
        args = head + (part.data_ptr(),) + tail

    def launch(_keep=(bands, x, y, part)):
        rc = fn(*args)
        require(rc == 0, f"{name} launch failed ({rc})")
    return launch


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


def host_us(torch, fn, n=20) -> float:
    """Host microseconds per call of ``fn``, called back to back with no
    synchronisation: above the card's time per call, the host and not the
    card bounds what :func:`time_ms` reads."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * secs / n


def csr_of_bands(torch, bands, offsets):
    """The (n, n) CSR matrix of stacked DIA bands (P, nb, m) on the flat
    vector, n = P*m: what the kernels compute, halos included."""
    P, nb, m = bands.shape
    n = P * m
    vals = bands.permute(1, 0, 2).reshape(nb, n)
    rows = torch.arange(n, device=bands.device)
    cols = rows[:, None] + torch.tensor(offsets, device=bands.device)[None, :]
    valid = (cols >= 0) & (cols < n)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=bands.device)
    crow[1:] = torch.cumsum(valid.sum(dim=1), dim=0)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, cols[valid], vals.T[valid],
                                       size=(n, n), check_invariants=False)


def check_spmv_bitwise(torch, label, sname, y_dia, y_dot, part, y_want,
                       part_want) -> None:
    """The two SpMV kernels' vectors and the SpMV+dot's partials against
    ``spmv_dot_partials_plain``, bit for bit."""
    same = {"spmv_dia y": torch.equal(y_dia, y_want),
            "spmv_dot y": torch.equal(y_dot, y_want),
            "spmv_dot partials": part.shape == part_want.shape
            and torch.equal(part, part_want)}
    print(f"  bitwise {label:9s} {sname:8s}: "
          + ", ".join(f"{k} {v}" for k, v in same.items()))
    require(all(same.values()), f"not bitwise at {label} {sname}: {same}")


def axpy_bitwise(torch, part_out, wrap_out, want) -> dict:
    """The axpy kernel against ``axpy_precond_partials_plain``'s ``want``
    (x', r', z, r.z partials, r.r partials), bit for bit: ``part_out`` is
    ``axpy_precond_partials``'s five outputs, ``wrap_out`` the wrapper's
    (x', r', z, r.z, r.r), whose dots must be ``torch.sum`` of ``want``'s
    partials.  ``{output: equal}``."""
    same = {name: torch.equal(part_out[i], want[i])
            and torch.equal(wrap_out[i], want[i])
            for i, name in enumerate(("x'", "r'", "z"))}
    for i, name in ((3, "r.z"), (4, "r.r")):
        same[f"{name} partials"] = torch.equal(part_out[i], want[i])
        same[name] = torch.equal(wrap_out[i], want[i].sum())
    return same


def check_kernels(torch, dev) -> dict:
    from repro_torch.kernels import WRAPPERS
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        axpy_precond_partials, axpy_precond_partials_plain,
        spmv_dot_partials, spmv_dot_partials_plain)

    plain = plain_versions()
    pairs = policy_pairs()
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {name: {} for name in plain}
    for label, P, m, nx, plane in shapes():
        inputs = make_inputs(torch, P, m, gen, dev)
        offsets = offsets_for(nx, plane)
        for storage, accum in pairs:
            sname = str(storage).removeprefix("torch.")
            calls = kernel_calls(WRAPPERS, plain, inputs, offsets, plane,
                                 storage, accum)
            got_all = {}
            for name, (k_fn, p_fn) in calls.items():
                got = got_all[name] = k_fn()
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
            b, x = inputs["bands"].to(storage), inputs["x"].to(storage)
            kw = dict(offsets=offsets, plane=plane, accum_dtype=accum)
            _, part = spmv_dot_partials(b, x, **kw)
            check_spmv_bitwise(torch, label, sname, got_all["spmv_dia"][0],
                               got_all["spmv_dot"][0], part,
                               *spmv_dot_partials_plain(b, x, **kw))
            vecs = [inputs[k].to(storage) for k in AXPY_OPERANDS]
            alpha = inputs["alpha"].to(accum)
            same = axpy_bitwise(
                torch, axpy_precond_partials(*vecs, alpha, accum_dtype=accum),
                got_all["axpy_precond"],
                axpy_precond_partials_plain(*vecs, alpha, accum_dtype=accum))
            print(f"  bitwise {label:9s} {sname:8s}: axpy_precond "
                  + ", ".join(f"{k} {v}" for k, v in same.items()))
            require(all(same.values()),
                    f"axpy_precond not bitwise at {label} {sname}: {same}")
            del got_all, part, b, x, vecs
        if label != "ragged":
            time_kernels(torch, label, inputs, offsets, plane, pairs, report)
        del inputs
        torch.cuda.empty_cache()
    report["coef_update"] = check_coef_update(torch, dev)
    torch.cuda.empty_cache()
    report["momentum_bands"] = check_momentum_bands(torch, dev)
    torch.cuda.empty_cache()
    check_loop_kernels(torch, dev, report)
    torch.cuda.empty_cache()
    return report


def check_loop_kernels(torch, dev, report: dict) -> None:
    """The device loop's kernels and forms on the card, for every dtype pair
    at the three shapes: ``cg_direction`` bitwise its plain version and the
    eager pair it replaces (``z + beta.to(z.dtype) * p``), unguarded and
    under a True flag, and writing nothing under a False one; the axpy
    kernel's in-place form, the guarded SpMV+dot and SpMV likewise;
    ``cg_advance`` against its plain version.  Then, at the pressure shape,
    ``cg_direction`` timed (wrapper, alone, the eager pair, the plain
    version, ``torch.add(z, p, alpha=beta)``) beside its byte floor, the
    in-place axpy alone against the out-of-place one in turns, and
    ``cg_advance``; the entries go into ``report``."""
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        axpy_precond_inplace, axpy_precond_partials_plain, spmv_dot_partials)
    from repro_torch.kernels.krylov_loop.krylov_loop import (
        cg_advance, cg_advance_plain, cg_direction, cg_direction_plain)
    from repro_torch.kernels.spmv_dia.spmv_dia import (KERNEL_BLOCK_ROWS,
                                                       spmv_dia_stacked)

    gen = torch.Generator(device=dev).manual_seed(3)
    on = torch.ones((), dtype=torch.bool, device=dev)
    off = torch.zeros((), dtype=torch.bool, device=dev)
    report["cg_direction"] = {"max_abs_err": 0.0}
    report["cg_advance"] = {"max_abs_err": 0.0}
    for label, P, m, nx, plane in shapes():
        inputs = make_inputs(torch, P, m, gen, dev)
        offsets = offsets_for(nx, plane)
        for storage, accum in policy_pairs():
            sname = str(storage).removeprefix("torch.")
            p0, z = inputs["p"].to(storage), inputs["r"].to(storage)
            g_new = torch.tensor(0.37, dtype=accum, device=dev)
            g = torch.tensor(0.91, dtype=accum, device=dev)
            want = cg_direction_plain(p0.clone(), z, g_new, g)
            same = {"eager pair": torch.equal(
                want, z + (g_new / g).to(storage) * p0)}
            for tag, flag in (("unguarded", None), ("active", on)):
                p = p0.clone()
                cg_direction(p, z, g_new, g, flag)
                same[tag] = torch.equal(p, want)
            p = p0.clone()
            cg_direction(p, z, g_new, g, off)
            same["idle writes nothing"] = torch.equal(p, p0)
            print(f"  bitwise {label:9s} {sname:8s}: cg_direction "
                  + ", ".join(f"{k} {v}" for k, v in same.items()))
            require(all(same.values()),
                    f"cg_direction not bitwise at {label} {sname}: {same}")

            vecs = [inputs[k].to(storage) for k in AXPY_OPERANDS]
            alpha = inputs["alpha"].to(accum)
            want = axpy_precond_partials_plain(*vecs, alpha,
                                               accum_dtype=accum)
            nb = -(-vecs[0].numel() // KERNEL_BLOCK_ROWS)
            same = {}
            for tag, flag in (("active", on), ("idle", off)):
                x, r = vecs[0].clone(), vecs[1].clone()
                outs = [torch.zeros_like(x)] + [
                    torch.zeros(nb, dtype=accum, device=dev)
                    for _ in range(2)]
                axpy_precond_inplace(x, r, *vecs[2:], alpha, *outs,
                                     accum_dtype=accum, active=flag)
                if flag is on:
                    same[tag] = all(torch.equal(a, b) for a, b in zip(
                        (x, r, *outs), want))
                else:
                    same["idle writes nothing"] = (
                        torch.equal(x, vecs[0]) and torch.equal(r, vecs[1])
                        and not any(bool(o.any()) for o in outs))
            b, xx = inputs["bands"].to(storage), inputs["x"].to(storage)
            kw = dict(offsets=offsets, plane=plane, accum_dtype=accum)
            y_w, part_w = spmv_dot_partials(b, xx, **kw)
            ys_w = spmv_dia_stacked(b, xx, **kw)
            for tag, flag in (("active", on), ("idle", off)):
                y, part, ys = (torch.full_like(t, 7.0)
                               for t in (y_w, part_w, ys_w))
                spmv_dot_partials(b, xx, **kw, out=(y, part), active=flag)
                spmv_dia_stacked(b, xx, **kw, out=ys, active=flag)
                if flag is on:
                    same[f"spmv {tag}"] = (torch.equal(y, y_w)
                                           and torch.equal(part, part_w)
                                           and torch.equal(ys, ys_w))
                else:
                    same["spmv idle writes nothing"] = all(
                        bool((t == 7.0).all()) for t in (y, part, ys))
            print(f"  bitwise {label:9s} {sname:8s}: axpy in place, guarded "
                  "SpMVs: " + ", ".join(f"{k} {v}" for k, v in same.items()))
            require(all(same.values()), f"the in-place axpy or a guarded SpMV "
                                        f"is wrong at {label} {sname}: {same}")
            if label == "pressure":
                time_loop_kernels(torch, dev, report, sname, storage, accum,
                                  p0, z, g_new, g, vecs, alpha)
            del p0, z, vecs, want, b, xx, y_w, part_w, ys_w
        del inputs
        torch.cuda.empty_cache()
    # cg_advance against its plain version: running, converging, capped,
    # NaN, and under a False flag
    for acc in (torch.float64, torch.float32):
        for rr_new, k0, flag0 in ((2.0, 0, True), (0.5, 3, True),
                                  (2.0, 8, True), (float("nan"), 0, True),
                                  (2.0, 0, False)):
            runs = []
            for fn in (cg_advance, cg_advance_plain):
                sc = [torch.tensor(v, dtype=acc, device=dev)
                      for v in (1.5, 2.5, 3.5, rr_new)]
                k = torch.tensor(k0, dtype=torch.int32, device=dev)
                flag = torch.tensor(flag0, device=dev)
                fn(*sc, k, flag, torch.tensor(1.0, dtype=acc, device=dev), 9)
                runs.append([t.tolist() for t in (*sc, k, flag)])
            require(str(runs[0]) == str(runs[1]),
                    f"cg_advance {acc} differs from its plain version: {runs}")
    print("  cg_advance == its plain version (running, converging, capped, "
          "NaN, idle; float64 and float32)")


def time_loop_kernels(torch, dev, report, sname, storage, accum, p, z, g_new,
                      g, vecs, alpha) -> None:
    """Phase 3's times of the loop kernels at the pressure shape.

    ``cg_direction`` moves 3 values a row, and a (p, z) pair in bf16 or f32
    (37 or 74 MB) could stay in the 50 MB L2 from one call to the next: its
    calls rotate through copies of the pair, three times the L2 in all, so
    that each call reads from HBM."""
    from repro_torch.kernels._build import dtype_code, load
    from repro_torch.kernels.krylov_loop.krylov_loop import (
        cg_advance, cg_advance_cost, cg_advance_plain, cg_direction,
        cg_direction_cost, cg_direction_plain)
    from repro_torch.kernels.spmv_dia.spmv_dia import stream_ptr

    n, size = p.numel(), p.element_size()
    lib = load("krylov_loop")
    code = dtype_code(storage, accum)
    beta = float((g_new / g).to(storage))
    n_sets = max(2, -(-3 * L2_BYTES // (2 * n * size)))
    sets = [(p.clone(), z.clone()) for _ in range(n_sets)]
    turn = itertools.cycle(sets)

    def raw():
        p_, z_ = next(turn)
        rc = lib.cg_direction_launch(code, p_.data_ptr(), z_.data_ptr(),
                                     g_new.data_ptr(), g.data_ptr(), n, 0, 0,
                                     stream_ptr(p_))
        require(rc == 0, f"cg_direction launch failed ({rc})")

    def rotating(fn):
        return lambda: fn(*next(turn))

    rep = timing_report(
        torch, f"cg_direction @pressure {sname}",
        rotating(lambda p_, z_: cg_direction(p_, z_, g_new, g)),
        rotating(lambda p_, z_: cg_direction_plain(p_, z_, g_new, g)),
        cg_direction_cost(n, size),
        library=rotating(lambda p_, z_: torch.add(z_, p_, alpha=beta)),
        dtype=sname, raw=raw)
    rep["eager_pair_ms"] = time_ms(torch, rotating(
        lambda p_, z_: z_ + (g_new / g).to(storage) * p_))
    rep["l2_rotation"] = n_sets
    print(f"    the eager pair it replaces (z + beta.to(z.dtype) * p): "
          f"{rep['eager_pair_ms']:.4f} ms; every call on the next of "
          f"{n_sets} (p, z) copies")
    del sets, turn
    slot = report["cg_direction"]
    if storage == torch.float64:
        slot.update(rep)
    else:
        slot[sname] = rep

    # the axpy kernel alone: in place (the loop's) against out of place
    fns = {"out of place": axpy_launcher(torch, load("krylov_fused"), vecs,
                                         alpha, accum),
           "in place": axpy_inplace_launchers(torch, vecs, alpha, accum)[1]}
    times = {k: [] for k in fns}
    for k in ("out of place", "in place", "in place", "out of place"):
        times[k].append(time_ms(torch, fns[k]))
    means = {k: sum(v) / len(v) for k, v in times.items()}
    slot = report["axpy_precond"]
    if storage != torch.float64:
        slot = slot[sname]
    slot["inplace_alone"] = {"alone_ms": times, "mean_ms": means}
    print(f"    axpy_precond alone, in turns: out of place "
          f"{' '.join(f'{t:.4f}' for t in times['out of place'])}, in place "
          f"{' '.join(f'{t:.4f}' for t in times['in place'])} ms")

    if storage == torch.bfloat16:  # the guard has f32's accum dtype
        return
    sc = [torch.tensor(v, dtype=accum, device=dev) for v in (1., 1., 1., 1.)]
    k = torch.zeros((), dtype=torch.int32, device=dev)
    flag = torch.ones((), dtype=torch.bool, device=dev)
    thr = torch.zeros((), dtype=accum, device=dev)
    adv = timing_report(
        torch, f"cg_advance {str(accum).removeprefix('torch.')}",
        lambda: cg_advance(*sc, k, flag, thr, 2 ** 30),
        lambda: cg_advance_plain(*sc, k, flag, thr, 2 ** 30),
        cg_advance_cost(torch.finfo(accum).bits // 8), dtype=sname)
    if storage == torch.float64:
        report["cg_advance"].update(adv)
    else:
        report["cg_advance"][sname] = adv


def time_kernels(torch, label, inputs, offsets, plane, pairs, report) -> None:
    """The Krylov kernels' times at ``label``'s shape (inputs far above the
    50 MB L2) for every (storage, accum) pair, the floor at that storage
    width: all three at the pressure shape (``report[kernel]`` for f64,
    ``report[kernel][storage name]`` for the others), the SpMV kernel and,
    in f64, the SpMV+dot at the momentum shape
    (``report[kernel]["momentum"]``, the same way).  The axpy kernel is
    timed in the in-place form the CG loop launches, the out-of-place form
    beside it (``out_of_place``)."""
    from repro_torch.kernels import WRAPPERS
    from repro_torch.kernels._build import load
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        fused_axpy_precond_cost, spmv_dot_cost)
    from repro_torch.kernels.spmv_dia.spmv_dia import (KERNEL_BLOCK_ROWS,
                                                       spmv_dia_cost)

    P, _, m = inputs["bands"].shape
    n = P * m
    for storage, accum in pairs:
        sname = str(storage).removeprefix("torch.")
        size, acc = (torch.finfo(t).bits // 8 for t in (storage, accum))
        costs = {
            "spmv_dia": spmv_dia_cost(7, n, size),
            "spmv_dot": spmv_dot_cost(7, n, 0, size,
                                      block_rows=KERNEL_BLOCK_ROWS,
                                      accum_itemsize=acc),
            "axpy_precond": fused_axpy_precond_cost(
                n, size, block_rows=KERNEL_BLOCK_ROWS, accum_itemsize=acc),
        }
        calls = kernel_calls(WRAPPERS, plain_versions(), inputs, offsets,
                             plane, storage, accum)
        if label != "pressure":
            calls = {k: calls[k] for k in (
                ("spmv_dia", "spmv_dot") if storage == torch.float64
                else ("spmv_dia",))}
        # the SpMV's yardstick: a torch.sparse CSR product in its dtype
        csr = csr_of_bands(torch, inputs["bands"].to(storage), offsets)
        x_flat = inputs["x"].to(storage).reshape(-1)
        for name, (k_fn, p_fn) in calls.items():
            if name == "axpy_precond":
                # the form the CG loop launches: x and r in place, into
                # fixed buffers; the out-of-place wrapper and kernel (off
                # the loop's path) are timed beside it for comparison
                vecs = [inputs[k].to(storage) for k in AXPY_OPERANDS]
                oop_fn = k_fn
                oop_raw = axpy_launcher(torch, load("krylov_fused"), vecs,
                                        inputs["alpha"], accum)
                k_fn, raw, part = axpy_inplace_launchers(
                    torch, vecs, inputs["alpha"], accum)
            else:
                raw = spmv_launcher(torch, name, inputs["bands"].to(storage),
                                    inputs["x"].to(storage), offsets, accum)
            rep = timing_report(
                torch, f"{name} @{label} {sname}", k_fn, p_fn, costs[name],
                (lambda: csr @ x_flat) if name == "spmv_dia" else None,
                dtype=sname, raw=raw)
            if name == "axpy_precond":
                rep["out_of_place"] = {
                    "ms": time_ms(torch, oop_fn),
                    "kernel_alone_ms": time_ms(torch, oop_raw)}
                print(f"    out of place (off the loop's path): wrapper "
                      f"{rep['out_of_place']['ms']:.4f} ms, alone "
                      f"{rep['out_of_place']['kernel_alone_ms']:.4f} ms")
                # the wrapper's two torch.sum of the partials, alone
                sums = lambda: (part[0].sum(), part[1].sum())  # noqa: E731
                rep["sums_ms"] = time_ms(torch, sums)
                rep["sums_host_us"] = host_us(torch, sums)
                print(f"    its two torch.sum of the partials: "
                      f"{rep['sums_ms']:.4f} ms, host_us "
                      f"{rep['sums_host_us']:.1f}")
            slot = report[name]
            if label != "pressure":
                slot = slot.setdefault(label, {})
            if storage == torch.float64:
                slot.update(rep)
            else:
                slot[sname] = rep
        del csr, x_flat, calls


def timing_report(torch, name, k_fn, p_fn, cost, library=None,
                  dtype="float64", raw=None) -> dict:
    """Kernel (wrapper), plain and library times (CUDA events) beside the
    bound, and the host's microseconds per wrapper call; with ``raw``, a
    launch of the kernel alone, its time too."""
    t_bytes = cost["bytes_accessed"] / HBM_BYTES_PER_S * 1e3
    t_ops = cost["flops"] / FLOPS_PER_S[dtype] * 1e3
    rep = {"ms": time_ms(torch, k_fn), "plain_ms": time_ms(torch, p_fn),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None if library is None else time_ms(torch, library),
           "bytes": cost["bytes_accessed"], "host_us": host_us(torch, k_fn)}
    alone = ""
    if raw is not None:
        rep["kernel_alone_ms"] = time_ms(torch, raw)
        rep["kernel_alone_host_us"] = host_us(torch, raw)
        alone = (f" kernel_alone_ms={rep['kernel_alone_ms']:.4f} "
                 f"(host_us {rep['kernel_alone_host_us']:.1f})")
    print(f"  {name:22s} ms={rep['ms']:.4f}{alone} "
          f"plain_ms={rep['plain_ms']:.4f} bound_ms={rep['bound_ms']:.4f} "
          f"({rep['bound_by']}, {rep['bytes']} B; "
          f"{rep['bound_ms'] / rep['ms']:.1%} of floor) "
          f"library_ms={rep['library_ms']} host_us={rep['host_us']:.1f}")
    return rep


def check_coef_update(torch, dev) -> dict:
    """The value-update gather on the real 210^3 plans: bitwise equal to
    its plain version (a gather does no arithmetic) for every dtype."""
    from repro_torch.core.repartition import plan_for_mesh
    from repro_torch.fvm.mesh import CavityMesh
    from repro_torch.kernels._build import load
    from repro_torch.kernels.coef_update.coef_update import (
        coef_update_cost, coef_update_plain, coef_update_stacked)
    from repro_torch.kernels.spmv_dia.spmv_dia import stream_ptr

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
            out = torch.empty((n_c, n_out), dtype=buf64.dtype, device=dev)
            lib = load("coef_update")

            def raw():
                rc = lib.coef_update_launch(
                    buf64.element_size(), buf64.data_ptr(), src.data_ptr(),
                    out.data_ptr(), n_c, n_buf, n_out, stream_ptr(buf64))
                require(rc == 0, f"coef_update launch failed ({rc})")

            rep.update(timing_report(
                torch, "coef_update", lambda: coef_update_stacked(buf64, src),
                lambda: coef_update_plain(buf64, src),
                coef_update_cost(n_c, n_buf, n_out),
                library=lambda: torch.index_select(buf64, 1, src), raw=raw))
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
    from repro_torch.kernels._build import DTYPE_CODES, load
    from repro_torch.kernels.spmv_dia.spmv_dia import stream_ptr
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
            out = torch.empty((P, 7, m), dtype=torch.float64, device=dev)
            lib = load("stencil_assembly")

            def raw():
                rc = lib.momentum_bands_launch(
                    DTYPE_CODES[(torch.float64, torch.float64)],
                    *(f.data_ptr() for f in faces64), out.data_ptr(), P, m,
                    nx, plane, float(kw["vdt"]), stream_ptr(out))
                require(rc == 0, f"momentum_bands launch failed ({rc})")

            rep.update(timing_report(
                torch, "momentum_bands",
                lambda: momentum_bands_stacked(*faces64, **kw),
                lambda: momentum_bands_plain(*faces64, **kw),
                momentum_bands_cost(P * m), raw=raw))
        del faces64
    return rep


# ---------------------------------------------------------------------------
# --compare: this tree's Krylov kernels beside another checkout's
# ---------------------------------------------------------------------------

def compare_builds(torch, dev, others: dict) -> dict:
    """This tree's three Krylov kernels beside those of each csrc directory
    in ``others`` (``{label: dir}``) on this card: each bitwise against the
    plain versions, then timed in turns (this tree, the others, the others
    in reverse, this tree) for every (storage, accum) pair: the two SpMV
    kernels at the pressure and momentum shapes, the axpy kernel (raw
    launches) at the pressure shape."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels._build import (BUILD_ROOT, build_sources,
                                            dtype_code, load, load_library)
    from repro_torch.kernels.krylov_fused.krylov_fused import (
        axpy_precond_partials_plain, fused_axpy_precond_cost, spmv_dot_cost,
        spmv_dot_partials_plain)
    from repro_torch.kernels.spmv_dia.spmv_dia import (KERNEL_BLOCK_ROWS,
                                                       _offsets_arg,
                                                       spmv_dia_cost,
                                                       stream_ptr)

    names = ("spmv_dia", "krylov_fused")
    kernels = ("spmv_dia", "spmv_dot", "axpy_precond")

    def build(label, csrc):
        csrc = Path(csrc)
        h = hashlib.sha256()
        for f in sorted(csrc.iterdir()):
            if f.suffix in (".cu", ".cuh"):
                h.update(f.name.encode() + f.read_bytes())
        out = BUILD_ROOT.parent / "compare" / f"{label}-{h.hexdigest()[:12]}"
        info = build_sources(csrc, names, out)
        return {n: load_library(out / f"lib{n}.so", n) for n in names}, info

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max(len(others), 1)) as pool:
        built = dict(zip(others, pool.map(lambda kv: build(*kv),
                                          others.items())))
    print(f"  built {list(others)} in {time.perf_counter() - t0:.1f} s")
    libs = {"tree": {n: load(n) for n in names}}
    for label, (lib, info) in built.items():
        libs[label] = lib
        for log in info["ptxas"].values():
            for fn, rec in ptxas_report(log).items():
                if base_name(fn) in NO_FRAME_KERNELS:
                    print_record(label, fn, rec)

    def spmv(lib, code, b, x, offsets):
        P, nb, m = b.shape
        y = torch.empty_like(x)
        rc = lib["spmv_dia"].spmv_dia_launch(
            code, b.data_ptr(), x.data_ptr(), y.data_ptr(), P, m,
            _offsets_arg(offsets), nb, stream_ptr(x))
        require(rc == 0, f"spmv_dia launch failed ({rc})")
        return y

    def spmv_dot(lib, code, b, x, offsets, accum):
        P, nb, m = b.shape
        y = torch.empty_like(x)
        part = torch.empty(-(-P * m // KERNEL_BLOCK_ROWS), dtype=accum,
                           device=x.device)
        rc = lib["krylov_fused"].spmv_dot_launch(
            code, b.data_ptr(), x.data_ptr(), y.data_ptr(), part.data_ptr(),
            P, m, _offsets_arg(offsets), nb, stream_ptr(x))
        require(rc == 0, f"spmv_dot launch failed ({rc})")
        return y, part

    gen = torch.Generator(device=dev).manual_seed(0)
    order = list(libs) + list(libs)[::-1]
    result = {label: {k: {} for k in kernels} for label in libs}
    result["bound_ms"] = {k: {} for k in kernels}

    def in_turns(kernel, cell, fns, cost):
        bound = cost["bytes_accessed"] / HBM_BYTES_PER_S * 1e3
        result["bound_ms"][kernel][cell] = bound
        for label in order:
            t = time_ms(torch, fns[label])
            result[label][kernel].setdefault(cell, []).append(t)
        for label in libs:
            ts = result[label][kernel][cell]
            mean = sum(ts) / len(ts)
            print(f"  {kernel} {cell:18s} {label:12s} ms "
                  + " ".join(f"{t:.4f}" for t in ts)
                  + f" (mean {mean:.4f}; floor {bound:.4f} = "
                    f"{bound / mean:.1%})")

    for shape, P, m, nx, plane in shapes()[:2]:
        inputs = make_inputs(torch, P, m, gen, dev)
        offsets = offsets_for(nx, plane)
        n = P * m
        for storage, accum in policy_pairs():
            sname = str(storage).removeprefix("torch.")
            cell = f"{shape}/{sname}"
            code = dtype_code(storage, accum)
            b, x = inputs["bands"].to(storage), inputs["x"].to(storage)
            want = spmv_dot_partials_plain(b, x, offsets=offsets,
                                           plane=plane, accum_dtype=accum)
            for label, lib in libs.items():
                y = spmv(lib, code, b, x, offsets)
                y_dot, part = spmv_dot(lib, code, b, x, offsets, accum)
                torch.cuda.synchronize()
                check_spmv_bitwise(torch, f"{label}@{shape}", sname, y,
                                   y_dot, part, *want)
            size, acc_size = b.element_size(), torch.finfo(accum).bits // 8
            in_turns("spmv_dia", cell, {
                label: (lambda lib=lib: spmv(lib, code, b, x, offsets))
                for label, lib in libs.items()}, spmv_dia_cost(7, n, size))
            in_turns("spmv_dot", cell, {
                label: (lambda lib=lib: spmv_dot(lib, code, b, x, offsets,
                                                 accum))
                for label, lib in libs.items()},
                spmv_dot_cost(7, n, 0, size, block_rows=KERNEL_BLOCK_ROWS,
                              accum_itemsize=acc_size))
            del b, x, want
            if shape == "pressure":
                vecs = [inputs[k].to(storage) for k in AXPY_OPERANDS]
                want = axpy_precond_partials_plain(
                    *vecs, inputs["alpha"].to(accum), accum_dtype=accum)
                launch = {label: axpy_launcher(torch, lib["krylov_fused"],
                                               vecs, inputs["alpha"], accum)
                          for label, lib in libs.items()}
                for label, fn in launch.items():
                    got = fn()
                    torch.cuda.synchronize()
                    same = [torch.equal(g, w) for g, w in zip(got, want)]
                    print(f"  bitwise {label}@{shape} {sname:8s}: "
                          f"axpy_precond x', r', z, r.z and r.r partials "
                          f"{same}")
                    require(all(same), f"{label}'s axpy_precond is not "
                                       f"bitwise at {sname}: {same}")
                in_turns("axpy_precond", cell, launch,
                         fused_axpy_precond_cost(
                             n, size, block_rows=KERNEL_BLOCK_ROWS,
                             accum_itemsize=acc_size))
                del vecs, want, launch
        del inputs
        torch.cuda.empty_cache()
    return result


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


# (wrapper module, plain version) of every kernel wrapper the step runs
PLAIN_VERSIONS = (
    ("spmv_dia", "spmv_dia_plain"), ("krylov_fused", "spmv_dot_plain"),
    ("krylov_fused", "spmv_dot_partials_plain"),
    ("krylov_fused", "fused_axpy_precond_plain"),
    ("krylov_fused", "axpy_precond_partials_plain"),
    ("coef_update", "coef_update_plain"),
    ("krylov_loop", "cg_direction_plain"), ("krylov_loop", "cg_advance_plain"))


@contextlib.contextmanager
def no_plain_versions():
    """Make every kernel wrapper's plain version raise inside the block:
    on the card the wrappers must launch their kernels."""
    import importlib

    # the wrapper modules (each package re-exports a function of its name);
    # an older tree, timed by a copy of this script, may lack a name
    mods = {}
    for m in {m for m, _ in PLAIN_VERSIONS}:
        try:
            mods[m] = importlib.import_module(f"repro_torch.kernels.{m}.{m}")
        except ModuleNotFoundError:
            continue
    saved = [(mods[m], name, getattr(mods[m], name))
             for m, name in PLAIN_VERSIONS
             if m in mods and hasattr(mods[m], name)]

    def refuse(name):
        def plain(*args, **kwargs):
            raise SmokeFailure(f"{name} ran on the card's path")
        return plain

    try:
        for mod, name, _ in saved:
            setattr(mod, name, refuse(name))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def require_launched(counts: dict, tag: str) -> None:
    require(all(counts[k] > 0 for k in STEP_KERNELS),
            f"{tag}: a kernel of the path was never launched: {counts}")


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
    from repro_torch.solvers.device_loop import (loop_records,
                                                 reset_loop_records)
    state0 = solver.initial_state()
    reset_launch_counts()
    reset_loop_records()
    state_f, stats_f, walls_f = steps("auto", state0, n)
    counts = launch_counts()
    records = loop_records()
    print(f"  kernel launches over {n} steps: {counts}")
    require(all(counts[k] > 0 for k in STEP_KERNELS),
            f"a kernel of the main path was never launched: {counts}")
    require(counts["coef_update"] == 3 * n,
            f"the value update launched {counts['coef_update']} times in "
            f"{n} steps, not 3 a step")
    cg_iters = int(stats_f.p_iters.sum())
    require(counts["spmv_dot"] == counts["axpy_precond"]
            == counts["cg_direction"] == counts["cg_advance"] == cg_iters,
            f"the CG kernels' launches {counts} are not the {cg_iters} CG "
            f"iterations the steps ran")
    loop = loop_summary(records)
    print(f"  device loop: {len(records)} sweeps, (iterations, blocks, host "
          f"reads, capture ms) {loop['sweeps']}")
    check_steps(torch, stats_f, "fused")
    counts_f = {"mom_iters": stats_f.mom_iters.tolist(),
                "p_iters": stats_f.p_iters.tolist()}
    require(counts_f == MAIN_COUNTS, f"Krylov counts {counts_f}, expected "
                                     f"{MAIN_COUNTS}")

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
    instrumented = instrumented_phase(torch, solver, state_f, dt, breakdown)
    summary = {
        "loop": loop, "instrumented": instrumented,
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
    summary["loop_check"] = loop_phase(torch, solver, state_f, dt)
    summary["rebind"] = rebind_phase(torch, solver, state_f, dt, breakdown)
    summary["baseline"] = baseline_phase(torch, solver, state_f, dt)
    summary["precision"] = precision_phase(torch, solver, state_f, dt,
                                           breakdown)
    return summary


def loop_summary(records) -> dict:
    """The device loop's records of a run: each sweep's (iterations,
    blocks, host reads, capture ms), every sweep's host reads held to
    ``ceil(iterations / K) + 4``, and on the card every sweep's guarded
    launches, as the kernels counted them on the device, held to
    :data:`LOOP_LAUNCHES` times its iterations."""
    for rec in records:
        bound = -(-rec.iters // rec.K) + 4
        require(rec.host_reads <= bound,
                f"a sweep of {rec.iters} iterations read the device "
                f"{rec.host_reads} times (bound {bound} at K = {rec.K})")
        if rec.device == "cuda" and rec.iters:
            want = {name: LOOP_LAUNCHES[rec.solver].get(name, 0) * rec.iters
                    for name in rec.launches}
            require(set(LOOP_LAUNCHES[rec.solver]) <= set(rec.launches)
                    and rec.launches == want,
                    f"a {rec.solver} sweep of {rec.iters} iterations counted "
                    f"the launches {rec.launches} on the device, not {want}")
    return {"sweeps": [(r.iters, r.blocks, r.host_reads,
                        round(1e3 * r.capture_s, 3)) for r in records],
            "host_reads": sum(r.host_reads for r in records),
            "capture_ms": 1e3 * sum(r.capture_s for r in records),
            "K": sorted({r.K for r in records})}


def instrumented_phase(torch, solver, state, dt, walk) -> dict:
    """``solver.timed_step`` (the instrumented executor: CUDA events at the
    phase boundaries, one synchronisation) beside the synchronised walk
    ``walk`` from the same state: the state bitwise equal, the
    PhaseBreakdown's total within 10 % of the walk's."""
    st, stats, pb = solver.timed_step(state, dt)
    walk_s = sum(walk["walls"].values())
    same = all(torch.equal(getattr(st, f), getattr(walk["state"], f))
               for f in st._fields)
    same = same and all(torch.equal(a, b) for a, b in zip(stats,
                                                          walk["stats"]))
    print(f"  instrumented timed_step: {pb} (total {pb.total:.4f} s against "
          f"the synchronised walk's {walk_s:.4f} s); bitwise equal {same}")
    require(same, "timed_step's state or stats differ from the walk's")
    require(abs(pb.total - walk_s) <= 0.1 * walk_s,
            f"the PhaseBreakdown total {pb.total:.4f} s is not within 10 % "
            f"of the walk's {walk_s:.4f} s")
    return {"breakdown": dataclasses.asdict(pb), "total_s": pb.total,
            "walk_s": walk_s}


@contextlib.contextmanager
def host_sweeps():
    """Inside the block the solvers run their former host loops
    (``_cg_sweep_host``, ``_bicgstab_sweep_host``): the plain version of
    the device loop."""
    from repro_torch.solvers import bicgstab as bi_mod
    from repro_torch.solvers import cg as cg_mod

    saved = cg_mod._cg_sweep, bi_mod._bicgstab_sweep
    cg_mod._cg_sweep = cg_mod._cg_sweep_host
    bi_mod._bicgstab_sweep = bi_mod._bicgstab_sweep_host
    try:
        yield
    finally:
        cg_mod._cg_sweep, bi_mod._bicgstab_sweep = saved


def momentum_system(solver, state, dt):
    """The momentum ``(bands, sysM)`` of one step of ``solver`` from
    ``state``."""
    from repro_torch.fvm.step_program import _bind

    prog = solver.program
    env = prog.seed(state, dt, *solver._extras())
    for ph in prog.phases:
        if ph.name == "solve_mom":
            break
        _bind(env, ph, ph.fn(*(env[k] for k in ph.inputs)))
    return env["bandsM"], env["sysM"]


def synced(torch, fn):
    """``(fn(), seconds)``, the call between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def loop_phase(torch, solver, state, dt) -> dict:
    """Phase 4's device-loop check at full size, from ``state``: the f64
    pressure CG sweep, an ``f32_ir`` pressure solve and the three f64
    momentum BiCGStab sweeps, each on the device loop and on the host loop
    with the kernels — ``x`` bitwise, identical counts and flags, the host
    reads of every sweep within ``ceil(iterations / K) + 4`` — then the
    f64 pressure sweep and one momentum sweep timed at K = 1, 2, 4, 8, 32
    and 128 (ms per iteration and capture ms)."""
    from repro_torch.solvers import device_loop
    from repro_torch.solvers.bicgstab import (_bicgstab_sweep,
                                              _bicgstab_sweep_host)
    from repro_torch.solvers.cg import _cg_sweep, _cg_sweep_host, cg
    from repro_torch.solvers.cg import threshold_sq

    print(f"[4b] the device loop ({device_loop.ROUTE}, K = {device_loop.K}) "
          f"against the host loop, {N}^3, kernels")
    solver.solver_backend = "auto"
    out = {"route": device_loop.ROUTE, "K": device_loop.K}
    bands, b, x0, diag = pressure_system(solver, state, dt)
    ops = solver._solver_ops(solver.plan_p, bands, diag)
    (bb,) = ops.dots((b, b))
    thr_p = threshold_sq(bb, solver.p_tol, 0.0)
    bandsM, sysM = momentum_system(solver, state, dt)
    opsM = solver._solver_ops(solver.plan_mom, bandsM, sysM.diag)
    mom = []
    for c in range(3):
        bm = sysM.source[..., c].contiguous()
        (bbm,) = opsM.dots((bm, bm))
        mom.append((bm, state.U[..., c].contiguous(),
                    threshold_sq(bbm, solver.mom_tol, 0.0)))

    def held(tag, device_fn, host_fn):
        device_loop.reset_loop_records()
        with no_plain_versions():
            (x_d, rr_d, k_d), s_d = synced(torch, device_fn)
            recs = device_loop.loop_records()
            (x_h, rr_h, k_h), s_h = synced(torch, host_fn)
        same = (torch.equal(x_d, x_h) and torch.equal(rr_d, rr_h)
                and int(k_d) == int(k_h))
        summ = loop_summary(recs)
        print(f"  {tag}: {int(k_d)} iterations, x and r.r bitwise {same}; "
              f"device loop {s_d:.3f} s ({1e3 * s_d / max(int(k_d), 1):.4f}"
              f" ms/iter), host loop {s_h:.3f} s "
              f"({1e3 * s_h / max(int(k_h), 1):.4f} ms/iter); (iterations, "
              f"blocks, host reads, capture ms) {summ['sweeps']}")
        require(same, f"{tag}: the device loop differs from the host loop")
        return {"iters": int(k_d), "s": s_d, "host_s": s_h, **summ}

    out["p_f64"] = held(
        "f64 pressure CG sweep",
        lambda: _cg_sweep(ops, b, x0, thr_p, solver.p_maxiter),
        lambda: _cg_sweep_host(ops, b, x0, thr_p, solver.p_maxiter))
    for c, (bm, xm, thr_m) in enumerate(mom):
        out[f"mom_{c}"] = held(
            f"f64 momentum BiCGStab sweep, component {c}",
            lambda: _bicgstab_sweep(opsM, bm, xm, thr_m, solver.mom_maxiter),
            lambda: _bicgstab_sweep_host(opsM, bm, xm, thr_m,
                                         solver.mom_maxiter))

    # an f32_ir pressure solve: the whole refinement loop, its inner sweeps
    # on the device loop and then on the host loop
    solver.precision = "f32_ir"
    try:
        ops32 = solver._solver_ops(solver.plan_p, bands, diag)
    finally:
        solver.precision = "f64"
    device_loop.reset_loop_records()
    with no_plain_versions():
        res_d, s_d = synced(torch, lambda: cg(ops32, b, x0, tol=solver.p_tol,
                                              maxiter=solver.p_maxiter))
        summ = loop_summary(device_loop.loop_records())
        with host_sweeps():
            res_h, s_h = synced(torch, lambda: cg(
                ops32, b, x0, tol=solver.p_tol, maxiter=solver.p_maxiter))
    fields = {f: (int(getattr(res_d, f)), int(getattr(res_h, f)))
              for f in ("iters", "outer_iters", "converged", "hit_cap")}
    same = (torch.equal(res_d.x, res_h.x)
            and torch.equal(res_d.residual, res_h.residual)
            and all(a == b_ for a, b_ in fields.values()))
    print(f"  f32_ir pressure solve: (device, host) {fields}; x bitwise "
          f"{same}; device loop {s_d:.3f} s "
          f"({1e3 * s_d / max(fields['iters'][0], 1):.4f} ms per inner "
          f"iteration), host loop {s_h:.3f} s; (iterations, blocks, host "
          f"reads, capture ms) {summ['sweeps']}")
    require(same, "f32_ir: the device loop differs from the host loop")
    out["p_f32_ir"] = {"fields": fields, "s": s_d, "host_s": s_h, **summ}

    # K: the f64 pressure sweep and momentum component 0 at six lengths
    k0 = device_loop.K
    out["K_trial"] = {}
    try:
        for k_len in (1, 2, 4, 8, 32, 128):
            device_loop.K = {"cg": k_len, "bicgstab": k_len}
            ops.loops.clear()  # each length captures anew
            opsM.loops.clear()
            rec = {}
            for tag, fn in (
                    ("pressure", lambda: _cg_sweep(ops, b, x0, thr_p,
                                                   solver.p_maxiter)),
                    ("momentum", lambda: _bicgstab_sweep(
                        opsM, *mom[0][:2], mom[0][2], solver.mom_maxiter))):
                device_loop.reset_loop_records()
                (_, _, k), secs = synced(torch, fn)
                (r,) = device_loop.loop_records()
                rec[tag] = {"iters": int(k), "s": secs,
                            "ms_per_iter": 1e3 * secs / int(k),
                            "capture_ms": 1e3 * r.capture_s,
                            "host_reads": r.host_reads, "blocks": r.blocks}
            out["K_trial"][k_len] = rec
            print(f"  K = {k_len:3d}: " + "; ".join(
                f"{t} {v['ms_per_iter']:.4f} ms/iter ({v['iters']} iters, "
                f"capture {v['capture_ms']:.1f} ms, {v['host_reads']} reads)"
                for t, v in rec.items()))
    finally:
        device_loop.K = k0
    return out


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


# ---------------------------------------------------------------------------
# phases 9-11: the precision policies, the channel, SIMPLE
# ---------------------------------------------------------------------------

def case_args(case: str, program: str = "piso") -> list:
    """The main path's launcher arguments for another case or program."""
    return MAIN_ARGS + ["--case", case, "--program", program]


def state_diffs(st, ref) -> dict:
    return {f: rel_diff(getattr(st, f), getattr(ref, f))
            for f in st._fields if f != "phi_b"}


def kernel_step(torch, solver, state, dt, tag: str, must_converge=True):
    """One step of ``solver`` from ``state`` with the kernels, the launch
    counters read from 0, no plain version allowed; unless
    ``must_converge`` is False, every solve converged and no cap hit."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.case import run_transient

    solver.solver_backend = "auto"
    reset_launch_counts()
    with no_plain_versions():
        st, stt, walls = run_transient(
            solver, dt, 1, state=state,
            log=lambda line: print(f"  {tag}: {line}"))
    counts = launch_counts()
    require_launched(counts, tag)
    if must_converge:
        check_steps(torch, stt, tag)
        require(not bool(stt.hit_cap.any()), f"{tag}: a solve hit its cap")
    return st, stt, walls[0], counts


def flags(stats) -> str:
    return ", ".join(f"{f} {bool(getattr(stats, f).all())}"
                     for f in ("converged", "diverged", "hit_cap"))


def precision_phase(torch, solver, state, dt, f64_step) -> dict:
    """Phase 9: one f32_ir cavity step from ``state`` against the f64 step
    from it (``f64_step``: the timed step)."""
    print(f"[9] precision on the main path: f32_ir, {N}^3 cavity, "
          f"alpha {ALPHA}")
    require(solver.alpha == ALPHA, "the solver is not at the main ratio")
    solver.precision = "f32_ir"
    try:
        st, stt, wall, counts = kernel_step(torch, solver, state, dt,
                                            "f32_ir")
    finally:
        solver.precision = "f64"
    ref_st, ref_stats = f64_step["state"], f64_step["stats"]
    diffs = state_diffs(st, ref_st)
    print(f"  vs the f64 step from the same state: max|dU|/max|U| "
          f"{diffs['U']:.3e}, max|dp|/max|p| {diffs['p']:.3e}; counts "
          f"f32_ir mom {int(stt.mom_iters[0])} p {stt.p_iters[0].tolist()}"
          f", f64 mom {int(ref_stats.mom_iters)} p "
          f"{ref_stats.p_iters.tolist()}; launches {counts}")
    return {"step_s": wall, "diffs_vs_f64": diffs, "launches": counts,
            "mom_iters": int(stt.mom_iters[0]),
            "p_iters": stt.p_iters[0].tolist(),
            "continuity": float(stt.continuity_err[0])}


def pressure_system(solver, state, dt):
    """The first corrector's ``(bands, b, x0, diag)`` of one step of
    ``solver`` from ``state``, in the coarse layout."""
    from repro_torch.fvm.step_program import _bind

    prog = solver.program
    env = prog.seed(state, dt, *solver._extras())
    for ph in prog.phases:
        if ph.name == "solve_p":
            break
        _bind(env, ph, ph.fn(*(env[k] for k in ph.inputs)))
    n_c = solver.n_coarse
    sysP = env["sysP"]
    return (env["bandsP"], sysP.source.reshape(n_c, -1),
            env["p"].reshape(n_c, -1), sysP.diag.reshape(n_c, -1))


def pressure_solves(torch, solver, system) -> dict:
    """The pressure system solved alone under each policy, kernels only,
    timed; the f64 replays of a refined solve are ``spmv_dia`` launches
    (1 for the initial residual, then 2 per outer pass: the inner
    sweep's first residual and the replay)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.solvers.cg import cg
    from repro_torch.solvers.precision import POLICIES

    bands, b, x0, diag = system
    out = {}
    solver.solver_backend = "auto"
    for pol in POLICIES:
        solver.precision = pol
        try:
            ops = solver._solver_ops(solver.plan_p, bands, diag)
            reset_launch_counts()
            with no_plain_versions():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = cg(ops, b, x0, tol=solver.p_tol,
                         maxiter=solver.p_maxiter)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
        finally:
            solver.precision = "f64"
        counts = launch_counts()
        # ints and bools: a tree before the device loop returns them as
        # such, this one as 0-d tensors
        outer, inner = int(res.outer_iters), int(res.iters)
        converged, hit_cap = bool(res.converged), bool(res.hit_cap)
        rec = {"outer": outer, "inner": inner, "s": secs,
               "ms_per_inner": 1e3 * secs / max(inner, 1),
               "launches": counts, "converged": converged}
        out[pol] = rec
        print(f"  pressure solve alone, {pol:7s}: outer {outer}, "
              f"inner {inner}, {secs:.3f} s, "
              f"{rec['ms_per_inner']:.4f} ms per inner iteration, "
              f"converged {converged}, hit_cap {hit_cap}, residual "
              f"{float(res.residual):.3e}; launches {counts}")
        rec["residual"] = float(res.residual)
        require(pol not in MUST_CONVERGE or (converged and not hit_cap),
                f"the {pol} pressure solve did not converge")
        replays = 2 * outer + 1 if outer else 1
        require(counts["spmv_dia"] == replays
                and counts["spmv_dot"] == counts["axpy_precond"] == inner,
                f"{pol}: launches {counts} for {outer} outer and "
                f"{inner} inner iterations")
    return out


def channel_phase(torch) -> dict:
    """Phase 10: the 210^3 channel under each policy (see the module
    docstring)."""
    from repro_torch.launch.case import build_parser, build_solver
    from repro_torch.solvers.precision import POLICIES

    print(f"[10] the {N}^3 channel, {PARTS} parts, alpha {ALPHA}: PISO "
          "under f64, f32_ir, bf16_ir")
    args = build_parser().parse_args(case_args("channel"))
    solver = build_solver(args)
    print(f"  plans (host) {solver.plan_seconds:.2f} s")
    dt = args.co * solver.mesh.h
    state0 = solver.initial_state()
    out = {"plan_s": solver.plan_seconds}
    runs = {}
    for pol in POLICIES:
        solver.precision = pol
        try:
            runs[pol] = kernel_step(torch, solver, state0, dt, pol,
                                    must_converge=pol in MUST_CONVERGE)
        finally:
            solver.precision = "f64"
    st64 = runs["f64"][0]
    for pol, (st, stt, wall, counts) in runs.items():
        rec = out[pol] = {"step_s": wall, "launches": counts,
                          "mom_iters": int(stt.mom_iters[0]),
                          "p_iters": stt.p_iters[0].tolist(),
                          "continuity": float(stt.continuity_err[0]),
                          "converged": bool(stt.converged.all()),
                          "hit_cap": bool(stt.hit_cap.any()),
                          "diverged": bool(stt.diverged.any())}
        print(f"  {pol}: {flags(stt)}; launches {counts}")
        if pol != "f64":
            rec["diffs_vs_f64"] = state_diffs(st, st64)
            print(f"  {pol} vs f64 from the same state: max|dU|/max|U| "
                  f"{rec['diffs_vs_f64']['U']:.3e}, max|dp|/max|p| "
                  f"{rec['diffs_vs_f64']['p']:.3e}")

    # the plain backend per policy from the same state
    for pol, (st, stt, _, _) in runs.items():
        solver.precision, solver.solver_backend = pol, "reference"
        try:
            st_r, stt_r, w_r = solver_step(torch, solver, state0, dt)
        finally:
            solver.precision, solver.solver_backend = "f64", "auto"
        converged = bool(stt.converged.all())
        if pol in MUST_CONVERGE or converged:
            check_steps(torch, stt_r, f"{pol} plain")
        diffs = state_diffs(st, st_r)
        bar = PARITY if pol == "f64" else FREE_RUN_DRIFT
        print(f"  {pol} kernels vs plain: max|d|/max over U, p, phi, phi_if "
              + ", ".join(f"{v:.3e}" for v in diffs.values())
              + f" (bar {bar:.0e}{'' if converged else ', not held: unconverged'}"
              f"); counts kernels mom "
              f"{int(stt.mom_iters[0])} p {stt.p_iters[0].tolist()}, plain "
              f"mom {int(stt_r.mom_iters[0])} p {stt_r.p_iters[0].tolist()}"
              f"; plain {flags(stt_r)}; plain step {w_r:.3f} s")
        require(not converged or max(diffs.values()) <= bar,
                f"channel {pol}: kernels vs plain differ by {diffs}")
        fields = ("converged", "diverged", "hit_cap") + (
            ("mom_iters", "p_iters") if pol == "f64" else ())
        for f in fields:
            require(torch.equal(getattr(stt, f), getattr(stt_r, f)),
                    f"channel {pol}: {f} differs between the backends")
        out[pol].update(plain_step_s=w_r, plain_diffs=diffs,
                        plain_mom_iters=int(stt_r.mom_iters[0]),
                        plain_p_iters=stt_r.p_iters[0].tolist())
    del runs
    out["pressure_solve"] = pressure_solves(
        torch, solver, pressure_system(solver, state0, dt))
    return out


def solver_step(torch, solver, state, dt):
    """One synchronised ``solver.step``: ``(state, stats, seconds)``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, stt = solver.step(state, dt)
    torch.cuda.synchronize()
    return st, type(stt)(*(t[None] for t in stt)), time.perf_counter() - t0


def simple_phase(torch) -> dict:
    """Phase 11: SIMPLE on the 210^3 channel, 4 outer iterations."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.case import (build_parser, build_solver,
                                         run_steady)

    n_outer = 4
    print(f"[11] SIMPLE on the {N}^3 channel, alpha {ALPHA}: "
          f"run_steady(max_outer={n_outer})")
    args = build_parser().parse_args(case_args("channel", "simple"))
    solver = build_solver(args)
    dt = args.co * solver.mesh.h
    state0 = solver.initial_state()
    reset_launch_counts()
    with no_plain_versions():
        st, stats, n, wall = run_steady(
            solver, dt, n_outer, state=state0,
            log=lambda line: print(f"  {line}"))
    counts = launch_counts()
    require_launched(counts, "simple")
    require(n == n_outer and not bool(solver.program.converged(stats)),
            f"SIMPLE ran {n} outer iterations, not capped at {n_outer}")
    require(bool(stats.converged) and not bool(stats.diverged)
            and not bool(stats.hit_cap),
            "SIMPLE: a Krylov solve did not converge")
    print(f"  launches {counts}")

    # outer iteration by outer iteration: the same run, each state kept
    states, per_outer = [state0], []
    with no_plain_versions():
        for k in range(n_outer):
            s_k, t_k, w_k = solver_step(torch, solver, states[-1], dt)
            states.append(s_k)
            per_outer.append({
                "continuity": float(t_k.continuity_err[0]),
                "u_delta": float(t_k.u_delta[0]),
                "mom_iters": int(t_k.mom_iters[0]),
                "p_iters": t_k.p_iters[0].tolist(), "s": w_k, "stats": t_k})
            print(f"  outer {k}: continuity {per_outer[-1]['continuity']:.3e}"
                  f" u_delta {per_outer[-1]['u_delta']:.3e} mom_iters "
                  f"{per_outer[-1]['mom_iters']} p_iters "
                  f"{per_outer[-1]['p_iters']} ({w_k:.3f} s)")
    require(all(torch.equal(getattr(st, f), getattr(states[-1], f))
                for f in st._fields),
            "SIMPLE: the outer-by-outer replay is not bitwise run_steady's")

    # the plain backend from each of the kernel run's states
    solver.solver_backend = "reference"
    worst = 0.0
    try:
        for k in range(n_outer):
            s_r, t_r, w_r = solver_step(torch, solver, states[k], dt)
            diffs = state_diffs(states[k + 1], s_r)
            worst = max(worst, max(diffs.values()))
            t_k = per_outer[k].pop("stats")
            per_outer[k].update(plain_s=w_r, plain_diffs=diffs)
            print(f"  outer {k} plain: max|d|/max over U, p, phi, phi_if "
                  + ", ".join(f"{v:.3e}" for v in diffs.values())
                  + f"; p_iters {t_r.p_iters[0].tolist()} ({w_r:.3f} s)")
            require(max(diffs.values()) <= PARITY,
                    f"SIMPLE outer {k}: kernels vs plain differ by {diffs}")
            for f in ("mom_iters", "p_iters", "converged", "diverged",
                      "hit_cap"):
                require(torch.equal(getattr(t_k, f), getattr(t_r, f)),
                        f"SIMPLE outer {k}: {f} differs between backends")
    finally:
        solver.solver_backend = "auto"
    return {"run_steady_s": wall, "launches": counts,
            "per_outer": per_outer, "plain_parity": worst,
            "plan_s": solver.plan_seconds}


def step_timing(torch, repeats: int) -> dict:
    """The main path's first f64 step from rest, walked phase by phase
    ``repeats`` times after one untimed step: ms per pressure-CG
    iteration (the ``solve_p`` walls over their iterations); then phase
    10's first channel pressure system solved alone under each policy
    (ms per inner iteration)."""
    from repro_torch.launch.case import build_parser, build_solver

    args = build_parser().parse_args(MAIN_ARGS)
    solver = build_solver(args)
    dt = args.co * solver.mesh.h
    state0 = solver.initial_state()
    solver.step(state0, dt)  # loads the kernels; not timed
    ms, p_iters, step_s, mom_s = [], None, [], []
    for _ in range(repeats):
        bd = timed_step(torch, solver, state0, dt)
        require(p_iters in (None, bd["p_iters"]),
                f"the repeated step's counts changed: {bd['p_iters']}")
        p_iters = bd["p_iters"]
        cg_s = sum(v for k, v in bd["walls"].items()
                   if k.startswith("solve_p"))
        ms.append(1e3 * cg_s / sum(p_iters))
        step_s.append(sum(bd["walls"].values()))
        mom_s.append(bd["walls"]["solve_mom"])
    print(f"  step from rest, p_iters {p_iters}: ms per CG iteration "
          + " ".join(f"{t:.4f}" for t in ms) + "; s per step (walk) "
          + " ".join(f"{t:.4f}" for t in step_s) + "; solve_mom s "
          + " ".join(f"{t:.4f}" for t in mom_s))
    del solver, state0
    free_device(torch)
    args = build_parser().parse_args(case_args("channel"))
    solver = build_solver(args)
    solves = pressure_solves(torch, solver, pressure_system(
        solver, solver.initial_state(), args.co * solver.mesh.h))
    return {"ms_per_cg_iter": ms, "p_iters": p_iters, "step_s": step_s,
            "solve_mom_s": mom_s,
            "ms_per_inner": {pol: rec["ms_per_inner"]
                             for pol, rec in solves.items()},
            "src": str(ROOT)}


# kernel-name fragments of the pressure CG's device work, in the order a
# name is tried; elementwise kernels split by their mean time into vector
# (the p update) and scalar work
CG_PROFILE_PARTS = (("spmv_dot", ("spmv_dot_kernel",)),
                    ("axpy_precond", ("axpy_precond",)),
                    ("cg_direction", ("cg_direction_kernel",)),
                    ("cg_advance", ("cg_advance_kernel",)),
                    ("partial sums", ("reduce_kernel",)),
                    ("host read", ("Memcpy DtoH", "memcpy32_post",
                                   "Memcpy DtoD")))


def profile_cg(torch, iters: int) -> dict:
    """The main path's first pressure system (the cavity from rest), CG
    capped at ``iters`` iterations under ``torch.profiler``: each kernel's
    device time per iteration, sorted into the parts of an iteration, and
    the device's idle share of the window (1 - the kernels' summed time
    over the window's wall)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.case import build_parser, build_solver
    from repro_torch.solvers.cg import cg

    args = build_parser().parse_args(MAIN_ARGS)
    solver = build_solver(args)
    bands, b, x0, diag = pressure_system(solver, solver.initial_state(),
                                         args.co * solver.mesh.h)
    ops = solver._solver_ops(solver.plan_p, bands, diag)
    cg(ops, b, x0, tol=solver.p_tol, maxiter=iters)  # loads and captures
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cg(ops, b, x0, tol=solver.p_tol, maxiter=iters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = int(res.iters)
    kernels = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total",
                         getattr(evt, "cuda_time_total", 0))
        # device-side events only (a CPU op's device time repeats its
        # kernels')
        if dev_us and getattr(evt, "device_type", None) is not None \
                and "CUDA" in str(evt.device_type):
            kernels[evt.key] = (dev_us, evt.count)
    parts = {}
    for name, (us, count) in kernels.items():
        part = next((p for p, keys in CG_PROFILE_PARTS
                     if any(k in name for k in keys)), None)
        if part is None:
            part = ("p update (vector elementwise)" if us / count > 10
                    else "scalar ops")
        parts[part] = parts.get(part, 0.0) + us / 1e3 / n
    busy = sum(us for us, _ in kernels.values()) / 1e6
    out = {"iters": n, "wall_ms_per_iter": 1e3 * wall / n,
           "device_ms_per_iter": parts, "busy_ms_per_iter": 1e3 * busy / n,
           "idle_share": 1 - busy / wall,
           "kernels": {k: {"us": us, "count": c}
                       for k, (us, c) in sorted(kernels.items(),
                                                key=lambda kv: -kv[1][0])}}
    print(f"  CG capped at {iters}: {n} iterations, "
          f"{out['wall_ms_per_iter']:.4f} ms per iteration (wall), device "
          f"busy {out['busy_ms_per_iter']:.4f} ms, idle share "
          f"{out['idle_share']:.1%}")
    for part, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"    {part:32s} {ms:.4f} ms per iteration")
    for k, v in list(out["kernels"].items())[:14]:
        print(f"    {v['count']:6d} x {k[:70]:70s} {v['us'] / 1e3:9.3f} ms")
    return out


def free_device(torch) -> None:
    """Collect the solvers (their programs close over them) and give the
    cached blocks back."""
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compare", action="append", metavar="LABEL=CSRC_DIR",
                    help="time this tree's Krylov kernels beside another "
                         "csrc directory's, in turns (repeatable)")
    ap.add_argument("--step-timing", type=int, metavar="REPEATS",
                    help="time the main path's first step REPEATS times "
                         "(ms per CG iteration) instead of the smoke test")
    ap.add_argument("--profile-cg", type=int, metavar="ITERS",
                    help="profile ITERS iterations of the main path's "
                         "first pressure CG instead of the smoke test")
    args = ap.parse_args(argv)
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
        import repro_torch.kernels._build  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the port is not importable beside chip_smoke.py ({e})",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    try:
        dev = torch.device("cuda")
        smi = smi_line()
        print(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}; "
              f"conditional graph nodes (CUDAGraph.begin_capture_to_if_node)"
              f": {hasattr(torch.cuda.CUDAGraph, 'begin_capture_to_if_node')}")
        print("[2] build")
        build_phase()
        if args.compare:
            others = dict(item.split("=", 1) for item in args.compare)
            result = compare_builds(torch, dev, others)
            print(smi_line())
            print(json.dumps({"compare": result}))
            return 0
        if args.step_timing:
            result = step_timing(torch, args.step_timing)
            print(smi_line())
            print(json.dumps({"step_timing": result}))
            return 0
        if args.profile_cg:
            result = profile_cg(torch, args.profile_cg)
            print(smi_line())
            print(json.dumps({"profile_cg": result}))
            return 0
        print("[3] kernels vs plain versions")
        report = check_kernels(torch, dev)
        print("[4-6] main path: 210^3 cavity, 30 parts, alpha 30, 3 PISO "
              "steps; determinism; parity (then 7-8)")
        torch.cuda.reset_peak_memory_stats()
        summary = main_path(torch)
        free_device(torch)
        summary["channel"] = channel_phase(torch)
        free_device(torch)
        summary["simple"] = simple_phase(torch)
        free_device(torch)
        print(f"done in {time.perf_counter() - t_start:.1f} s")
        summary["momentum_shape_times"] = {
            name: report[name]["momentum"] for name in report
            if "momentum" in report[name]}
        summary["low_precision_times"] = {
            name: {d: report[name][d] for d in ("float32", "bfloat16")
                   if d in report[name]}
            for name in report if "float32" in report[name]}
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
                        "bound_by", "library_ms")},
                    # the axpy kernel alone: raw launches, no wrapper
                    **{k: report[name][k] for k in ("kernel_alone_ms",)
                       if k in report[name]}}
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
