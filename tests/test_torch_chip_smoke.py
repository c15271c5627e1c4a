"""The pure helpers of ``chip_smoke.py`` on the CPU: the ``ptxas -v``
parser and the frame check of its build phase, and the bitwise check of
the axpy kernel's outputs.

The logs below are lines ``nvcc -Xptxas -v`` printed on the H100 (CUDA
12.8).  The framed one is the first port of the DIA SpMV kernel, whose
band-offset struct was indexed in a loop of run-time length and so copied
to a 72-byte local-memory frame; the clean one is the checked kernels',
with a made-up frame on the value-update kernel, which the check does not
cover.
"""
import contextlib
import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels.krylov_fused.krylov_fused import (  # noqa: E402
    axpy_precond_partials, axpy_precond_partials_plain)

OLD_DIA = "_Z15spmv_dia_kernelIddEvPKT_S2_PS0_xxN5repro11BandOffsetsE"
NEW_DIA = "_Z15spmv_dia_kernelIddLi7EEvPKT_S2_PS0_N5repro7DiaArgsE"
NEW_DOT = "_Z15spmv_dot_kernelIddLi7EEvPKT_S2_PS0_PT0_N5repro7DiaArgsE"
AXPY = "_Z19axpy_precond_kernelIddEvPKT_S2_S2_S2_S2_PKT0_PS0_S6_S6_PS3_S7_x"
GATHER = "_Z18coef_update_kernelILi8EEvPKvPKiPvxxx"

@pytest.fixture
def one_thread():
    """One intra-op torch thread: the suite runs several workers on few
    cores, whose threads would otherwise oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FRAMED = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{OLD_DIA}' for 'sm_90a'
ptxas info    : Function properties for {OLD_DIA}
    72 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers, 72 bytes cumulative stack size
ptxas info    : Compile time = 43.622 ms
"""

CLEAN = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{NEW_DIA}' for 'sm_90a'
ptxas info    : Function properties for {NEW_DIA}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers
ptxas info    : Compile time = 67.423 ms
ptxas info    : Compiling entry function '{NEW_DOT}' for 'sm_90a'
ptxas info    : Function properties for {NEW_DOT}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 2048 bytes smem
ptxas info    : Compile time = 65.336 ms
ptxas info    : Compiling entry function '{AXPY}' for 'sm_90a'
ptxas info    : Function properties for {AXPY}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 24 registers, used 1 barriers, 2048 bytes smem
ptxas info    : Compile time = 7.837 ms
ptxas info    : Compiling entry function '{GATHER}' for 'sm_90a'
ptxas info    : Function properties for {GATHER}
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 16 registers, used 0 barriers
ptxas info    : Compile time = 3.118 ms
"""


def test_ptxas_report_reads_frame_spills_and_registers():
    old = chip_smoke.ptxas_report(FRAMED)
    assert old == {OLD_DIA: {"stack": 72, "spill_stores": 0,
                             "spill_loads": 0, "registers": 32}}
    new = chip_smoke.ptxas_report(CLEAN)
    assert set(new) == {NEW_DIA, NEW_DOT, AXPY, GATHER}
    assert new[NEW_DIA] == {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                            "registers": 64}
    assert new[NEW_DOT]["registers"] == 48
    assert new[AXPY]["registers"] == 24
    assert new[GATHER] == {"stack": 8, "spill_stores": 4, "spill_loads": 4,
                           "registers": 16}
    assert chip_smoke.ptxas_report("") == {}


@pytest.mark.parametrize("mangled,name", [
    (OLD_DIA, "spmv_dia_kernel"), (NEW_DOT, "spmv_dot_kernel"),
    (AXPY, "axpy_precond_kernel"), (GATHER, "coef_update_kernel"),
    ("plain_c_name", "plain_c_name")])
def test_base_name_of_a_mangled_kernel(mangled, name):
    assert chip_smoke.base_name(mangled) == name


def test_check_frames_rejects_a_stack_frame():
    with pytest.raises(chip_smoke.SmokeFailure, match="72 bytes stack frame"):
        chip_smoke.check_frames(chip_smoke.ptxas_report(FRAMED + CLEAN))


def test_check_frames_accepts_the_clean_log_and_ignores_other_kernels():
    # the value-update kernel's (made-up) frame is not the check's business
    report = chip_smoke.ptxas_report(CLEAN)
    assert chip_smoke.check_frames(report) == {"spmv_dia_kernel": 1,
                                               "spmv_dot_kernel": 1,
                                               "axpy_precond_kernel": 1}


def test_check_frames_rejects_spills_and_missing_kernels():
    spilled = CLEAN.replace("0 bytes spill stores, 0 bytes spill loads\n"
                            "ptxas info    : Used 48",
                            "16 bytes spill stores, 16 bytes spill loads\n"
                            "ptxas info    : Used 48")
    with pytest.raises(chip_smoke.SmokeFailure, match="spilled"):
        chip_smoke.check_frames(chip_smoke.ptxas_report(spilled))
    only_dia = chip_smoke.ptxas_report(CLEAN.split(
        "ptxas info    : Compiling entry function '_Z15spmv_dot")[0])
    with pytest.raises(chip_smoke.SmokeFailure, match="no instance"):
        chip_smoke.check_frames(only_dia)
    no_frame_line = {NEW_DIA: {"registers": 96}, NEW_DOT: {"registers": 1}}
    with pytest.raises(chip_smoke.SmokeFailure, match="no frame line"):
        chip_smoke.check_frames(no_frame_line)


def test_check_frames_covers_the_axpy_kernel():
    framed = CLEAN.replace(
        f"{AXPY}\n    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
        f"spill loads", f"{AXPY}\n    16 bytes stack frame, 8 bytes spill "
        f"stores, 8 bytes spill loads")
    assert framed != CLEAN
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="axpy_precond_kernel.*16 bytes stack frame"):
        chip_smoke.check_frames(chip_smoke.ptxas_report(framed))
    without = CLEAN.split(
        "ptxas info    : Compiling entry function '_Z19axpy")[0]
    with pytest.raises(chip_smoke.SmokeFailure, match="no instance"):
        chip_smoke.check_frames(chip_smoke.ptxas_report(without))


def _axpy_case(storage, accum, n=2331, seed=0):
    rng = np.random.default_rng(seed)
    vecs = [torch.as_tensor(rng.uniform(lo, hi, (3, n // 3))).to(storage)
            for lo, hi in ((0, 1),) * 4 + ((0.5, 1.5),)]
    alpha = torch.tensor(0.3, dtype=accum)
    want = axpy_precond_partials_plain(*vecs, alpha, accum_dtype=accum)
    part = axpy_precond_partials(*vecs, alpha, accum_dtype=accum)
    wrap = (*part[:3], part[3].sum(), part[4].sum())
    return part, wrap, want


@pytest.mark.parametrize("storage,accum", [
    (torch.float64, torch.float64), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32)])
def test_axpy_bitwise_accepts_the_plain_partials(storage, accum):
    part, wrap, want = _axpy_case(storage, accum)
    same = chip_smoke.axpy_bitwise(torch, part, wrap, want)
    assert same == {k: True for k in ("x'", "r'", "z", "r.z partials", "r.z",
                                      "r.r partials", "r.r")}


def test_axpy_bitwise_flags_each_output():
    part, wrap, want = _axpy_case(torch.float64, torch.float64)
    bumped = lambda t: t + torch.finfo(t.dtype).eps * t.abs().max()  # noqa
    cases = {
        "x'": ((bumped(part[0]), *part[1:]), wrap),
        "z": (part, (*wrap[:2], bumped(wrap[2]), *wrap[3:])),
        "r.z partials": ((*part[:3], bumped(part[3]), part[4]), wrap),
        "r.r partials": ((*part[:4], part[4][:-1]), wrap),
        # a dot summed in another order than torch.sum of the partials
        "r.r": (part, (*wrap[:4], bumped(wrap[4]))),
    }
    for name, (p, w) in cases.items():
        same = chip_smoke.axpy_bitwise(torch, p, w, want)
        assert [k for k, v in same.items() if not v] == [name], name


def test_no_plain_versions_refuses_every_plain_version_then_restores():
    import importlib

    mods = {m: importlib.import_module(f"repro_torch.kernels.{m}.{m}")
            for m in ("spmv_dia", "krylov_fused", "coef_update",
                      "krylov_loop")}
    # every listed plain version exists in this tree: none is skipped
    before = {name: getattr(mods[m], name)
              for m, name in chip_smoke.PLAIN_VERSIONS}
    with chip_smoke.no_plain_versions():
        for m, name in chip_smoke.PLAIN_VERSIONS:
            with pytest.raises(chip_smoke.SmokeFailure, match=name):
                getattr(mods[m], name)()
    assert {name: getattr(mods[m], name)
            for m, name in chip_smoke.PLAIN_VERSIONS} == before


def test_loop_summary_holds_every_sweep_to_its_read_bound():
    """The device loop's records: each sweep's host reads at most
    ceil(iterations / K) + 4, or the check fails."""
    from repro_torch.solvers.device_loop import LoopRecord

    ok = [LoopRecord(2460, 309, 310, 0.0031, 8, "cuda", "cg",
                     _launches("cg", 2460)),
          LoopRecord(0, 0, 1, 0.0, 8, "cuda", "cg")]
    summ = chip_smoke.loop_summary(ok)
    assert summ["sweeps"] == [(2460, 309, 310, 3.1), (0, 0, 1, 0.0)]
    assert summ["host_reads"] == 311 and summ["K"] == [8]
    too_many = ok + [LoopRecord(16, 3, 9, 0.0, 8, "cuda", "cg",
                                _launches("cg", 16))]
    with pytest.raises(chip_smoke.SmokeFailure, match="bound 6 at K = 8"):
        chip_smoke.loop_summary(too_many)


def _launches(solver, iters):
    """The device counts of a sweep that launched what it should."""
    from repro_torch.kernels.device_counts import SLOTS

    return {name: chip_smoke.LOOP_LAUNCHES[solver].get(name, 0) * iters
            for name in SLOTS}


@pytest.mark.parametrize("solver,iters", [("cg", 2460), ("bicgstab", 21)])
def test_loop_summary_holds_the_device_counted_launches(solver, iters):
    """On the card each sweep's guarded launches, as the kernels counted
    them, must be the body's launches times the iterations: a replay that
    skipped a kernel, or ran one past the guard, fails the check."""
    from repro_torch.solvers.device_loop import LoopRecord

    good = _launches(solver, iters)
    chip_smoke.loop_summary([LoopRecord(iters, 8, 9, 0.0, 4, "cuda", solver,
                                        good)])
    for name in good:
        for delta in (-1, 1):
            bad = dict(good, **{name: good[name] + delta})
            with pytest.raises(chip_smoke.SmokeFailure,
                               match="counted the launches"):
                chip_smoke.loop_summary([LoopRecord(iters, 8, 9, 0.0, 4,
                                                    "cuda", solver, bad)])
    with pytest.raises(chip_smoke.SmokeFailure, match="counted the launches"):
        chip_smoke.loop_summary([LoopRecord(iters, 8, 9, 0.0, 4, "cuda",
                                            solver)])


def test_check_frames_covers_the_loop_kernels_when_asked():
    """The build phase adds the in-place axpy and cg_direction to the
    checked kernels; a log without them then fails."""
    kernels = chip_smoke.NO_FRAME_KERNELS + chip_smoke.LOOP_NO_FRAME_KERNELS
    with pytest.raises(chip_smoke.SmokeFailure, match="no instance"):
        chip_smoke.check_frames(chip_smoke.ptxas_report(CLEAN), kernels)
    inplace = AXPY.replace("19axpy_precond_kernel",
                           "27axpy_precond_inplace_kernel")
    direction = "_Z19cg_direction_kernelIddEvPT_PKS0_PKT0_S6_PKbx"
    extra = "".join(
        f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {fn}\n"
        f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        f"loads\nptxas info    : Used 29 registers, used 0 barriers\n"
        for fn in (inplace, direction))
    counts = chip_smoke.check_frames(chip_smoke.ptxas_report(CLEAN + extra),
                                     kernels)
    assert counts["axpy_precond_inplace_kernel"] == 1
    assert counts["cg_direction_kernel"] == 1


# two instantiations of the fold as ptxas names them on the H100 (CUDA
# 12.8): f64 for one lane and bf16 for a cohort
FOLD = ("_Z25spmv_dot_direction_kernelIddLi7ELb0EEvPKT_S2_PS0_S3_S3_PT0_"
        "PKS4_PKiN5repro7DiaArgsE")
FOLD_LANES = ("_Z25spmv_dot_direction_kernelI13__nv_bfloat16fLi7ELb1EEvPKT_"
              "S3_PS1_S4_S4_PT0_PKS5_PKiN5repro7DiaArgsE")


def _record(fn: str, frame: int = 0) -> str:
    return (f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {fn}\n"
            f"    {frame} bytes stack frame, {frame} bytes spill stores, "
            f"{frame} bytes spill loads\n"
            f"ptxas info    : Used 128 registers, used 1 barriers\n")


TAIL_ALPHA = "_Z15cg_alpha_kernelIdEvPKT_xxPS0_S2_S3_PKbPy"
TAIL_ADVANCE = "_Z17cg_advance_kernelIfEvPT_S1_S1_S1_PiPbPKS0_iS1_S5_S5_xxPy"


def _sass(name: str, *instructions: str) -> str:
    body = "".join(f"        /*{16 * i:04x}*/   {op} ;\n"
                   for i, op in enumerate(instructions))
    return f"\t\tFunction : {name}\n\t.headerflags @\"EF_CUDA_SM90\"\n{body}"


@pytest.mark.parametrize("bad", ["ATOMG.E.ADD.STRONG.GPU PT, R2, [R2.64], R5",
                                 "RED.E.ADD.F64.RN.STRONG.GPU [R2.64], R4",
                                 "ATOMS.ADD RZ, [R3], R4"])
def test_sass_atomics_counts_atomics_in_the_tail_kernels_only(bad):
    """The build phase reads the tail kernels' SASS: every instantiation
    counted, an atomic or reduction instruction in either found, one in
    another kernel ignored, a kernel without code an error."""
    kernels = chip_smoke.TAIL_NO_FRAME_KERNELS
    clean = (_sass(TAIL_ALPHA, "LDG.E.128.CONSTANT R4, [R2.64]",
                   "UCGABAR_ARV", "DADD R4, R4, R6")
             + _sass(TAIL_ADVANCE, "SHFL.DOWN PT, R5, R4, 0x10, 0x1f",
                     "STG.E.64 [R2.64], R4")
             + _sass(FOLD, bad))
    assert chip_smoke.sass_atomics(clean, kernels) == {
        "cg_alpha_kernel": 0, "cg_advance_kernel": 0}
    got = chip_smoke.sass_atomics(clean + _sass(TAIL_ADVANCE, "EXIT", bad),
                                  kernels)
    assert got == {"cg_alpha_kernel": 0, "cg_advance_kernel": 1}
    with pytest.raises(chip_smoke.SmokeFailure, match="no code"):
        chip_smoke.sass_atomics(_sass(TAIL_ALPHA, "EXIT"), kernels)


@pytest.mark.parametrize("tool", ["missing", "clean", "atomic"])
def test_check_tail_atomics_reads_the_sass_or_fails(tool, tmp_path,
                                                    monkeypatch):
    """The build phase's atomics check runs the ``cuobjdump`` beside
    ``nvcc`` on the tail kernels' library: clean SASS passes, an atomic in
    a tail kernel fails, and no ``cuobjdump`` (beside ``nvcc`` or on
    ``PATH``) fails rather than passing unread."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "nvcc"))
    monkeypatch.setattr(chip_smoke.shutil, "which", lambda name: None)
    if tool != "missing":
        body = (_sass(TAIL_ALPHA, "DADD R4, R4, R6")
                + _sass(TAIL_ADVANCE, "ATOMG.E.ADD.STRONG.GPU PT, R2, "
                                      "[R2.64], R5" if tool == "atomic"
                        else "EXIT"))
        (tmp_path / "sass.txt").write_text(body)
        fake = tmp_path / "cuobjdump"
        fake.write_text(f"#!/bin/sh\ncat {tmp_path / 'sass.txt'}\n")
        fake.chmod(0o755)
    if tool == "clean":
        chip_smoke.check_tail_atomics()
        return
    match = "no cuobjdump" if tool == "missing" else "use atomics"
    with pytest.raises(chip_smoke.SmokeFailure, match=match):
        chip_smoke.check_tail_atomics()


def test_check_frames_covers_the_fold():
    """Since the fold the build phase checks spmv_dot_direction_kernel too:
    a log without it fails, every instantiation clean passes, and a frame
    in any one of them fails."""
    kernels = chip_smoke.NO_FRAME_KERNELS + chip_smoke.FOLD_NO_FRAME_KERNELS
    assert chip_smoke.FOLD_NO_FRAME_KERNELS == ("spmv_dot_direction_kernel",)
    assert chip_smoke.base_name(FOLD) == "spmv_dot_direction_kernel"
    with pytest.raises(chip_smoke.SmokeFailure, match="no instance"):
        chip_smoke.check_frames(chip_smoke.ptxas_report(CLEAN), kernels)
    log = CLEAN + _record(FOLD) + _record(FOLD_LANES)
    counts = chip_smoke.check_frames(chip_smoke.ptxas_report(log), kernels)
    assert counts["spmv_dot_direction_kernel"] == 2
    with pytest.raises(chip_smoke.SmokeFailure, match="8 bytes stack frame"):
        chip_smoke.check_frames(chip_smoke.ptxas_report(
            CLEAN + _record(FOLD) + _record(FOLD_LANES, 8)), kernels)


def test_the_cg_loop_launches_the_fold_and_never_the_unfused_pair():
    """A CG iteration is the fold, cg_alpha, the in-place axpy and
    cg_advance once each: a sweep whose device counters show a launch of
    the unfused cg_direction or spmv_dot fails, and neither is a kernel
    the step must launch."""
    from repro_torch.solvers.device_loop import LoopRecord

    assert chip_smoke.LOOP_LAUNCHES["cg"] == {
        "spmv_dot_direction": 1, "cg_alpha": 1, "axpy_precond": 1,
        "cg_advance": 1}
    assert {"spmv_dot_direction", "cg_alpha"} <= set(chip_smoke.STEP_KERNELS)
    assert not set(chip_smoke.UNFUSED_KERNELS) & set(chip_smoke.STEP_KERNELS)
    assert not set(chip_smoke.UNFUSED_KERNELS) & set(
        chip_smoke.KRYLOV_KERNELS)
    good = _launches("cg", 100)
    assert good["cg_direction"] == good["spmv_dot"] == 0
    chip_smoke.loop_summary([LoopRecord(100, 14, 15, 0.0, 8, "cuda", "cg",
                                        good)])
    for name in chip_smoke.UNFUSED_KERNELS:
        with pytest.raises(chip_smoke.SmokeFailure,
                           match="counted the launches"):
            chip_smoke.loop_summary([LoopRecord(
                100, 14, 15, 0.0, 8, "cuda", "cg", dict(good, **{name: 100}))])


# ---------------------------------------------------------------------------
# phase 12's pure helpers, on canned numbers
# ---------------------------------------------------------------------------

def test_fit_line_recovers_a_line_and_its_error():
    xs = (1, 2, 3, 5, 6, 10, 15, 30)
    c0, c1, se = chip_smoke.fit_line(xs, [2e-3 + 4e-6 * x for x in xs])
    assert c0 == pytest.approx(2e-3, rel=1e-12)
    assert c1 == pytest.approx(4e-6, rel=1e-9) and se < 1e-15
    noisy = [2e-3 + 4e-6 * x + (1e-6 if i % 2 else -1e-6)
             for i, x in enumerate(xs)]
    c0n, c1n, sen = chip_smoke.fit_line(xs, noisy)
    want = np.polyfit(np.array(xs, float), np.array(noisy), 1)
    assert (c1n, c0n) == pytest.approx(tuple(want), rel=1e-9)
    assert sen > 0


def _sweep(update_s, ms_per_iter, assembly=0.40, n_dofs=210 ** 3, parts=30):
    return [{"alpha": a, "rows": n_dofs * a // parts, "assembly_s": assembly,
             "update_s": u, "ms_per_iter": ms}
            for a, u, ms in zip(chip_smoke.SWEEP_ALPHAS, update_s,
                                ms_per_iter)]


def test_measured_spec_reads_each_field():
    alphas = chip_smoke.SWEEP_ALPHAS
    n = 210 ** 3
    sweep = _sweep([0.7e-3 + 2e-6 * a for a in alphas],
                   [0.60, 0.56, 0.55, 0.54, 0.54, 0.535, 0.535, 0.535])
    spec = chip_smoke.measured_spec(sweep, n, 30, 666e6, 0.2239e-3,
                                    256 * 2 ** 20, 5e-3)
    assert spec["hbm_bw"] == (pytest.approx(666e6 / 0.2239e-3), "value")
    assert spec["link_bw"][0] == pytest.approx(64 * n / 0.7e-3)
    assert spec["msg_latency"] == (pytest.approx(2e-6), "value")
    host_bw = 200 * n * (0.001 + 1 / 30) / 0.40
    assert spec["host_bw"] == (pytest.approx(host_bw), "fitted")
    assert spec["host_flops"] == (pytest.approx(host_bw * 250 / 200),
                                  "fitted")
    # the knee: the alpha-1 parts run at 0.535 / 0.60 of the saturated
    # rate, which the model's square-root law places below the knee
    assert spec["dofs_sat"] == (pytest.approx(n / 30 / (0.535 / 0.60) ** 2),
                                "fitted")
    assert spec["h2d_bw"][0] == pytest.approx(256 * 2 ** 20 / 5e-3)
    # a flat update leaves only a bound on the latency
    flat = chip_smoke.measured_spec(
        _sweep([0.7e-3 + (1e-7 if a % 2 else -1e-7) for a in alphas],
               [0.535] * 8), n, 30, 666e6, 0.2239e-3, 1.0, 1.0)
    lat, kind = flat["msg_latency"]
    assert kind == "at most" and 0 < lat < 1e-7
    # a flat rate only bounds the knee: at or below the smallest parts,
    # also where the smallest parts lose a little to noise
    assert flat["dofs_sat"] == (n // 30, "at most")
    near = chip_smoke.measured_spec(
        _sweep([0.7e-3] * 8, [0.5265, 0.5248, 0.5254, 0.5268, 0.5251,
                              0.5274, 0.5256, 0.5250]),
        n, 30, 666e6, 0.2239e-3, 1.0, 1.0)
    assert near["dofs_sat"] == (n // 30, "at most")


def test_check_spec_fails_a_field_off_by_more_than_2x():
    from repro_torch.core.cost_model import HardwareSpec

    shipped = HardwareSpec(name="h100", peak_flops=34e12, hbm_bw=3.0e12,
                           link_bw=8e11, host_flops=2e8, host_bw=1.6e8,
                           h2d_bw=2.5e10, dofs_sat=3e5, oversub_penalty=0.0,
                           msg_latency=1e-7)
    good = {"hbm_bw": (2.9e12, "value"), "link_bw": (1.5e12, "value"),
            "host_bw": (0.9e8, "fitted"), "host_flops": (1.1e8, "fitted"),
            "h2d_bw": (4.9e10, "value"), "dofs_sat": (3.1e5, "at most"),
            "msg_latency": (6e-8, "at most")}
    assert chip_smoke.check_spec(good, shipped) == []
    # a bound passes any knee below it, however far
    assert chip_smoke.check_spec(dict(good, dofs_sat=(3.1e7, "at most")),
                                 shipped) == []
    # the TPU's link and a spec-sheet HBM rate are caught; a latency above
    # twice its measured bound too, a fitted field off by 2x, and the JAX
    # package's knee of 1e6 above twice the bound
    bad = dict(good, link_bw=(5e10, "value"), hbm_bw=(1.4e12, "value"),
               msg_latency=(4e-8, "at most"), host_bw=(3.3e8, "fitted"),
               dofs_sat=(3.087e5, "at most"))
    off = chip_smoke.check_spec(bad, dataclasses.replace(shipped,
                                                         dofs_sat=1e6))
    assert [o.split(":")[0] for o in off] == ["hbm_bw", "link_bw",
                                              "host_bw", "dofs_sat",
                                              "msg_latency"]


@pytest.mark.parametrize("points,want", [
    # the kernels win at every size: the smallest size measured
    ([(512, 0.05, 0.09), (2048, 0.05, 0.10), (308700, 0.53, 1.4)], 512),
    # plain PyTorch wins the small parts
    ([(512, 0.09, 0.05), (2048, 0.07, 0.06), (8192, 0.07, 0.08),
      (308700, 0.53, 1.4)], 8192),
    # a loss above a win: the crossover starts above the loss
    ([(512, 0.05, 0.09), (2048, 0.08, 0.06), (308700, 0.53, 1.4)], 308700),
    # the kernels lose at the largest size: no crossover
    ([(512, 0.05, 0.09), (308700, 1.5, 1.4)], None),
])
def test_crossover_rows_reads_the_smallest_winning_size(points, want):
    assert chip_smoke.crossover_rows(points) == want
    assert chip_smoke.crossover_rows(points[::-1]) == want


# ---------------------------------------------------------------------------
# phase 13's helpers
# ---------------------------------------------------------------------------

def test_lane_abi_tells_this_tree_from_an_older_one(tmp_path):
    assert chip_smoke.lane_abi(ROOT / "src" / "repro_torch" / "csrc")
    (tmp_path / "spmv_dia.cu").write_text(
        'extern "C" int spmv_dia_launch(int c, const void* b, long long P,'
        ' int nb, void* stream);')
    assert not chip_smoke.lane_abi(tmp_path)
    sigs = chip_smoke.single_lane_signatures()
    assert len(sigs["spmv_dia"]["spmv_dia_launch"]) == 9
    assert len(sigs["krylov_fused"]["spmv_dot_launch"]) == 10
    assert len(sigs["krylov_fused"]["axpy_precond_launch"]) == 14


def test_lane_part_slices_vectors_partials_and_scalars():
    B, npl, stride = 3, 2, 4
    vec = torch.arange(12.0).reshape(6, 2)
    part = torch.arange(12.0)
    scal = torch.arange(3.0)
    got = chip_smoke.lane_part("spmv_dot", (vec, part), 1, B, (npl, stride))
    assert torch.equal(got[0], torch.tensor([4.0, 5.0, 6.0, 7.0]))
    assert torch.equal(got[1], torch.tensor([4.0, 5.0]))
    (s,) = chip_smoke.lane_part("cg_advance", (scal,), 2, B, (npl, stride))
    assert s.tolist() == [2.0]


@pytest.fixture
def tiny_phase13(monkeypatch):
    """Phase 13a's shapes cut to a tiny mesh, on the CPU: the wrappers run
    their plain versions there, so the kernel runs are plain too."""
    monkeypatch.setattr(chip_smoke, "N", 8)
    monkeypatch.setattr(chip_smoke, "PARTS", 4)
    monkeypatch.setattr(chip_smoke, "ALPHA", 4)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "no_plain_versions",
                        chip_smoke.contextlib.nullcontext)


def test_lane_kernel_phase_checks_pass_on_plain_lanes(tiny_phase13):
    problems = []
    out = chip_smoke.lane_kernel_phase(torch, torch.device("cpu"), problems)
    assert problems == []
    assert set(out) == {"float64", "float32", "bfloat16"}
    assert all(all(row.values()) for rows in out.values()
               for row in rows.values())


def test_lane_kernel_phase_catches_a_lane_leak(tiny_phase13, monkeypatch):
    """A lane kernel that reads across a lane border (here: the SpMV taking
    the cohort as one system) fails the solo and NaN checks."""
    from repro_torch.kernels.spmv_dia import spmv_dia as mod

    plain = mod.spmv_dia_plain

    def leaky(bands, x, **kw):
        kw.pop("lanes", None)
        return plain(bands, x, **kw)

    monkeypatch.setattr(mod, "spmv_dia_plain", leaky)
    problems = []
    chip_smoke.lane_kernel_phase(torch, torch.device("cpu"), problems)
    assert any("spmv_dia" in p and "vs_solo" in p for p in problems)
    assert any("spmv_dia" in p and "nan_mates" in p for p in problems)


def test_lane_report_flags_drift_and_counts():
    from repro_torch.fvm.piso import PisoState, StepStats

    def state(v):
        return PisoState(*(torch.full((2, 3), v, dtype=torch.float64)
                           for _ in range(5)))

    def stats(it):
        t = torch.tensor
        return StepStats(t(it), t([5, 5]), t(1e-9), t(1e-9), t(True),
                         t(False), t(False))

    problems = []
    assert chip_smoke.lane_report(torch, state(1.0), state(1.0), stats(3),
                                  stats(3), "x", problems) == (True, 0.0)
    assert problems == []
    bitwise, worst = chip_smoke.lane_report(torch, state(1.0 + 1e-12),
                                            state(1.0), stats(3), stats(4),
                                            "y", problems)
    assert not bitwise and worst > 0
    assert problems == ["y: counts or flags differ from its solo run "
                        "(3, [5, 5] against 4, [5, 5])"]
    chip_smoke.lane_report(torch, state(1.1), state(1.0), stats(3),
                           stats(3), "z", problems)
    assert problems[-1].startswith("z: ")


# ---------------------------------------------------------------------------
# phase 14's helpers and parts, at a tiny size on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def tiny_phase14(tiny_phase13, monkeypatch):
    """Phase 14 cut to tiny meshes on the CPU (the 210^3 parts on
    cube(8, 4), the 13c class on 4^3 in 2 parts, the launcher on the
    CPU)."""
    monkeypatch.setattr(chip_smoke, "SMALL_ARGS", ["--cfd-n", "4",
                                                   "--parts", "2"])
    monkeypatch.setattr(chip_smoke, "SMALL_CLASS", 2)
    monkeypatch.setattr(chip_smoke, "SMALL_TENANTS", 2)
    monkeypatch.setattr(chip_smoke, "SMALL_STEPS", 2)
    monkeypatch.setattr(chip_smoke, "CLI_ARGS",
                        ["--cfd-n", "4", "--parts", "2", "--sessions", "2",
                         "--scan-steps", "4", "--adaptive", "--device",
                         "cpu"])
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)


def _tiny_state(steps):
    from repro_torch.fvm.mesh import CavityMesh
    from repro_torch.fvm.piso import make_solver

    mesh = CavityMesh.cube(8, 4)
    solver = make_solver("piso", mesh, alpha=4, p_tol=1e-10, p_maxiter=6000,
                         device="cpu")
    return solver.run_steps(solver.initial_state(), 0.5 * mesh.h, steps)[0] \
        if steps else solver.initial_state()


def test_phase14_cohort_fault_and_resume_hold_on_the_cpu(tiny_phase14,
                                                         tmp_path):
    """14a and 14d in process: t2 rolled back and retried solo, bitwise
    an unsupervised step from its checkpoint; t0 and t1 bitwise 13b's
    cohort; the snapshot restored into a fresh engine bitwise 13b's end
    states, its posture round-tripped."""
    dev = torch.device("cpu")
    state3, problems, ends = _tiny_state(3), [], {}
    chip_smoke.full_width_phase(torch, dev, state3, problems, ends)
    assert set(ends) == {"t0", "t1", "t2"}
    problems = []
    snap = str(tmp_path / "engine")
    out = chip_smoke.nan_cohort_phase(torch, dev, state3, ends,
                                      {"steps_per_s": 1.0, "peak_gib": 0.0},
                                      snap, problems)
    assert problems == []
    assert out["t2"]["bitwise"] and all(out["mates_bitwise"].values())
    assert [g for g, _ in out["windows"]] == [["t0", "t1", "t2"]] * 2 + [
        ["t2"]]
    assert out["snapshot"]["bytes"] == chip_smoke.dir_bytes(snap) > 0
    res = chip_smoke.resume_phase(torch, dev, ends, snap, out["posture"],
                                  problems)
    assert problems == [] and all(res["bitwise"].values())
    # a posture that did not round-trip is caught
    bad = dict(out["posture"], t0=dict(out["posture"]["t0"], tols=()))
    chip_smoke.resume_phase(torch, dev, ends, snap, bad, problems)
    assert len(problems) == 1 and problems[0].startswith("14d: restored")


def test_phase14_ladder_climbs_from_a_faulting_start(tiny_phase14):
    """14b from rest on cube(8, 4), where bf16_ir faults in its first
    window: the f32_ir retry bitwise the tenant opened at f32_ir.  From
    the developed state it first faults a window later, which the phase
    reports."""
    dev = torch.device("cpu")
    problems = []
    out = chip_smoke.ladder_phase(torch, dev, _tiny_state(0), problems)
    assert problems == []
    assert out["faulted_first"] and out["fault"] == "diverged"
    assert out["retry_bitwise"]
    assert out["precision"] == ("f32_ir", "f32_ir", "f32_ir", "bf16_ir")


def test_phase14_escalation_on_the_cpu(tiny_phase14):
    """14c on 4^3 tenants: every check but the launch counters (the CPU
    runs the plain versions, which count nothing) passes."""
    problems = []
    out = chip_smoke.escalation_phase(torch, torch.device("cpu"), problems)
    assert all("launches" in p or "after recovery" in p
               or "value updates" in p for p in problems)
    assert len(problems) == 4
    assert out["cap"]["events"] == ["fault", "degrade", "fault",
                                    "quarantine", "fault", "fail"]
    assert [r["state"] for r in out["quarantine"]["requests"]] == [
        "degraded", "quarantined", "degraded", "degraded", "healthy"]
    assert [r["backend_before"] for r in out["quarantine"]["requests"]] == [
        "auto", "auto", "reference", "auto", "auto"]
    assert out["chaos"]["slow_events"] == []
    assert out["chaos"]["blowup_events"][-1] == "restore"
    assert out["cost"]["bitwise"]


def test_phase14_cli_kill_and_resume_on_the_cpu(tiny_phase14, tmp_path):
    problems = []
    out = chip_smoke.cli_phase(torch, str(tmp_path), problems)
    assert problems == [] and out["resumed_equal"]
    assert any(line.startswith("supervision:") for line in out["chaos"])


def test_phase14_helpers():
    assert chip_smoke.digest_lines("x\ndigest b 2\ndigest a 1\n") == [
        ["a", "1"], ["b", "2"]]
    before = dict.fromkeys(chip_smoke.KRYLOV_KERNELS + ("coef_update",), 1)
    after = dict(before, coef_update=4)
    moved = chip_smoke.krylov_moved(before, after)
    assert moved["coef_update"] == 3 and not any(
        moved[k] for k in chip_smoke.KRYLOV_KERNELS)


def test_raw_launchers_pass_every_argument(monkeypatch):
    """The raw launches phase 3 times (the in-place axpy, the two SpMVs)
    pass as many arguments as each entry point's ctypes signature holds:
    a library built from this tree would refuse any other count."""
    import types

    from repro_torch.kernels import _build
    from repro_torch.kernels.spmv_dia import spmv_dia as sd

    seen = {}

    def entry(lib, fn):
        def call(*args):
            seen[fn] = len(args) == len(_build._SIGNATURES[lib][fn])
            return 0
        return call

    fake = {lib: types.SimpleNamespace(**{fn: entry(lib, fn) for fn in sigs})
            for lib, sigs in _build._SIGNATURES.items()}
    monkeypatch.setattr(_build, "load", lambda name: fake[name])
    monkeypatch.setattr(sd, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    vecs = [torch.zeros(2, 256, dtype=torch.float64) for _ in range(5)]
    alpha = torch.tensor(0.5, dtype=torch.float64)
    chip_smoke.axpy_inplace_launchers(torch, vecs, alpha, torch.float64)[1]()
    bands = torch.zeros(2, 7, 256, dtype=torch.float64)
    for name in ("spmv_dia", "spmv_dot"):
        chip_smoke.spmv_launcher(torch, name, bands, vecs[0],
                                 (-16, -4, -1, 0, 1, 4, 16),
                                 torch.float64)()
    assert seen == {"axpy_precond_inplace_launch": True,
                    "spmv_dia_launch": True, "spmv_dot_launch": True}


# ---------------------------------------------------------------------------
# phase 4b's bitwise comparison, and phase 15 at a tiny size on the CPU
# ---------------------------------------------------------------------------

def test_same_bits_matches_nan_payloads_and_signed_zeros():
    nan = torch.tensor([float("nan"), 1.0, -0.0], dtype=torch.float64)
    assert not torch.equal(nan, nan.clone())
    assert chip_smoke.same_bits(torch, nan, nan.clone())
    assert not chip_smoke.same_bits(torch, nan, nan.abs())  # -0.0 vs +0.0
    other = nan.clone()
    other.view(torch.int64)[0] += 1  # another NaN payload
    assert not chip_smoke.same_bits(torch, nan, other)
    for dtype in (torch.float32, torch.bfloat16):
        assert chip_smoke.same_bits(torch, nan.to(dtype), nan.to(dtype))
    assert chip_smoke.same_bits(torch, torch.tensor(3), torch.tensor(3))
    assert not chip_smoke.same_bits(torch, nan, nan.to(torch.float32))


def _refined_system(nan_start: bool):
    from repro_torch.fvm.mesh import CavityMesh
    from repro_torch.fvm.piso import make_solver

    mesh = CavityMesh.cube(8, 4)
    solver = make_solver("piso", mesh, alpha=4, p_tol=1e-10, p_maxiter=40,
                         solver_backend="fused", device="cpu")
    bands, b, x0, diag = chip_smoke.pressure_system(
        solver, solver.initial_state(), 0.5 * mesh.h)
    if nan_start:
        x0 = x0.clone()
        x0[0, 0] = float("nan")
    return solver, bands, b, x0, diag


@pytest.mark.parametrize("nan_start", [False, True])
def test_refined_vs_host_holds_loops_bitwise_through_nan(tiny_phase13,
                                                         nan_start):
    """4b's f32_ir comparison from rest: the device loop against the host
    loop by bits, so a solve that ends in NaN on both loops alike (the
    210^3 one from rest diverges) passes, and a NaN start as well."""
    solver, bands, b, x0, diag = _refined_system(nan_start)
    out = chip_smoke.refined_vs_host(torch, "f32_ir", solver, bands, b, x0,
                                     diag)
    assert out["x_finite"] is not nan_start
    assert solver.precision == "f64"


def test_solves_match_reads_counts_flags_and_bits():
    from repro_torch.solvers.cg import CGResult

    def res(x, iters=5):
        t = torch.tensor
        return CGResult(x, t(iters), t(float("nan")), t(False), t(True),
                        t(3))

    x = torch.tensor([float("nan"), 2.0], dtype=torch.float64)
    fields, same = chip_smoke.solves_match(torch, res(x), res(x.clone()))
    assert same and fields["iters"] == (5, 5)
    assert not chip_smoke.solves_match(torch, res(x), res(x, 6))[1]
    assert not chip_smoke.solves_match(torch, res(x), res(x + 1))[1]


def test_lane_problems_and_launches_per_iteration():
    assert chip_smoke.lane_problems(
        [("spmv_dot_direction", 30), ("spmv_dia_stacked", 1),
         ("spmv_dia_stacked", 30)], 30) == []
    probs = chip_smoke.lane_problems(
        [("spmv_dot_direction", 1), ("spmv_dia_stacked", 1)], 30)
    assert len(probs) == 2
    from repro_torch.solvers.device_loop import LoopRecord

    recs = [LoopRecord(10, 3, 4, 0.0, 8, "cuda", "cg",
                       {"spmv_dot_direction": 10, "cg_alpha": 10,
                        "axpy_precond": 10, "cg_advance": 10,
                        "spmv_dia": 0}),
            LoopRecord(6, 2, 3, 0.0, 8, "cuda", "cg",
                       {"spmv_dot_direction": 6, "cg_alpha": 6,
                        "axpy_precond": 6, "cg_advance": 6, "spmv_dia": 0}),
            LoopRecord(4, 2, 3, 0.0, 2, "cuda", "bicgstab",
                       {"spmv_dia": 8})]
    assert chip_smoke.loop_launches_per_iter(recs) == {
        name: 1.0 for name in chip_smoke.LOOP_LAUNCHES["cg"]}
    assert chip_smoke.loop_launches_per_iter([]) == {}


def test_shard_sum_is_one_fixed_order():
    from repro_torch.sparse.shardmap_spmv import shard_dots, shard_sum

    rng = np.random.default_rng(0)
    parts = torch.tensor(rng.standard_normal(30))
    assert torch.equal(shard_sum(parts), shard_sum(parts.clone()))
    a, b = (torch.tensor(rng.standard_normal((2, 60))) for _ in range(2))
    per = torch.stack([torch.sum(u * v) for u, v in
                       zip(a.reshape(30, -1), b.reshape(30, -1))])
    assert torch.allclose(shard_dots(a, b, 30), per.sum(), rtol=1e-14)


@pytest.fixture
def tiny_phase15(tiny_phase13, monkeypatch, one_thread):
    """Phase 15 cut to cube(8, 4) with its shards on the CPU: the fused
    full-mesh bundle runs the wrappers' plain versions there (the launch
    counters stay at 0, so that check is the card's alone).  15f: ``cpu``
    in the card's place and ``cpu:0`` in the host's, (a) on the (1, 4)
    mesh with shard 3 on ``cpu:0``, (b) at the 12-part mesh of a 16^3
    serving mix."""
    monkeypatch.setattr(chip_smoke, "MAIN_ARGS", [
        "--n", "8", "--parts", "4", "--alpha", "4", "--steps", "3",
        "--co", "0.5", "--p-tol", "1e-10", "--p-maxiter", "6000",
        "--solver-backend", "fused", "--device", "cpu"])
    monkeypatch.setattr(chip_smoke, "FULL_MESH_ALPHAS", (4, 2))
    monkeypatch.setattr(chip_smoke, "MESH_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "time_ms", lambda torch, fn, **k: 0.0)
    monkeypatch.setattr(chip_smoke, "require_launched", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "HOST_DEVICE", "cpu:0")
    monkeypatch.setattr(chip_smoke, "RANKS_HOST_POSITIONS", (3,))
    monkeypatch.setattr(chip_smoke, "SMALL_ARGS", ["--cfd-n", "16",
                                                   "--parts", "16"])
    monkeypatch.setattr(chip_smoke, "ranks_launch_problems",
                        lambda *a: [])
    monkeypatch.setattr(chip_smoke, "smi_line", lambda: "CPU, no card")
    monkeypatch.setattr(chip_smoke, "no_plain_versions",
                        lambda cuda_only=False: contextlib.nullcontext())


def test_phase15_holds_on_the_cpu(tiny_phase15, capsys):
    out = chip_smoke.full_mesh_phase(torch, _tiny_state(3))
    assert {a: s["mesh"] for a, s in out["steps"].items()} == {
        4: {"solve": 1, "assemble": 4}, 2: {"solve": 2, "assemble": 2}}
    assert all(all(s["same"].values()) for s in out["steps"].values())
    assert out["loop"]["iters"] > 0
    assert all(v is not None for v in out["errors"].values())
    assert len(out["timing"]["full"]) == 2
    ranks = out["ranks"]
    assert ranks["a"]["mesh"] == [1, 4] and ranks["a"]["iters"] > 0
    assert [r["device"] for r in ranks["a"]["ranks"]] == ["cpu", "cpu:0"]
    assert ranks["b"]["mesh"] == [3, 4]
    assert ranks["b"]["carried"]["solve_halo"]["bytes"] \
        == ranks["b"]["forms"]["solve_halo"] > 0
    printed = capsys.readouterr().out
    assert "[15] the full mesh" in printed
    assert "15f(a) (1, 4), shards [3] on cpu:0" in printed
    assert "rank cpu:0 (1 shards)" in printed


def test_phase15_catches_dropped_halo_terms(tiny_phase15, monkeypatch,
                                            capsys):
    """A full mesh that drops the halo terms (each shard solved as if cut
    off from its neighbours) fails the SpMV check and the step checks.
    Its pressure CG cannot converge (each shard's block is singular), so
    the cap is cut from 6000 to 200 iterations; a healthy solve at this
    size takes 79-81."""
    from repro_torch.sparse import shardmap_spmv

    args = list(chip_smoke.MAIN_ARGS)
    args[args.index("--p-maxiter") + 1] = "200"
    monkeypatch.setattr(chip_smoke, "MAIN_ARGS", args)
    monkeypatch.setattr(shardmap_spmv, "_add_halo", lambda *a, **k: None)
    with pytest.raises(chip_smoke.SmokeFailure, match="phase 15"):
        chip_smoke.full_mesh_phase(torch, _tiny_state(3))
    printed = capsys.readouterr().out
    assert "FAILED: 15a x = p: the shard SpMV differs" in printed
    assert "counts or flags differ from the stacked step" in printed


def test_15f_closed_forms_at_210_and_on_the_mix_mesh():
    """(a): the 210^3 (1, 30) mesh with shards 28-29 on the host, 308,700
    rows a shard, 7 bands, planes of 44,100; (b): the 12-part 64 x 64 x 48
    mix mesh on (3, 4) with 10-11 on the host, 16,384 rows a shard,
    planes of 4,096, two solves a step."""
    a = chip_smoke.host_mesh_devices(30, chip_smoke.RANKS_HOST_POSITIONS)
    rows = 2 * 308_700 * 8
    assert chip_smoke.ranks_forms(a, 308_700, 7, 44_100, 1) == {
        "bands_p": 7 * rows, "diag_c": rows, "b_c": rows, "x0_c": rows,
        "x_back": rows, "solve_halo": 705_600}
    assert chip_smoke.ranks_forms(a, 308_700, 7, 44_100, 201)[
        "solve_halo"] == 201 * 705_600
    b = chip_smoke.host_mesh_devices(12, chip_smoke.RANKS_MIX_HOST_POSITIONS)
    forms = chip_smoke.ranks_forms(b, 16_384, 7, 4_096, 10, solves=2)
    assert forms["solve_halo"] == 10 * 65_536
    assert forms["b_c"] == 2 * 2 * 16_384 * 8
    # every shard on the card: nothing between devices
    assert set(chip_smoke.ranks_forms(["cuda:0"] * 12, 16_384, 7, 4_096,
                                      10).values()) == {0}
    plain = chip_smoke.mix_mesh(padded=False)
    assert (plain.n_parts, plain.nx, plain.ny, plain.nz) == (12, 64, 64, 48)


def test_15f_problems_name_what_differs():
    """15f(a)'s check on synthetic runs: a clean run passes; another count,
    a flag, x off, r.r off and bytes off the closed forms are each
    named."""
    from repro_torch.core.layout import MoveStats

    x = torch.linspace(-1.0, 1.0, 12, dtype=torch.float64)
    forms = {"b_c": 16, "solve_halo": 32}
    ref = {"x": x, "rr": torch.tensor(4.0, dtype=torch.float64), "k": 200,
           "flags": (False, True)}
    run = dict(ref, kinds={"b_c": MoveStats(16, 16),
                           "solve_halo": MoveStats(64, 32)},
               carried={"b_c": [16, 0.1], "solve_halo": [32, 0.2],
                        "scalars": [99, 0.0]})
    assert chip_smoke.ranks_cg_problems(run, ref, forms, "t") == []
    bad = dict(run, k=199, flags=(True, False), x=x * (1 + 1e-9),
               rr=torch.tensor(4.0 * (1 + 1e-9), dtype=torch.float64),
               carried=dict(run["carried"], solve_halo=[31, 0.2]))
    text = "\n".join(chip_smoke.ranks_cg_problems(bad, ref, forms, "t"))
    assert "199 iterations, flags (True, False), against 200" in text
    assert "x off by" in text and "r.r" in text
    assert "the closed forms" in text and "counted" in text
    # within the bar: no problem
    near = dict(run, x=x * (1 + 1e-12))
    assert chip_smoke.ranks_cg_problems(near, ref, forms, "t") == []


def test_15f_launch_problems_count_the_card_rank():
    ok = {"spmv_dot": 7, "axpy_precond": 7, "spmv_dia": 1}
    calls = [("spmv_dot_partials", 28)] * 7 + [
        ("axpy_precond_inplace", 28)] * 7
    assert chip_smoke.ranks_launch_problems(ok, calls, 7, 28, "t") == []
    probs = chip_smoke.ranks_launch_problems(
        dict(ok, axpy_precond=8), calls + [("spmv_dot_partials", 30)], 7, 28,
        "t")
    assert any("axpy_precond launched 8 times in 7" in p for p in probs)
    assert any("lanes [28, 30], not 28" in p for p in probs)
    assert chip_smoke.ranks_launch_problems({}, [], 0, 28, "t") == [
        "t: the card's kernels ran with lanes [], not 28 (one a shard it "
        "holds)"]


def test_card_lane_spy_records_card_calls_only():
    from repro_torch.kernels.krylov_fused import krylov_fused as kf

    before = kf.spmv_dot_partials
    bands = torch.ones((2, 3, 8), dtype=torch.float64)
    x = torch.ones((2, 8), dtype=torch.float64)
    with chip_smoke.card_lane_spy() as calls:
        kf.spmv_dot_partials(bands, x, offsets=(-1, 0, 1), plane=1, lanes=2)
    assert calls == [] and kf.spmv_dot_partials is before


# ---------------------------------------------------------------------------
# phase 16: LM serving
# ---------------------------------------------------------------------------

def test_phase16_byte_floor_and_parameter_count():
    """qwen3-0.6b's decode floor: 2 bytes a parameter (595,984,384 by the
    config's count) and 28 x 2 x 8 x 576 x 8 x 128 x 2 bytes of K/V,
    1.72 GB at 3.35 TB/s: 0.51 ms a step."""
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.models import lm

    cfg = get_config("qwen3-0.6b")
    assert int(cfg.total_params()) == 595_984_384
    floor = chip_smoke.decode_floor(cfg, 8, 576, 2 * 595_984_384)
    assert floor["kv_bytes"] == 28 * 2 * 8 * 576 * 8 * 128 * 2
    assert floor["bytes"] == 2 * 595_984_384 + floor["kv_bytes"]
    assert floor["ms"] == pytest.approx(0.5136, abs=5e-4)
    # the windowed cache is a ring of W slots
    mixtral = get_smoke_config("mixtral-8x22b")
    assert chip_smoke.kv_cache_bytes(mixtral, 2, 100) == \
        2 * 2 * 2 * 8 * 2 * 16 * 4
    # the tree's count is the config's plus the norms' gains it leaves out
    smoke = get_smoke_config("qwen3-0.6b")
    params = lm.init_params(smoke, torch.Generator().manual_seed(0))
    norms = smoke.n_layers * (2 * smoke.d_model + 2 * smoke.hd) + smoke.d_model
    assert chip_smoke.tree_numel(params) == int(smoke.total_params()) + norms
    assert chip_smoke.tree_bytes(params) == 4 * chip_smoke.tree_numel(params)


def test_phase16_depth_cuts_keep_the_widths():
    from repro_torch.configs.registry import get_config

    want = {"mixtral-8x22b": 1, "jamba-v0.1-52b": 8, "rwkv6-1.6b": 24,
            "whisper-medium": 24, "paligemma-3b": 18}
    assert chip_smoke.FAMILY_LAYERS == want
    for arch, layers in want.items():
        cut, full = chip_smoke.family_config(arch), get_config(arch)
        assert (cut.n_layers, cut.dtype) == (layers, "float32"), arch
        assert dataclasses.replace(cut, n_layers=full.n_layers,
                                   dtype=full.dtype) == full, arch
        # every family's f32 weights fit the card (jamba's ~53 GB)
        assert 4 * cut.total_params() <= chip_smoke.F32_WEIGHT_LIMIT
    assert 4 * chip_smoke.family_config(
        "jamba-v0.1-52b").total_params() > 50e9
    # only mixtral and jamba are cut; jamba to one period of its stack
    assert chip_smoke.family_config("jamba-v0.1-52b").n_periods == 1
    assert [a for a in want if chip_smoke.family_config(a).n_layers
            < get_config(a).n_layers] == ["mixtral-8x22b", "jamba-v0.1-52b"]


def test_lm_flag_parses():
    assert chip_smoke.build_parser().parse_args(["--lm"]).lm
    assert not chip_smoke.build_parser().parse_args([]).lm


def test_phase16a_on_the_cpu(capsys):
    """Every SMOKE arch through 16a's runs, the CPU as both devices."""
    problems = []
    out = chip_smoke.smoke_archs_phase(torch, torch.device("cpu"), problems)
    assert not problems
    assert len(out) == 10 and all(r["tokens_equal"] for r in out.values())
    assert "[16a] whisper-medium" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-v0.1-52b",
                                  "whisper-medium", "paligemma-3b"])
def test_phase16_decode_vs_forward_on_the_cpu(arch, monkeypatch):
    """16b/16c's check on the SMOKE configs, and a decode at the wrong
    positions (one off) failing it."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import lm

    cfg = get_smoke_config(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(1))
    tokens, frontend = chip_smoke.lm_inputs(cfg, 2, 14)
    cpu = torch.device("cpu")
    r = chip_smoke.decode_vs_forward(torch, cfg, params, tokens, frontend, 4,
                                     cpu)
    assert r["err"] <= chip_smoke.LM_TOL and r["tokens_equal"]
    assert r["positions"] == 5
    if cfg.frontend != "audio_stub":  # whisper's decoder has no positions
        real = chip_smoke.n_prefix
        monkeypatch.setattr(chip_smoke, "n_prefix", lambda c: real(c) + 1)
        bad = chip_smoke.decode_vs_forward(torch, cfg, params, tokens,
                                           frontend, 4, cpu)
        assert bad["err"] > 10 * chip_smoke.LM_TOL


def test_decode_parts():
    assert chip_smoke.device_part(
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize64x64x64") == "matmul"
    assert chip_smoke.device_part("void cutlass::Kernel2<cutlass_80_wmma>") \
        == "matmul"
    assert chip_smoke.device_part(
        "void at::native::(anonymous namespace)::cunn_SoftMaxForward<4>") \
        == "softmax"
    assert chip_smoke.device_part("void rotary_something()") == "other"
    assert chip_smoke.device_part(
        "void at::native::reduce_kernel<512, 1>") == "reductions"
    assert chip_smoke.device_part("Memcpy DtoD (Device -> Device)") \
        == "copies and casts"
    assert chip_smoke.device_part(
        "void at::native::vectorized_elementwise_kernel<4>") == "elementwise"


def test_phase16c_on_the_cpu(monkeypatch, capsys):
    """16c's flow on the SMOKE configs: every family's check, rwkv6's
    one-layer cut, jamba's bf16 run with its routes counted (f32: none
    differ)."""
    from repro_torch.configs import registry

    monkeypatch.setattr(registry, "get_config", registry.get_smoke_config)
    monkeypatch.setattr(chip_smoke, "FAMILY_LAYERS", {
        "mixtral-8x22b": 1, "jamba-v0.1-52b": 8, "rwkv6-1.6b": 2,
        "whisper-medium": 2, "paligemma-3b": 2})
    monkeypatch.setattr(chip_smoke, "FAMILY_PROMPT", 10)
    problems = []
    out = chip_smoke.families_phase(torch, torch.device("cpu"), problems)
    assert not problems
    assert set(out) == {"mixtral-8x22b", "jamba-v0.1-52b", "rwkv6-1.6b",
                        "rwkv6-1.6b (1 layer)", "whisper-medium",
                        "paligemma-3b", "jamba-v0.1-52b (bf16)"}
    assert out["jamba-v0.1-52b"]["flips"] == 0
    assert out["jamba-v0.1-52b"]["routed"] == 4 * 2 * (10 + 4)
    assert out["jamba-v0.1-52b (bf16)"]["tol"] is None
    assert out["rwkv6-1.6b (1 layer)"]["layers"] == 1
    assert "depth cut 56 -> 1" not in capsys.readouterr().out  # smoke: 2


def test_routing_flips_counts_differing_routes():
    fwd = [torch.tensor([[[0, 1], [1, 2], [0, 3], [2, 3]]])]  # (1, 4, 2)
    pre = [torch.tensor([[[0, 1], [1, 3]]])]                  # S = 2
    dec = [torch.tensor([[[0, 3]]]), torch.tensor([[[1, 3]]])]
    got = chip_smoke.routing_flips(fwd + pre + dec, 1, 2, 2)
    assert got == {"flips": 2, "routed": 4}


# ---------------------------------------------------------------------------
# phase 17: LM training
# ---------------------------------------------------------------------------

def test_train_flag_parses():
    assert chip_smoke.build_parser().parse_args(["--train"]).train
    assert not chip_smoke.build_parser().parse_args([]).train


def test_phase17_flops_and_state_bytes():
    """qwen3-0.6b trains 596,049,920 parameters (the config's count plus
    the norms' gains it leaves out); 6 N tokens for 8 x 4096 tokens is
    117.2 TFLOP; the state besides activations is 16 bytes a parameter
    (bf16 parameters and gradients, the f32 accumulator, two f32
    moments), 9.54 GB; a microbatch's logits 4.98 GB in bf16, 9.96 GB as
    f32."""
    from repro_torch.configs.registry import get_config

    cfg = get_config("qwen3-0.6b")
    # the tree's count (test_phase16_byte_floor_and_parameter_count holds
    # the formula to the tree)
    norms = cfg.n_layers * (2 * cfg.d_model + 2 * cfg.hd) + cfg.d_model
    n = int(cfg.total_params()) + norms
    assert n == 596_049_920
    tokens = chip_smoke.TRAIN_BATCH * chip_smoke.TRAIN_SEQ
    assert tokens == 32_768
    assert chip_smoke.train_flops(n, tokens) == 6 * n * tokens
    assert chip_smoke.train_flops(n, tokens) == pytest.approx(117.2e12,
                                                              rel=1e-3)
    static = chip_smoke.train_static_bytes(n, 2, chip_smoke.TRAIN_ACCUM)
    assert static == 16 * n and static == pytest.approx(9.54e9, rel=1e-3)
    assert chip_smoke.train_static_bytes(n, 2, 1) == 12 * n
    logits = chip_smoke.logits_bytes(cfg, 4, 4096)
    assert logits == {"model_dtype": 2 * 4 * 4096 * 151_936,
                      "f32": 4 * 4 * 4096 * 151_936}
    assert logits["f32"] == pytest.approx(9.96e9, rel=1e-3)
    lo, hi = chip_smoke.TRAIN_MEM_GB
    assert lo * 1e9 > static + logits["f32"] and hi * 1e9 < 80e9


def test_phase17_cuts_keep_the_widths():
    """17b: train_4k's length with its global batch cut 256 -> 8 (accum
    2), qwen3-0.6b's depth cut 28 -> 8; 17c: qwen3 and rwkv6 at full
    width cut to 2 layers; 17d: the full-width model cut below 17b's
    depth, seq_len 512, batch 8."""
    from repro_torch.configs.registry import SHAPES, get_config
    from repro_torch.models import scan_utils

    assert chip_smoke.TRAIN_SEQ == SHAPES["train_4k"].seq_len == 4096
    assert 1 < chip_smoke.TRAIN_LAYERS < get_config("qwen3-0.6b").n_layers
    assert SHAPES["train_4k"].global_batch == 256
    assert (chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_ACCUM) == (8, 2)
    assert chip_smoke.REMAT_RUNS == (("qwen3-0.6b", 2, 4096, 4),
                                     ("rwkv6-1.6b", 2, 768, 2))
    for arch, layers, seq, _ in chip_smoke.REMAT_RUNS:
        assert get_config(arch).n_layers > layers
    # rwkv6's cut spans several 256-step time chunks
    assert chip_smoke.REMAT_RUNS[1][2] > 2 * scan_utils.DEFAULT_CHUNK
    args = chip_smoke.RESUME_ARGS
    assert "--smoke" not in args and args[:2] == ["--arch", "qwen3-0.6b"]
    assert args[args.index("--layers") + 1] == str(chip_smoke.RESUME_LAYERS)
    assert 1 < chip_smoke.RESUME_LAYERS < chip_smoke.TRAIN_LAYERS
    assert args[args.index("--seq-len") + 1] == "512"
    assert args[args.index("--batch") + 1] == "8"


def test_train_parts():
    part = chip_smoke.device_part
    parts = chip_smoke.TRAIN_PARTS
    assert part("cutlass_80_simt_sgemm_128x64_8x5_nn_align1", parts) \
        == "f32 products"
    assert part("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n", parts) \
        == "f32 products"
    assert part("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", parts) \
        == "bf16 products"
    assert part("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NNN", parts) \
        == "bf16 products"
    assert part("void at::native::reduce_kernel<512, 1>", parts) \
        == "reductions"
    assert part("void at::native::vectorized_elementwise_kernel<4>",
                parts) == "elementwise"
    assert part("void at::native::indexing_backward_kernel<float>", parts) \
        == "indexing"


def test_params_problems_applies_adamw_s_rule():
    lr, k = 1e-3, 1
    want = [torch.zeros(4)]
    v = [torch.tensor([1.0, 1.0, 1e-12, 1.0])]     # element 2: noise
    ok = [torch.tensor([5e-6, 0.0, 2e-3, 0.0])]   # noise moved 2 lr
    assert chip_smoke.params_problems(ok, want, v, lr, k, [None],
                                      tight=True) == []
    tight = [torch.tensor([2e-5, 0.0, 0.0, 0.0])]  # > 1e-2 lr above noise
    assert chip_smoke.params_problems(tight, want, v, lr, k, [None],
                                      tight=True)
    assert chip_smoke.params_problems(tight, want, v, lr, k, [None],
                                      tight=False) == []
    far = [torch.tensor([0.0, 0.0, 3e-3, 0.0])]    # > 2 lr k anywhere
    assert chip_smoke.params_problems(far, want, v, lr, k, [None],
                                      tight=False)
    # an element below noise at an earlier step stays loose
    above = [None]
    chip_smoke.params_problems(want, want, v, lr, 1, above, tight=True)
    v2 = [torch.ones(4)]
    late = [torch.tensor([0.0, 0.0, 1e-3, 0.0])]
    assert chip_smoke.params_problems(late, want, v2, lr, 2, above,
                                      tight=True) == []


def test_phase17a_on_the_cpu(capsys, one_thread):
    """17a's runs with the CPU as both devices: every arch, both modes,
    equal."""
    problems = []
    out = chip_smoke.smoke_train_phase(torch, torch.device("cpu"), problems)
    assert not problems
    assert len(out) == 20
    assert all(r["loss_rel"] == 0 and not r["param_problems"]
               for r in out.values())
    assert "[17a] whisper-medium +int8" in capsys.readouterr().out


def test_phase17c_on_the_cpu(monkeypatch):
    """17c's check on qwen3-smoke and rwkv6-smoke over 300 tokens (two
    time chunks), one CPU thread; the memory counters stubbed."""
    from repro_torch.configs import registry

    monkeypatch.setattr(registry, "get_config", registry.get_smoke_config)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for arch, seq in (("qwen3-0.6b", 40), ("rwkv6-1.6b", 300)):
            r = chip_smoke.remat_check(torch, torch.device("cpu"), arch, 2,
                                       seq, 2)
            assert r["bitwise"] and r["layers"] == 2, arch
    finally:
        torch.set_num_threads(n)


def test_each_top_level_name_is_defined_once():
    """A later phase's helper must not shadow an earlier phase's (the
    last definition wins, silently)."""
    import ast

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    names += [t.id for n in tree.body if isinstance(n, ast.Assign)
              for t in n.targets if isinstance(t, ast.Name)]
    dup = sorted({n for n in names if names.count(n) > 1})
    assert not dup, dup


# ---------------------------------------------------------------------------
# phase 18: the LM side over a device mesh
# ---------------------------------------------------------------------------

def test_lm_mesh_flag_parses():
    assert chip_smoke.build_parser().parse_args(["--lm-mesh"]).lm_mesh
    assert not chip_smoke.build_parser().parse_args([]).lm_mesh


def test_phase18_bytes_from_the_specs():
    """18a's bar: 188,022,784 of qwen3-0.6b's parameter bytes at one (2, 4)
    position, from the meta specs alone; 18d's derived counts: the fine to
    coarse move takes 3/4 of the cache, the host-buffer hops 3x."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.models import lm
    from repro_torch.models.sharding import NamedSharding, P, param_shardings
    from repro_torch.serving.repartition_kv import KVRepartitionPlan

    cfg = get_config("qwen3-0.6b")
    mesh = DeviceMesh(chip_smoke.MESH_SHAPE, ("data", "model"))
    specs = chip_smoke.flat(lm.param_specs(cfg))
    sh = chip_smoke.flat(param_shardings(mesh, lm.param_specs(cfg)))
    assert chip_smoke.spec_position_bytes(specs, sh) \
        == chip_smoke.MESH_QWEN_BYTES == 188_022_784
    plan = KVRepartitionPlan.build(8, chip_smoke.KV_FINE, chip_smoke.KV_ALPHA)
    fine = NamedSharding(mesh, plan.fine_spec())
    coarse = NamedSharding(mesh, plan.coarse_spec())
    staged = NamedSharding(mesh, P(None, "data", None, None, None))
    shape = (28, 8, 576, 8, 128)                 # 18d's K (or V) leaf
    whole = math.prod(shape) * 2
    assert chip_smoke.spec_move_bytes(fine, coarse, shape, 2) \
        == 3 * whole // 4
    assert chip_smoke.spec_move_bytes(fine, staged, shape, 2) == 3 * whole
    assert chip_smoke.spec_move_bytes(staged, coarse, shape, 2) == 0
    assert chip_smoke.spec_move_bytes(fine, fine, shape, 2) == 0


def test_spec_move_bytes_is_what_reshard_moves():
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.sharding import NamedSharding, P, reshard, shard

    mesh = make_debug_mesh(2, 4, ["cpu"] * 8)
    x = torch.arange(4 * 8 * 8, dtype=torch.float32).reshape(4, 8, 8)
    specs = (P(None, ("data", "model")), P(None, "data", "model"),
             P("data"), P(), P(None, None, ("model", "data")))
    for a in specs:
        for b in specs:
            src, dst = NamedSharding(mesh, a), NamedSharding(mesh, b)
            _, moved = reshard(shard(x, src), dst)
            assert moved.positions == chip_smoke.spec_move_bytes(
                src, dst, tuple(x.shape), 4), (a, b)


def test_phase18_cuts_keep_the_widths():
    """18b/18c: qwen3-0.6b at full width cut 28 -> 4 layers (2 periods a
    pipeline stage), 8 x 1024; 18d: 16b's batch, prompt and max_len; the
    meshes hold 8 positions, all on the card."""
    from repro_torch.configs.registry import get_config

    cfg = get_config("qwen3-0.6b")
    assert cfg.n_layers == 28 > chip_smoke.MESH_LAYERS == 4
    assert chip_smoke.MESH_LAYERS % chip_smoke.PIPE_MESH[0] == 0
    assert (chip_smoke.MESH_SEQ, chip_smoke.MESH_BATCH) == (1024, 8)
    assert chip_smoke.MESH_BATCH % (chip_smoke.PIPE_MICRO
                                    * chip_smoke.PIPE_MESH[1]) == 0
    assert math.prod(chip_smoke.MESH_SHAPE) == math.prod(
        chip_smoke.PIPE_MESH) == 8
    assert chip_smoke.mesh_devices(8) == ["cuda:0"] * 8
    assert (chip_smoke.QWEN_BATCH, chip_smoke.QWEN_PROMPT,
            chip_smoke.QWEN_PROMPT + chip_smoke.QWEN_NEW) == (8, 512, 576)
    args = chip_smoke.MESH_RESUME_ARGS
    assert "--smoke" in args and args[:2] == ["--arch", "qwen3-0.6b"]


def test_phase18ef_cuts_keep_the_widths():
    """18e: phi3.5-moe at its published widths cut 32 -> 1 layer, its
    whole period (attention and a 16-expert MoE), on 18b's mesh and
    batches; 18f: jamba's mixer and MoE at their published widths."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(chip_smoke.PHI)
    small = chip_smoke.moe_mesh_config()
    assert cfg.n_layers == 32 > chip_smoke.MOE_LAYERS == small.n_layers == 1
    assert len(cfg.period()) == 1 and cfg.period()[0].moe
    assert (small.d_model, small.n_experts, small.d_ff, small.vocab_size,
            small.n_heads, small.n_kv_heads, small.dtype) == (
        4096, 16, 6400, 32064, 32, 8, "bfloat16")
    jamba = get_config(chip_smoke.JAMBA)
    assert (jamba.d_model, jamba.d_inner, jamba.ssm_d_state,
            math.ceil(jamba.d_model / 16), jamba.n_experts, jamba.d_ff) == (
        4096, 8192, 16, 256, 16, 14336)
    assert (chip_smoke.MIXER_BATCH, chip_smoke.MIXER_SEQ) == (2, 512)
    assert chip_smoke.MIXER_TOL == 1e-4


def test_moe_whole_moves_are_the_whole_product_schedule(monkeypatch):
    """``MOE_WHOLE_MOVES``: what ``mesh_step_moves`` composes at 18e's
    configuration when the moe family's products run whole (the split
    families cut to the dense one); the split schedule's gather below it,
    its ``model`` bytes above 0, composed from the specs."""
    from repro_torch.models import tensor_parallel as tp

    monkeypatch.setattr(chip_smoke, "mesh_devices", lambda n: ["cpu"] * n)
    got = chip_smoke.composed_18e_moves()
    assert got == {
        "gather": [5_200_936_960, 0], "reduce": [5_470_445_568, 0],
        "scatter": [6_391_676_928, 0], "relayout": [0, 0],
        "model": [3_828_252_672, 0], "routes": [0, 0]}
    assert got["gather"][0] < chip_smoke.MOE_WHOLE_MOVES["gather"][0]
    monkeypatch.setattr(tp, "SPLIT_FAMILIES", ("dense",))
    assert chip_smoke.composed_18e_moves() == chip_smoke.MOE_WHOLE_MOVES


def stub_card(monkeypatch):
    """The card's counters and synchronisation stubbed; the positions on
    the CPU; the qwen3 config its SMOKE cut."""
    from repro_torch.configs import registry

    real = registry.get_config
    monkeypatch.setattr(registry, "get_config", lambda a: (
        registry.get_smoke_config(a) if a == "qwen3-0.6b" else real(a)))
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "mesh_devices", lambda n: ["cpu"] * n)


def test_phase18cd_on_the_cpu(monkeypatch, capsys):
    """18c and 18d on qwen3-smoke: the pipeline bitwise per slice, both
    schedules the identity with the derived bytes and the original's
    tokens."""
    stub_card(monkeypatch)
    monkeypatch.setattr(chip_smoke, "MESH_SEQ", 32)
    monkeypatch.setattr(chip_smoke, "QWEN_PROMPT", 24)
    monkeypatch.setattr(chip_smoke, "QWEN_NEW", 8)
    problems = []
    pipe = chip_smoke.pipeline_phase(torch, torch.device("cpu"), problems)
    kv = chip_smoke.kv_mesh_phase(torch, torch.device("cpu"), problems)
    assert not problems
    assert pipe["bitwise_per_slice"] and pipe["err_vs_full"] <= 1e-5
    for schedule in ("device_direct", "host_buffer"):
        r = kv[schedule]
        assert r["bytes_moved"] == r["derived_bytes"] > 0
        assert r["identity"] and r["coarse_shapes"] and r["same_tokens"]
    assert kv["host_buffer"]["bytes_moved"] == 4 * kv["device_direct"][
        "bytes_moved"]
    assert "[18d] host_buffer" in capsys.readouterr().out


def test_phase18b_on_the_cpu(monkeypatch, one_thread):
    """18b's runs on qwen3-smoke (one CPU thread): the mesh step (split
    products) within its bars of the one-device step at accum 2 and
    repeatable; then the launcher's five runs in process, the positions
    on the CPU: resumed on the mesh bitwise the uninterrupted mesh run,
    within 2 lr k of the one-device run."""
    stub_card(monkeypatch)
    monkeypatch.setattr(chip_smoke, "MESH_SEQ", 32)
    problems = []
    out = chip_smoke.mesh_train_phase(torch, torch.device("cpu"), problems)
    assert not problems
    assert out["bitwise_repeat"]
    assert max(out["rel_loss"], out["rel_grad_norm"]) <= chip_smoke.PIPE_TOL
    assert out["param_err"] <= out["param_bound"] and out["param_excess"] <= 0
    assert out["moved"]["reduce"][0] > 0 and out["moved"]["gather"][1] == 0
    assert out["moved"]["model"][0] > 0 == out["moved"]["model"][1]
    launcher = out["launcher"]
    assert launcher["resumed"] and launcher["resumed_equal"]
    assert max(launcher["param_errs"]) <= launcher["bound"]


def test_18b_launcher_failure_is_the_run_s(monkeypatch):
    """A launcher run that raises comes back as a failed run with its
    error, as a failed process would."""
    from repro_torch.launch import train

    def boom(args, log):
        log("step 0: ...")
        raise RuntimeError("no card")

    monkeypatch.setattr(train, "main", boom)
    rc, so, se = chip_smoke.mesh_train_run(["--steps", "1"], "/nowhere")
    assert (rc, so, se) == (1, "step 0: ...", "RuntimeError: no card")


def test_phase18e_on_the_cpu(monkeypatch, capsys):
    """18e on phi3.5-smoke (one CPU thread): the mesh step (the MoE's
    experts split) within 18b's bars of the one-device step at accum 2,
    repeatable, the routes recorded both ways; its bytes the composed
    ones."""
    from repro_torch.configs import registry
    from repro_torch.models.config import validate

    stub_card(monkeypatch)
    monkeypatch.setattr(chip_smoke, "MESH_SEQ", 32)
    monkeypatch.setattr(chip_smoke, "moe_mesh_config", lambda: validate(
        registry.get_smoke_config(chip_smoke.PHI)))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    problems = []
    try:
        out = chip_smoke.moe_mesh_phase(torch, torch.device("cpu"),
                                        problems)
    finally:
        torch.set_num_threads(n)
    assert not problems
    assert out["bitwise_repeat"] and out["route_flips"] == 0
    # 2 MoE layers, 2 slices a step (a microbatch or a data row), forward
    # and recomputation
    assert out["route_calls"] == 2 * 2 * 2 * chip_smoke.MESH_STEPS
    assert out["routed"] == out["route_calls"] * 4 * 32
    assert max(out["rel_loss"], out["rel_grad_norm"]) <= 1e-5
    assert out["moved"] == chip_smoke.composed_18e_moves()
    assert out["moved"]["model"][0] > 0
    assert "tokens whose routes differ 0 of" in capsys.readouterr().out


def test_phase18h_cuts_keep_the_widths():
    """18h: 18e's phi3.5-moe cut (published widths, one layer) with the
    sorted dispatch at capacity factor 1.0, 2 x 4096 (two 2048-position
    chunks, C 512 each), row 0's labels masked from 2048."""
    cfg = chip_smoke.sorted_mesh_config()
    assert cfg == dataclasses.replace(chip_smoke.moe_mesh_config(),
                                      moe_dispatch="sorted",
                                      moe_capacity_factor=1.0)
    assert (chip_smoke.SORTED_SEQ, chip_smoke.SORTED_BATCH,
            chip_smoke.SORTED_MASK) == (4096, 2, 2048)
    assert chip_smoke.capacity(cfg, 2 * 2048) == 512
    assert chip_smoke.capacity(dataclasses.replace(
        cfg, moe_capacity_factor=1.25), 2 * 2048) == 640
    batches = chip_smoke.sorted_batches(cfg, torch.device("cpu"))
    assert len(batches) == chip_smoke.MESH_STEPS
    for b in batches:
        assert tuple(b["labels"].shape) == (2, 4096)
        assert (b["labels"][0, 2048:] == -100).all()
        assert (b["labels"][0, :2048] != -100).all()
        assert (b["labels"][1] != -100).all()


def sorted_smoke(monkeypatch):
    """18h on phi3.5-smoke cut to one layer, 2 x 32 (row 0 masked from
    16), the card stubbed."""
    from repro_torch.configs import registry
    from repro_torch.models.config import validate

    stub_card(monkeypatch)
    monkeypatch.setattr(chip_smoke, "SORTED_SEQ", 32)
    monkeypatch.setattr(chip_smoke, "SORTED_MASK", 16)
    monkeypatch.setattr(chip_smoke, "sorted_mesh_config", lambda: validate(
        dataclasses.replace(registry.get_smoke_config(chip_smoke.PHI),
                            n_layers=1, moe_dispatch="sorted",
                            moe_capacity_factor=1.0)))


def test_phase18h_on_the_cpu(monkeypatch, capsys, one_thread):
    """18h's checks at SMOKE width: the mesh step within 18b's bars of
    the one-device step at accum 1, repeatable, its bytes the composed
    ones (``routes`` too), assignments dropped and the kept set the
    microbatch sort's of its own routes, the one-device step's routes
    the mesh's."""
    sorted_smoke(monkeypatch)
    problems = []
    out = chip_smoke.sorted_mesh_phase(torch, torch.device("cpu"), problems)
    assert not problems
    assert out["bitwise_repeat"]
    assert max(out["rel_loss"], out["rel_grad_norm"]) <= 1e-5
    kept = out["kept"]
    assert kept["chunks"] == chip_smoke.MESH_STEPS
    assert kept["assignments"] == kept["chunks"] * 2 * 32 * 2
    assert kept["dropped"] > 0 == kept["mismatched"]
    # top 2 of 4 experts: at least half of a row's 2 x 32 assignments
    assert 0.5 <= kept["busiest2"][0] <= kept["busiest2"][1] <= 1.0
    assert out["dropped_one_device"] == kept["dropped"]
    assert out["route_flips"] == 0
    assert out["moved"] == out["composed"]
    # a step: one hand-off of 4 int64 counts (1 layer, 1 chunk, 2 rows)
    assert out["moved"]["routes"] == [4 * 8, 0]
    assert out["capacity"] == 2 * 32 * 2 // 4
    assert "assignments dropped: the mesh" in capsys.readouterr().out


def test_phase18h_kept_set_check_catches_a_per_row_sort(monkeypatch,
                                                        one_thread):
    """Each data row sorting its own assignments at its own capacity (the
    whole sublayer on each row, as before the split): the kept set is no
    longer the microbatch sort's, and 18h says so."""
    from repro_torch.models import tensor_parallel as tp

    sorted_smoke(monkeypatch)
    real = tp._sort_routes

    def per_row(rows, logits, top_k, E, C):
        return [real([row], [lg], top_k, E, C // len(rows))[0]
                for row, lg in zip(rows, logits)]

    monkeypatch.setattr(tp, "_sort_routes", per_row)
    problems = []
    out = chip_smoke.sorted_mesh_phase(torch, torch.device("cpu"), problems)
    assert out["kept"]["mismatched"] > 0
    assert any("kept set is not the microbatch sort's" in p
               for p in problems)


def test_phase18g_cuts_keep_the_widths():
    """18g: rwkv6-1.6b, paligemma-3b and whisper-medium at their
    published widths cut to one layer (whisper: one decoder and one
    encoder layer), on 18b's mesh and batches; paligemma's 256 patches
    and whisper's 1500 frames as published."""
    from repro_torch.configs.registry import get_config

    want = {"rwkv6-1.6b": (2048, 7168, 32, 65536, 0, 0),
            "paligemma-3b": (2048, 16384, 8, 257216, 0, 256),
            "whisper-medium": (1024, 4096, 16, 51865, 1, 1500)}
    assert chip_smoke.FAMILIES == tuple(want)
    # rwkv6's sequence cut (its eager time loop); the others run 18b's
    assert chip_smoke.FAMILY_SEQ == {"rwkv6-1.6b": 256}
    assert chip_smoke.MESH_SEQ == 1024
    for arch, (d, ff, heads, vocab, enc, front) in want.items():
        full, cfg = get_config(arch), chip_smoke.family_mesh_config(arch)
        assert full.n_layers > cfg.n_layers == 1
        assert cfg == dataclasses.replace(full, n_layers=1,
                                          encoder_layers=enc)
        assert (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.vocab_size,
                cfg.encoder_layers, cfg.frontend_len, cfg.dtype) == (
            d, ff, heads, vocab, enc, front, "bfloat16")


def test_family_whole_moves_are_the_whole_product_schedule(monkeypatch):
    """``FAMILY_WHOLE_MOVES``: what ``mesh_step_moves`` composes at 18g's
    configurations when each family's products run whole; the split
    schedule's gather below it and its ``model`` bytes above 0."""
    from repro_torch.models import tensor_parallel as tp

    monkeypatch.setattr(chip_smoke, "mesh_devices", lambda n: ["cpu"] * n)
    split = tp.SPLIT_FAMILIES
    for arch in chip_smoke.FAMILIES:
        cfg = chip_smoke.family_mesh_config(arch)
        got = chip_smoke.composed_moves(cfg)
        whole = chip_smoke.FAMILY_WHOLE_MOVES[arch]
        assert got["gather"][0] < whole["gather"][0]
        assert got["model"][0] > 0 == whole["model"][0]
        assert got["scatter"] == whole["scatter"]
        monkeypatch.setattr(tp, "SPLIT_FAMILIES", tuple(
            f for f in split if f != cfg.family))
        assert chip_smoke.composed_moves(cfg) == whole
        monkeypatch.setattr(tp, "SPLIT_FAMILIES", split)


def test_phase18g_on_the_cpu(monkeypatch, capsys, one_thread):
    """18g on the three SMOKE configs (one layer each, one CPU thread;
    rwkv6 at a sequence of its own, as on the card): each mesh step
    within 18b's bars of the one-device step at accum 2, repeatable, its
    bytes the composed ones, its gather below the whole-product
    schedule's."""
    from repro_torch.configs import registry
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.models.config import validate

    stub_card(monkeypatch)
    monkeypatch.setattr(chip_smoke, "MESH_SEQ", 32)
    monkeypatch.setattr(chip_smoke, "FAMILY_SEQ", {"rwkv6-1.6b": 16})

    def smoke(arch):
        cfg = registry.get_smoke_config(arch)
        return validate(dataclasses.replace(
            cfg, n_layers=1, encoder_layers=min(1, cfg.encoder_layers),
            dtype="bfloat16"))

    monkeypatch.setattr(chip_smoke, "family_mesh_config", smoke)
    split, whole = tp.SPLIT_FAMILIES, {}
    for arch in chip_smoke.FAMILIES:
        monkeypatch.setattr(tp, "SPLIT_FAMILIES", tuple(
            f for f in split if f != smoke(arch).family))
        whole[arch] = chip_smoke.composed_moves(smoke(arch))
    monkeypatch.setattr(tp, "SPLIT_FAMILIES", split)
    monkeypatch.setattr(chip_smoke, "FAMILY_WHOLE_MOVES", whole)
    problems = []
    out = chip_smoke.family_mesh_phase(torch, torch.device("cpu"), problems)
    assert not problems
    for arch in chip_smoke.FAMILIES:
        r = out[arch]
        assert r["bitwise_repeat"]
        assert max(r["rel_loss"], r["rel_grad_norm"]) <= chip_smoke.PIPE_TOL
        seq = chip_smoke.FAMILY_SEQ.get(arch, 32)
        assert r["seq_len"] == seq
        assert r["moved"] == chip_smoke.composed_moves(smoke(arch), seq)
        assert r["moved"]["model"][0] > 0
    assert out["paligemma-3b"]["stack_rows"] == 8 + 32
    printed = capsys.readouterr().out
    assert "[18g] whisper-medium (audio)" in printed
    assert "and 1 encoder layer(s) over 16 frames" in printed


def test_phase18f_on_the_cpu(monkeypatch, capsys):
    """18f on jamba-smoke's widths: the split mixer and MoE within
    ``MIXER_TOL`` of the whole sublayers, output and every gradient."""
    from repro_torch.configs import registry

    stub_card(monkeypatch)
    real = registry.get_config
    monkeypatch.setattr(registry, "get_config", lambda a: (
        registry.get_smoke_config(a) if a == chip_smoke.JAMBA else real(a)))
    monkeypatch.setattr(chip_smoke, "MIXER_SEQ", 16)
    problems = []
    out = chip_smoke.mixer_split_phase(torch, torch.device("cpu"), problems)
    assert not problems
    for sub in ("mamba", "moe"):
        r = out[sub]
        assert r["split"] and r["max_err"] <= chip_smoke.MIXER_TOL
        assert r["model"][0] > 0 and r["gather"][0] > 0
    # the mixer: the output, x and its 9 leaves; the MoE: 4 leaves
    assert len(out["mamba"]["errs"]) == 11 and len(out["moe"]["errs"]) == 6
    assert "[18f] mix (l0) split over 4 positions: True" in (
        capsys.readouterr().out)


# ---------------------------------------------------------------------------
# phase 19: the stacked solve over a (solve, assemble) mesh; 17b's
# analytical FLOPs
# ---------------------------------------------------------------------------

def test_assembly_mesh_flag_parses():
    assert chip_smoke.build_parser().parse_args(
        ["--assembly-mesh"]).assembly_mesh
    assert not chip_smoke.build_parser().parse_args([]).assembly_mesh


def test_assembly_mesh_bytes_are_the_closed_form_at_210():
    """Phase 19's bars: ``(alpha - 1) * n_coarse * L * 8`` with L the
    210^3 fine part's LDU buffer (cells, both sides of its faces, both
    interface planes), the length ``plan_for_mesh`` gives at any size."""
    from repro_torch.core.repartition import plan_for_mesh
    from repro_torch.fvm.mesh import CavityMesh

    def buffer_len(mesh):
        return mesh.n_cells + 2 * mesh.n_faces + 2 * mesh.plane

    small = CavityMesh.cube(8, 4)
    assert plan_for_mesh(small, 2).buffer_len == buffer_len(small)
    big = CavityMesh.cube(chip_smoke.N, chip_smoke.PARTS)
    L = buffer_len(big)
    assert L == 2_155_020
    for alpha, want in chip_smoke.ASSEMBLY_MESH_BYTES.items():
        n_c = chip_smoke.PARTS // alpha
        assert want == (alpha - 1) * n_c * L * 8
        forms = chip_smoke.mesh_move_forms(n_c, alpha, L, L, big.n_cells,
                                           updates=1, solves=2)
        assert forms["device_direct"]["update_p"] == want
        assert forms["host_buffer"]["update_p"] >= want
    assert chip_smoke.mesh_move_forms(1, 30, L, L, big.n_cells, 1, 2)[
        "device_direct"]["x_back"] == 2 * 29 * 308_700 * 8


@pytest.mark.parametrize("pipeline", ["auto", "off"])
@pytest.mark.parametrize("schedule", ["device_direct", "host_buffer"])
def test_mesh_move_forms_are_the_solver_record(schedule, pipeline):
    """The closed forms phase 19 holds a step to are what a solver over
    a mesh records, on a small cavity on the CPU."""
    from repro_torch.core.comm import assembly_layout, make_cfd_mesh
    from repro_torch.fvm.mesh import CavityMesh
    from repro_torch.fvm.piso import PisoSolver, PisoState

    cube = CavityMesh.cube(8, 8)
    mesh = make_cfd_mesh(2, 4, devices=["cpu"] * 8)
    solver = PisoSolver(cube, alpha=4, spmd_mesh=mesh, device="cpu",
                        update_schedule=schedule, pipeline=pipeline)
    state = PisoState(*(assembly_layout(t, mesh)
                        for t in solver.initial_state()))
    solver.step(state, 2e-4)
    forms = chip_smoke.mesh_move_forms(
        2, 4, solver.plan_p.buffer_len, solver.plan_mom.buffer_len,
        cube.n_cells, updates=1 if solver.pipelined else 2, solves=2)
    got = solver.moves.kinds
    assert chip_smoke.move_problems(got, forms[schedule], "t") == []
    other = ("host_buffer" if schedule == "device_direct"
             else "device_direct")
    assert chip_smoke.move_problems(got, forms[other], "t")


def test_move_problems_names_what_differs():
    from repro_torch.core.layout import MoveStats

    want = dict.fromkeys(chip_smoke.MOVE_KINDS, 10)
    got = {k: MoveStats(10, 0) for k in chip_smoke.MOVE_KINDS}
    assert chip_smoke.move_problems(dict(got, halo=MoveStats(4, 0)), want,
                                    "t") == []
    bad = chip_smoke.move_problems(dict(got, b_c=MoveStats(9, 0)), want, "t")
    assert len(bad) == 2 and "b_c moved 9" in bad[0] and "halo" in bad[1]


# ---------------------------------------------------------------------------
# phase 19b: the same meshes over the card and its host
# ---------------------------------------------------------------------------

def test_19b_meshes_keep_every_owner_on_the_card():
    from repro_torch.core.comm import make_cfd_mesh
    from repro_torch.core.update import owner_positions

    assert sorted(chip_smoke.DISTINCT_MESH_DEVICES) == [15, 30]
    for alpha, devs in chip_smoke.DISTINCT_MESH_DEVICES.items():
        n_c = chip_smoke.PARTS // alpha
        mesh = make_cfd_mesh(n_c, alpha, devices=devs)
        assert len(devs) == chip_smoke.PARTS and len(mesh.groups()) > 1
        owners = owner_positions(mesh, n_c)
        assert all(devs[k] == chip_smoke.MESH_DEVICE for k in owners)
        cpu = [k for k, d in enumerate(devs) if d == "cpu"]
        # two CPU positions, none an owner, one in each solve row
        assert len(cpu) == 2 and not set(cpu) & set(owners)
        assert len({k // alpha for k in cpu}) == n_c


@pytest.fixture
def tiny_19b(monkeypatch):
    """19b at a (2, 4) mesh of an 8^3 cavity on the CPU, ``cpu:0`` in the
    card's place: each schedule's reference is the mesh on ``cpu`` alone,
    stepped from the 8-part state of one step."""
    from repro_torch.core.comm import assembly_layout
    from repro_torch.core.layout import unshard
    from repro_torch.fvm.piso import PisoState
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.case import build_parser, build_solver

    args = ["--n", "8", "--parts", "8", "--alpha", "4", "--steps", "1",
            "--co", "0.5", "--device", "cpu"]
    monkeypatch.setattr(chip_smoke, "PARTS", 8)
    monkeypatch.setattr(chip_smoke, "MAIN_ARGS", args)
    monkeypatch.setattr(chip_smoke, "MESH_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "DISTINCT_MESH_DEVICES", {
        4: ["cpu"] * 3 + ["cpu:0"] + ["cpu"] * 3 + ["cpu:0"]})
    monkeypatch.setattr(chip_smoke, "smi_line", lambda: "CPU, no card")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    plain = build_solver(build_parser().parse_args(args))
    dt = 0.5 * plain.mesh.h
    state = plain.run(1, dt)[0]
    refs = {}
    for schedule in ("device_direct", "host_buffer"):
        solver = build_solver(build_parser().parse_args(
            args + ["--mesh-devices", ",".join(["cpu"] * 8),
                    "--schedule", schedule]))
        laid = PisoState(*(assembly_layout(t, solver.spmd_mesh)
                           for t in state))
        st, stats = solver.step(laid, dt)
        refs[schedule] = {"state": PisoState(*(unshard(t, "cpu")
                                               for t in st)),
                          "stats": stats, "launches": launch_counts(),
                          "s": 0.0}
    return state, refs


@pytest.mark.parametrize("schedule", ["device_direct", "host_buffer"])
def test_19b_run_on_the_cpu_holds_and_prints_its_record(tiny_19b, schedule,
                                                        capsys):
    from repro_torch.core.controller import PlanCache

    state, refs = tiny_19b
    problems = []
    out = chip_smoke.distinct_mesh_run(torch, 4, schedule, PlanCache(),
                                       state, refs[schedule], problems)
    assert problems == []
    assert out["mesh"] == [2, 4] and out["cpu_positions"] == list(range(8))
    assert max(out["max_err"].values()) <= chip_smoke.DISTINCT_PARITY
    assert [r["device"] for r in out["ranks"]] == ["cpu", "cpu:0"]
    assert [r["parts"] for r in out["ranks"]] == [6, 2]
    assert all(r["step_s"] >= r["fine_s"] > 0 for r in out["ranks"])
    carried = {k: v["bytes"] for k, v in out["carried"].items()
               if k != "scalars"}
    assert carried == {k: v for k, v in out["counted_devices"].items() if v}
    assert ("update_mom" in carried) == (schedule == "host_buffer")
    printed = capsys.readouterr().out
    assert f"19b (2, 4) {schedule}" in printed
    assert "rank cpu:0 (2 parts): fine phases" in printed
    assert "the pressure update host->card" in printed
    assert "CPU, no card" in printed


def test_19b_problems_name_what_differs(tiny_19b):
    from repro_torch.core.layout import MoveStats

    _, refs = tiny_19b
    ref = refs["device_direct"]
    run = dict(ref, kinds={"halo": MoveStats(10, 4)},
               carried={"halo": [4, 0.0], "scalars": [9, 0.0]})
    assert chip_smoke.distinct_problems(torch, run, ref, "t") == []
    U = ref["state"].U * (1 + 1e-9)
    bad = dict(run, state=ref["state"]._replace(U=U),
               stats=ref["stats"]._replace(
                   mom_iters=ref["stats"].mom_iters + 1),
               launches=dict(ref["launches"], spmv_dia=1),
               carried={"halo": [5, 0.0]})
    got = chip_smoke.distinct_problems(torch, bad, ref, "t")
    assert len(got) == 4
    assert "U off by" in got[0] and "mom_iters" in got[1]
    assert "launched" in got[2] and "carried" in got[3]


def test_19b_rank_seconds_sum_the_phase_records():
    ranks = [{"device": "cuda:0", "parts": 28, "phases": [
        ("assemble_mom", "assembly", 0.5, 0.4),
        ("update_mom", "assembly", 0.1, 0.0),
        ("solve_mom", "assembly", 2.0, 1.5),
        ("assemble_p[0]", "assembly", 0.25, 0.125),
        ("update_p", "update", 0.125, 0.0),
        ("solve_p[0]", "solve", 1.0, 0.0),
        ("correct[0]", "assembly", 0.25, 0.0),
        ("grad_p", "assembly", 0.125, 0.0)]}]
    (r,) = chip_smoke.rank_seconds(ranks)
    assert r == {"device": "cuda:0", "parts": 28, "fine_s": 1.125,
                 "fine_waited_s": 0.525, "solve_mom_s": 2.0,
                 "solve_p_s": 1.0, "update_s": 0.225, "step_s": 4.35,
                 "waited_s": 2.025}


def test_19b_plain_versions_stay_on_the_cpu():
    import importlib

    mod = importlib.import_module("repro_torch.kernels.spmv_dia.spmv_dia")
    before = mod.spmv_dia_plain
    with chip_smoke.no_plain_versions(cuda_only=True):
        assert mod.spmv_dia_plain is not before
        b = torch.ones(1, 3, 4, dtype=torch.float64)
        x = torch.ones(1, 4, dtype=torch.float64)
        assert torch.equal(mod.spmv_dia_plain(b, x, offsets=(-1, 0, 1),
                                              plane=1),
                           before(b, x, offsets=(-1, 0, 1), plane=1))
    assert mod.spmv_dia_plain is before
    with chip_smoke.no_plain_versions():
        with pytest.raises(chip_smoke.SmokeFailure, match="card's path"):
            mod.spmv_dia_plain(b, x, offsets=(-1, 0, 1), plane=1)


def test_19b_runs_one_schedule_a_mesh():
    assert set(chip_smoke.DISTINCT_SCHEDULES) == set(
        chip_smoke.DISTINCT_MESH_DEVICES)
    assert sorted(chip_smoke.DISTINCT_SCHEDULES.values()) == [
        "device_direct", "host_buffer"]


# ---------------------------------------------------------------------------
# phase 19c: the refined policies and a padded mesh over the card and host
# ---------------------------------------------------------------------------

def test_19c_meshes_keep_every_owner_on_the_card():
    from repro_torch.core.comm import make_cfd_mesh
    from repro_torch.core.update import owner_positions

    card = chip_smoke.MESH_DEVICE
    alpha = chip_smoke.REFINED_ALPHA
    devs = chip_smoke.DISTINCT_MESH_DEVICES[alpha]
    n_c = chip_smoke.PARTS // alpha
    assert all(devs[k] == card for k in owner_positions(
        make_cfd_mesh(n_c, alpha, devices=devs), n_c))
    padded = chip_smoke.mix_mesh(padded=True)
    plain = chip_smoke.mix_mesh(padded=False)
    assert (padded.n_parts_real, padded.n_parts) == (12, 16)
    assert (plain.nx, plain.ny, plain.nz, plain.n_parts) == (64, 64, 48, 12)
    for cfd, on_host in ((padded, chip_smoke.PADDED_HOST_POSITIONS),
                         (plain, chip_smoke.BF16_HOST_POSITIONS)):
        n = cfd.n_parts
        devs = chip_smoke.host_mesh_devices(n, on_host)
        n_c = n // chip_smoke.MIX_ALPHA
        mesh = make_cfd_mesh(n_c, chip_smoke.MIX_ALPHA, devices=devs)
        owners = owner_positions(mesh, n_c)
        assert all(devs[k] == card for k in owners)
        assert [k for k, d in enumerate(devs) if d == "cpu"] == list(on_host)
        assert len(set(mesh.flat())) == 2
    # (b): one real part and one padding part on the host
    real = padded.n_parts_real
    assert [k < real for k in chip_smoke.PADDED_HOST_POSITIONS] == [True,
                                                                    False]


def test_refined_halo_bytes_is_the_closed_form_per_product():
    from repro_torch.core.comm import make_cfd_mesh
    from repro_torch.core.update import part_positions, solve_halo_moves

    mesh = make_cfd_mesh(2, 4, devices=["cpu"] * 3 + ["cpu:0"] * 5)
    owners = part_positions(mesh, 8)
    f8 = solve_halo_moves(mesh, owners, 10 * 8).devices
    f4 = solve_halo_moves(mesh, owners, 10 * 4).devices
    assert f8 == 2 * f4 > 0
    rows = [("bicgstab", 2, 5), ("cg", 3, 7), ("bicgstab", 0, 0)]
    assert chip_smoke.refined_halo_bytes(rows, mesh, owners, 10, 4) == (
        3 * f8 + (2 + 10) * f4 + 4 * f8 + (3 + 7) * f4 + f8)


@pytest.fixture
def tiny_19c(monkeypatch):
    """19c on the CPU: ``cpu`` in the card's place and ``cpu:0`` in the
    host's; (a) at a (2, 4) mesh of an 8^3 cavity from the 8-part state of
    one step, (b) and (c) at the 12-part mesh of a 16^3 serving mix (the
    bf16 pressure capped at 20)."""
    from repro_torch.launch.case import build_parser, build_solver

    args = ["--n", "8", "--parts", "8", "--alpha", "4", "--steps", "1",
            "--co", "0.5", "--device", "cpu"]
    monkeypatch.setattr(chip_smoke, "PARTS", 8)
    monkeypatch.setattr(chip_smoke, "MAIN_ARGS", args)
    monkeypatch.setattr(chip_smoke, "MESH_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "HOST_DEVICE", "cpu:0")
    monkeypatch.setattr(chip_smoke, "REFINED_ALPHA", 4)
    monkeypatch.setattr(chip_smoke, "DISTINCT_MESH_DEVICES", {
        4: ["cpu"] * 3 + ["cpu:0"] + ["cpu"] * 3 + ["cpu:0"]})
    monkeypatch.setattr(chip_smoke, "SMALL_ARGS", ["--cfd-n", "16",
                                                   "--parts", "16"])
    monkeypatch.setattr(chip_smoke, "BF16_P_MAXITER", 20)
    monkeypatch.setattr(chip_smoke, "smi_line", lambda: "CPU, no card")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    plain = build_solver(build_parser().parse_args(args))
    return plain.run(1, 0.5 * plain.mesh.h)[0]


def test_19c_a_on_the_cpu_holds_and_prints_its_record(tiny_19c, capsys):
    from repro_torch.core.controller import PlanCache

    problems = []
    rec = chip_smoke.refined_main_run(torch, PlanCache(), tiny_19c, None,
                                      problems)
    assert problems == []
    assert rec["mesh"] == [2, 4] and rec["schedule"] == "device_direct"
    assert max(rec["max_err"].values()) <= chip_smoke.REFINED_PARITY
    kinds = [r[0] for r in rec["solves"]]
    assert kinds == ["bicgstab"] * 3 + ["cg"] * 2
    assert [r[:2] for r in rec["solves"]] == [
        r[:2] for r in rec["solves_card_alone"]]
    assert all(r[1] > 0 for r in rec["solves"] if r[0] == "cg")
    assert rec["carried"]["solve_halo"]["bytes"] \
        == rec["solve_halo_closed_form"] > 0
    assert [r["device"] for r in rec["ranks"]] == ["cpu", "cpu:0"]
    assert 0 < rec["momentum_share"] < 1
    printed = capsys.readouterr().out
    assert "19c(a) (2, 4) f32_ir" in printed
    assert "rank cpu:0 (2 parts): fine phases" in printed
    assert "solve_halo's closed form at 8 and 4 B" in printed
    assert "CPU, no card" in printed


def test_19c_a_names_what_differs(tiny_19c, monkeypatch):
    """Against a reference whose passes, flags and state differ, 19c(a)
    names each."""
    from repro_torch.core.controller import PlanCache

    alone = chip_smoke.refined_main_run(torch, PlanCache(), tiny_19c, None,
                                        [])
    assert alone["counts_equal"] in (True, False)
    seen = {}
    real = chip_smoke.mesh_step

    def keep(torch_, solver, state, dt, steps):
        out = real(torch_, solver, state, dt, steps)
        seen.setdefault("run", out)
        return out

    monkeypatch.setattr(chip_smoke, "mesh_step", keep)
    chip_smoke.refined_main_run(torch, PlanCache(), tiny_19c, None, [])
    ref = dict(seen["run"])
    ref["state"] = ref["state"]._replace(U=ref["state"].U * 1.01)
    ref["stats"] = ref["stats"]._replace(hit_cap=~ref["stats"].hit_cap)
    ref["solves"] = [(k, n + 1, i) for k, n, i in ref["solves"]]
    problems = []
    chip_smoke.refined_main_run(torch, PlanCache(), tiny_19c, ref, problems)
    text = "\n".join(problems)
    assert "U off by" in text and "hit_cap" in text
    assert "solves (kind, passes)" in text


def test_19c_b_padded_on_the_cpu(tiny_19c, capsys):
    problems = []
    rec = chip_smoke.padded_mix_run(torch, problems)
    assert problems == []
    assert rec["mesh"] == [4, 4] and rec["parts"] == [12, 16]
    assert rec["padding_bitwise"]
    assert max(rec["max_err"].values()) <= chip_smoke.DISTINCT_PARITY
    assert "19c(b) (4, 4) padded 12->16" in capsys.readouterr().out


def test_19c_c_bf16_on_the_cpu(tiny_19c, capsys):
    problems = []
    rec = chip_smoke.bf16_mix_run(torch, problems)
    assert problems == []
    assert rec["mesh"] == [3, 4]
    assert [r[:2] for r in rec["solves"]] == [
        r[:2] for r in rec["solves_card_alone"]]
    assert "19c(c) (3, 4) bf16_ir" in capsys.readouterr().out


def test_analytical_step_flops_scale_train_4k_to_the_cut_batch():
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.analysis import analytical_flops

    cfg = get_config("qwen3-0.6b")
    got = chip_smoke.analytical_step_flops(cfg, chip_smoke.TRAIN_BATCH)
    full = analytical_flops(cfg, "train_4k")
    k = chip_smoke.TRAIN_BATCH / 256
    assert got == {"total": full.total * k, "ideal": full.ideal * k,
                   "model_flops_6nd": full.model_flops_6nd * k}
    # exact: every term counts tokens at the shape's sequence length
    assert got["total"] == 269182780309504.0 and got["total"] > got["ideal"]


# ---------------------------------------------------------------------------
# phase 20: the port's dry-run
# ---------------------------------------------------------------------------

def test_dryrun_flag_parses():
    ap = chip_smoke.build_parser()
    assert ap.parse_args(["--dryrun"]).dryrun
    both = ap.parse_args(["--lm-mesh", "--dryrun"])
    assert both.dryrun and both.lm_mesh
    assert not ap.parse_args([]).dryrun


def test_dryrun_problems_names_what_differs():
    def rec(arch, status, **kw):
        return dict(arch=arch, shape="train_4k", mesh="single_pod",
                    status=status, **kw)

    good = ([rec(f"a{i}", "ok") for i in range(66)]
            + [rec(f"s{i}", "skipped") for i in range(14)])
    names = [f"{r['arch']}__train_4k__single_pod.json" for r in good]
    assert chip_smoke.dryrun_status(good) == chip_smoke.DRYRUN_STATUS
    assert chip_smoke.dryrun_problems(good, names) == []
    bad = good[:-1] + [rec("e", "error", error="KeyError: 'e'")]
    out = chip_smoke.dryrun_problems(bad, names[:-1] + [
        "e__train_4k__single_pod.json"])
    assert len(out) == 2 and "'error': 1" in out[0] and "KeyError" in out[1]
    out = chip_smoke.dryrun_problems(good, names[:-1] + ["x.json"])
    assert out == ["20: x.json holds the record of "
                   "s13__train_4k__single_pod.json"]
    assert chip_smoke.dryrun_problems(good[:79], names[:79])


def test_params_within_counts_a_storage_rounding_a_step():
    """18b's parameter bar: 2 lr k, plus one unit in the last place of
    the larger value a step (bf16: 2 ** -7 of the binade's start)."""
    want = torch.tensor([0.2, 1.0, -0.03, 0.0], dtype=torch.bfloat16)
    ulp = chip_smoke.storage_ulp(torch, want)
    assert ulp.tolist() == [2.0 ** -10, 2.0 ** -7, 2.0 ** -13,
                            float(torch.finfo(torch.bfloat16).tiny) * 2 ** -7]
    got = want.double() + torch.tensor([2.0 ** -10, 0.0, 0.0, 0.0],
                                       dtype=torch.float64)
    one = chip_smoke.params_within(torch, [got.bfloat16()], [want], 1e-5, 1)
    assert one["max"] == 2.0 ** -10 and one["over_2lrk"] == 1
    assert one["excess"] <= 0
    two = chip_smoke.params_within(torch, [(want.double() + 3 * 2.0 ** -10)
                                           .bfloat16()], [want], 1e-5, 1)
    assert two["excess"] > 0


def test_composed_18b_moves_are_18b_s_measured_bytes(monkeypatch):
    """The bytes the card measured in 18b (PERF.md), composed from
    the specs with the positions on the CPU; the gather below the
    whole-parameter gather of the earlier schedule."""
    monkeypatch.setattr(chip_smoke, "mesh_devices", lambda n: ["cpu"] * n)
    got = chip_smoke.composed_18b_moves()
    assert got == {
        "gather": [251_658_240, 0], "reduce": [764_772_352, 0],
        "scatter": [1_309_564_928, 0], "relayout": [0, 0],
        "model": [2_618_228_736, 0], "routes": [0, 0]}
    assert got["gather"][0] < chip_smoke.MESH_WHOLE_GATHER


def test_phase20_reads_a_dryrun_started_earlier(monkeypatch, capsys):
    """The whole run starts the dry-run beside the build: phase 20 takes
    that run's records and does not run the command again."""
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 3, "", "boom")

    monkeypatch.setattr(chip_smoke.subprocess, "run", fake_run)
    pending = chip_smoke.start_dryrun()
    assert pending.exception() is None and len(calls) == 1
    with pytest.raises(chip_smoke.SmokeFailure, match="2 check"):
        chip_smoke.dryrun_phase(None, pending)
    printed = capsys.readouterr().out
    assert len(calls) == 1 and "beside the kernels' build" in printed
    assert "the dry-run exited 3: boom" in printed and "0 records" in printed


def test_phase20_on_the_cpu(monkeypatch, capsys):
    """The whole dry-run as a subprocess, then 18b's bytes: equal to a
    measured record, and a differing one fails the phase."""
    monkeypatch.setattr(chip_smoke, "mesh_devices", lambda n: ["cpu"] * n)
    measured = chip_smoke.composed_18b_moves()
    out = chip_smoke.dryrun_phase({"train": {"moved": measured}})
    assert out["records"] == 80 and out["status"] == chip_smoke.DRYRUN_STATUS
    assert out["moves_18b"]["equal"]
    assert out["moves_reason"] == []
    assert "[20] 80 records" in capsys.readouterr().out
    # no records and differing bytes: both named, the phase fails
    monkeypatch.setattr(chip_smoke.subprocess, "run", lambda *a, **k:
                        subprocess.CompletedProcess(a, 0, "", ""))
    monkeypatch.setattr(chip_smoke, "composed_18b_moves", lambda: dict(
        measured, reduce=[1, 0]))
    with pytest.raises(chip_smoke.SmokeFailure, match="2 check"):
        chip_smoke.dryrun_phase({"train": {"moved": measured}})
    printed = capsys.readouterr().out
    assert "18b's moves composed" in printed and "0 records" in printed
