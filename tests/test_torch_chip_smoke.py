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
