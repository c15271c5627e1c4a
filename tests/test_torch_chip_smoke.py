"""The pure helpers of ``chip_smoke.py`` on the CPU: the ``ptxas -v``
parser and the frame check of its build phase.

The logs below are lines ``nvcc -Xptxas -v`` printed on the H100 (CUDA
12.8).  The framed one is the first port of the DIA SpMV kernel, whose
band-offset struct was indexed in a loop of run-time length and so copied
to a 72-byte local-memory frame; the clean one is the current kernels',
with a made-up frame on the axpy kernel, which the check does not cover.
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

OLD_DIA = "_Z15spmv_dia_kernelIddEvPKT_S2_PS0_xxN5repro11BandOffsetsE"
NEW_DIA = "_Z15spmv_dia_kernelIddLi7EEvPKT_S2_PS0_N5repro7DiaArgsE"
NEW_DOT = "_Z15spmv_dot_kernelIddLi7EEvPKT_S2_PS0_PT0_N5repro7DiaArgsE"
AXPY = "_Z19axpy_precond_kernelIddEvPKT_S2_S2_S2_S2_PKT0_PS0_S6_S6_PS3_S7_x"

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
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 24 registers, used 1 barriers, 2048 bytes smem
ptxas info    : Compile time = 7.837 ms
"""


def test_ptxas_report_reads_frame_spills_and_registers():
    old = chip_smoke.ptxas_report(FRAMED)
    assert old == {OLD_DIA: {"stack": 72, "spill_stores": 0,
                             "spill_loads": 0, "registers": 32}}
    new = chip_smoke.ptxas_report(CLEAN)
    assert set(new) == {NEW_DIA, NEW_DOT, AXPY}
    assert new[NEW_DIA] == {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                            "registers": 64}
    assert new[NEW_DOT]["registers"] == 48
    assert new[AXPY] == {"stack": 8, "spill_stores": 4, "spill_loads": 4,
                         "registers": 24}
    assert chip_smoke.ptxas_report("") == {}


@pytest.mark.parametrize("mangled,name", [
    (OLD_DIA, "spmv_dia_kernel"), (NEW_DOT, "spmv_dot_kernel"),
    (AXPY, "axpy_precond_kernel"), ("plain_c_name", "plain_c_name")])
def test_base_name_of_a_mangled_kernel(mangled, name):
    assert chip_smoke.base_name(mangled) == name


def test_check_frames_rejects_a_stack_frame():
    with pytest.raises(chip_smoke.SmokeFailure, match="72 bytes stack frame"):
        chip_smoke.check_frames(chip_smoke.ptxas_report(FRAMED + CLEAN))


def test_check_frames_accepts_the_clean_log_and_ignores_other_kernels():
    # the axpy kernel's (made-up) frame is not the check's business
    report = chip_smoke.ptxas_report(CLEAN)
    assert chip_smoke.check_frames(report) == {"spmv_dia_kernel": 1,
                                               "spmv_dot_kernel": 1}


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
