"""Hand-written CUDA kernels for Hopper (``sm_90a``), one package each.

Every kernel has a wrapper that launches it for CUDA tensors (and raises on
anything it does not take), a plain PyTorch version that the wrapper takes
for CPU tensors only, and a launch counter on the wrapper
(``wrapper.launches``), which :func:`launch_counts` reads and
:func:`reset_launch_counts` zeroes.
"""
from __future__ import annotations

from repro_torch.kernels.krylov_fused.krylov_fused import (fused_matvec_dot,
                                                           fused_update_step)
from repro_torch.kernels.spmv_dia.spmv_dia import spmv_dia_stacked

__all__ = ["WRAPPERS", "launch_counts", "reset_launch_counts"]

# kernel name -> wrapper; the names are the kernels' in csrc/
WRAPPERS = {
    "spmv_dia": spmv_dia_stacked,
    "spmv_dot": fused_matvec_dot,
    "axpy_precond": fused_update_step,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
