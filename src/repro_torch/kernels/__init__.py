"""Hand-written CUDA kernels for Hopper (``sm_90a``), one package each.

Every kernel has a wrapper that launches it for CUDA tensors (and raises on
anything it does not take), a plain PyTorch version that the wrapper takes
for CPU tensors only, and a launch counter on the wrapper
(``wrapper.launches``), which :func:`launch_counts` reads and
:func:`reset_launch_counts` zeroes.  A wrapper counts a launch at the
call, except under a Krylov loop's guard: such a launch may be replayed
from a captured CUDA graph, so its kernel counts itself on the device
(:mod:`repro_torch.kernels.device_counts`) and the loop
(:mod:`repro_torch.solvers.device_loop`) adds those counts to the
wrappers' once per sweep.
"""
from __future__ import annotations

from repro_torch.kernels.coef_update.coef_update import coef_update_stacked
from repro_torch.kernels.krylov_fused.krylov_fused import (fused_matvec_dot,
                                                           fused_update_step)
from repro_torch.kernels.krylov_loop.krylov_loop import (cg_advance,
                                                         cg_direction)
from repro_torch.kernels.spmv_dia.spmv_dia import spmv_dia_stacked
from repro_torch.kernels.stencil_assembly.stencil_assembly import (
    momentum_bands_stacked)

__all__ = ["WRAPPERS", "launch_counts", "reset_launch_counts"]

# kernel name -> wrapper; the names are the kernels' in csrc/
WRAPPERS = {
    "spmv_dia": spmv_dia_stacked,
    "spmv_dot": fused_matvec_dot,
    "axpy_precond": fused_update_step,
    "coef_update": coef_update_stacked,
    "momentum_bands": momentum_bands_stacked,
    "cg_direction": cg_direction,
    "cg_advance": cg_advance,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
