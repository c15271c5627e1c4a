"""Banded (DIA) SpMV over stacked parts: CUDA kernel, plain version, cost.

The kernel (``csrc/spmv_dia.cu``) replaces the TPU kernel
``spmv_dia_single`` of ``src/repro/kernels/spmv_dia/spmv_dia.py`` and its
stacked wrapper ``spmv_dia_pallas``.  It is bound by bytes: 9 values per
row (7 bands, x, y) against 14 flops.  The plain PyTorch version is
:func:`repro_torch.sparse.distributed.spmv_dia`, the 7-shift loop.

:func:`spmv_dia_stacked` takes the plain version for tensors on the CPU
only; for CUDA tensors it launches the kernel or raises.  Given ``out=``
it writes there, and given ``active=`` (the Krylov loops' one-element
device flag, :mod:`repro_torch.solvers.device_loop`) the kernel writes
nothing while the flag is False and counts its own launch on the device
(:mod:`repro_torch.kernels.device_counts`) while it is True; the plain
versions model that guard with :func:`guarded_store`.

**Lanes.**  ``lanes=B`` runs a cohort of ``B`` systems of one shape, their
parts stacked one lane after another, as one launch (``gridDim.y = B``):
each lane is computed exactly as a launch on it alone would compute it,
its halo is zero at the lane's borders, and under a guard ``active``
holds one flag per lane.  ``lanes=1`` is the single-system launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import dtype_code, load
from repro_torch.kernels.device_counts import count_ptr
from repro_torch.sparse.distributed import spmv_dia as spmv_dia_plain

__all__ = ["spmv_dia_stacked", "spmv_dia_plain", "spmv_dia_cost",
           "KERNEL_BLOCK_ROWS", "check_stacked_operands", "stream_ptr",
           "check_out", "check_flag", "guarded_store", "check_lanes"]

# rows of one reduction partial (csrc/common.cuh kThreads): the reductions
# of the krylov_fused kernels write one partial per this many flat rows
KERNEL_BLOCK_ROWS = 256


def spmv_dia_cost(nb: int, n_rows: int, itemsize: int = 8) -> dict:
    """Bytes and flops one stacked call must move and do (ints).

    ``n_rows`` is the total row count over all parts: every band value and
    every ``x`` value is read once and every ``y`` value written once.
    """
    return {"bytes_accessed": (nb * n_rows + 2 * n_rows) * itemsize,
            "flops": 2 * nb * n_rows, "transcendentals": 0}


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_lanes(n_rows: int, lanes: int, itemsize: int = 0) -> int:
    """Rows per lane of ``n_rows`` split into ``lanes`` lanes; raises unless
    they split evenly and (with ``itemsize``) every lane starts on a
    16-byte boundary, for the kernels' vector loads."""
    if lanes < 1 or n_rows % lanes:
        raise ValueError(f"{n_rows} rows do not split into {lanes} lanes")
    per = n_rows // lanes
    if lanes > 1 and itemsize and (per * itemsize) % 16:
        raise ValueError(f"a lane of {per} rows does not start on a 16-byte "
                         f"boundary")
    return per


def check_stacked_operands(bands: torch.Tensor, x: torch.Tensor,
                           offsets: tuple[int, ...], plane: int) -> None:
    """Raise unless ``bands`` (P, nb, m) and ``x`` (P, m) suit the kernels."""
    if bands.device.type != "cuda" or x.device != bands.device:
        raise ValueError(f"kernel operands must share one CUDA device, got "
                         f"{bands.device} and {x.device}")
    if bands.dim() != 3 or x.shape != (bands.shape[0], bands.shape[2]):
        raise ValueError(f"bands (P, nb, m) and x (P, m) expected, got "
                         f"{tuple(bands.shape)} and {tuple(x.shape)}")
    if len(offsets) != bands.shape[1] or len(offsets) > 8:
        raise ValueError(f"{len(offsets)} offsets for {bands.shape[1]} bands "
                         f"(at most 8)")
    if x.dtype != bands.dtype:
        raise TypeError(f"x dtype {x.dtype} != bands dtype {bands.dtype}")
    if not (bands.is_contiguous() and x.is_contiguous()):
        raise ValueError("kernel operands must be contiguous")
    m = bands.shape[2]
    # the halo of a part is its neighbours' boundary plane: a shift may
    # reach one plane into a neighbour and no further
    if bands.shape[0] > 1 and plane > m:
        raise ValueError(f"plane {plane} exceeds the part size {m}")
    if any(abs(int(o)) > plane for o in offsets):
        raise ValueError(f"offsets {offsets} reach beyond the halo {plane}")


def check_out(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Raise unless ``out`` can take a kernel's output shaped as ``like``."""
    if (out.shape != like.shape or out.dtype != like.dtype
            or out.device != like.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {like.dtype} tensor of "
                         f"shape {tuple(like.shape)} on {like.device}")
    return out


def check_flag(active: torch.Tensor | None, device: torch.device,
               lanes: int = 1) -> int:
    """The data pointer of a loop guard (0 for None): a contiguous
    ``torch.bool`` tensor of one flag per lane on ``device``."""
    if active is None:
        return 0
    if (active.dtype != torch.bool or active.numel() != lanes
            or active.device != device or not active.is_contiguous()):
        raise ValueError(f"active must be a contiguous bool tensor of "
                         f"{lanes} flag(s) on {device}")
    return active.data_ptr()


def guarded_store(out: torch.Tensor | None, new: torch.Tensor,
                  active: torch.Tensor | None) -> torch.Tensor:
    """A plain version's result ``new`` stored as its kernel stores it:
    returned as it is without ``out``; copied into ``out``; and under a
    loop guard ``active`` (one flag per lane; ``out`` split evenly into
    that many lanes) written in the lanes whose flag is True and left as
    it is in the others (a select, so the same code runs inside a captured
    CUDA graph)."""
    if out is None:
        if active is not None:
            raise ValueError("a guarded call needs out=")
        return new
    if active is None:
        return out.copy_(new)
    lanes = active.numel()
    o = out.view(lanes, -1)
    torch.where(active.view(lanes, 1), new.reshape(o.shape), o, out=o)
    return out


def _offsets_arg(offsets) -> ctypes.Array:
    return (ctypes.c_longlong * len(offsets))(*(int(o) for o in offsets))


def spmv_dia_stacked(bands: torch.Tensor, x: torch.Tensor, *,
                     offsets: tuple[int, ...], plane: int,
                     accum_dtype: torch.dtype | None = None,
                     out: torch.Tensor | None = None,
                     active: torch.Tensor | None = None,
                     lanes: int = 1) -> torch.Tensor:
    """Stacked SpMV: bands (P, nb, m), x (P, m) → y (P, m), storage dtype.

    Accumulates at ``accum_dtype`` (``None``: the storage dtype).  ``out``:
    the buffer to write (default: a new one); ``active``: the loop guard,
    one flag per lane (needs ``out``); ``lanes``: the parts are that many
    lanes of ``P / lanes`` parts (see the module doc).
    """
    if bands.device.type == "cpu" and x.device.type == "cpu":
        return guarded_store(out, spmv_dia_plain(bands, x, offsets=offsets,
                                                 plane=plane,
                                                 accum_dtype=accum_dtype,
                                                 lanes=lanes),
                             active)
    check_stacked_operands(bands, x, offsets, plane)
    code = dtype_code(bands.dtype, accum_dtype or bands.dtype)
    P, nb, m = bands.shape
    P_lane = check_lanes(P, lanes)
    y = torch.empty_like(x) if out is None else check_out(out, x)
    lib = load("spmv_dia")
    args = (code, bands.data_ptr(), x.data_ptr(), y.data_ptr(), P_lane, m,
            _offsets_arg(offsets), nb, lanes)
    if active is None:
        rc = lib.spmv_dia_launch(*args, stream_ptr(x))
    else:
        if out is None:
            raise ValueError("a guarded call needs out=")
        rc = lib.spmv_dia_guarded_launch(
            *args, check_flag(active, x.device, lanes),
            count_ptr("spmv_dia", x.device, active), stream_ptr(x))
    if rc != 0:
        raise RuntimeError(f"spmv_dia kernel launch failed (code {rc})")
    if active is None:  # a guarded launch counts itself on the device
        spmv_dia_stacked.launches += 1
    return y


spmv_dia_stacked.launches = 0
