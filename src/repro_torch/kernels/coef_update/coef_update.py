"""Repartition value update (P∘U gather): CUDA kernel, plain version, cost.

The kernel (``csrc/coef_update.cu``) replaces the TPU kernel
``coef_update_single`` of ``src/repro/kernels/coef_update/coef_update.py``
and its stacked wrapper ``coef_update_pallas`` (``ops.py``).  It is bound
by bytes: per output a 4-byte index read and one value written, plus each
staged buffer value read once, and no arithmetic.  The plain PyTorch
version, :func:`coef_update_plain`, is one ``index_select``.

The TPU wrapper keeps the staging buffer in VMEM and asserts a 3M-entry
budget; the main path's pressure buffer at 210^3 / alpha 30 holds 64.65M
entries, so the port carries no such limit.  Indices are int32, as on the
TPU: :func:`coef_update_stacked` refuses a buffer of 2^31 entries or more.

:func:`coef_update_stacked` takes the plain version for tensors on the CPU
only; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.repartition import RepartitionPlan
from repro_torch.kernels._build import load
from repro_torch.kernels.spmv_dia.spmv_dia import stream_ptr

__all__ = ["coef_update", "coef_update_stacked", "coef_update_plain",
           "coef_update_cost", "check_gather_operands"]

_GATHER_DTYPES = (torch.float64, torch.float32, torch.bfloat16)
_INT32_MAX = 2 ** 31 - 1


def coef_update_cost(n_c: int, n_buf: int, n_out: int,
                     itemsize: int = 8) -> dict:
    """Bytes and flops of one stacked call (ints): the shared int32 index
    read once, every staged buffer value read once (a plan's index names
    each buffer entry exactly once), every output written once."""
    return {"bytes_accessed": 4 * n_out + n_c * (n_buf + n_out) * itemsize,
            "flops": 0, "transcendentals": 0}


def coef_update_plain(buf_cat: torch.Tensor, src: torch.Tensor,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """``out[c, i] = buf_cat[c, src[i]]``: (n_c, n_buf) → (n_c, n_out)."""
    return torch.index_select(buf_cat, 1, src, out=out)


def check_gather_operands(buf_cat: torch.Tensor, src: torch.Tensor,
                          out: torch.Tensor | None = None) -> None:
    """Raise unless ``buf_cat``, ``src`` and ``out`` suit the kernel."""
    if buf_cat.device.type != "cuda" or src.device != buf_cat.device:
        raise ValueError(f"kernel operands must share one CUDA device, got "
                         f"{buf_cat.device} and {src.device}")
    if buf_cat.dim() != 2 or src.dim() != 1:
        raise ValueError(f"buf_cat (n_c, n_buf) and src (n_out,) expected, "
                         f"got {tuple(buf_cat.shape)} and {tuple(src.shape)}")
    if buf_cat.dtype not in _GATHER_DTYPES:
        raise TypeError(f"buf_cat dtype {buf_cat.dtype} not in "
                        f"{_GATHER_DTYPES}")
    if src.dtype != torch.int32:
        raise TypeError(f"src must be int32, got {src.dtype}")
    if buf_cat.shape[1] > _INT32_MAX:
        raise ValueError(f"buffer of {buf_cat.shape[1]} entries exceeds "
                         "int32 indexing")
    if not (buf_cat.is_contiguous() and src.is_contiguous()):
        raise ValueError("kernel operands must be contiguous")
    if out is not None and (out.shape != (buf_cat.shape[0], src.shape[0])
                            or out.dtype != buf_cat.dtype
                            or out.device != buf_cat.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous "
                         f"{(buf_cat.shape[0], src.shape[0])} "
                         f"{buf_cat.dtype} tensor on {buf_cat.device}")


def coef_update_stacked(buf_cat: torch.Tensor, src: torch.Tensor, *,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """Stacked gather ``out[c, i] = buf_cat[c, src[i]]``.

    ``buf_cat`` (n_c, n_buf) float64/float32/bfloat16; ``src`` (n_out,)
    int32, every entry in ``[0, n_buf)`` (a plan's index is, by
    construction; the kernel does not check).  Writes into ``out`` when
    given.
    """
    if buf_cat.device.type == "cpu" and src.device.type == "cpu":
        return coef_update_plain(buf_cat, src, out=out)
    check_gather_operands(buf_cat, src, out)
    n_c, n_buf = buf_cat.shape
    if out is None:
        out = torch.empty((n_c, src.shape[0]), dtype=buf_cat.dtype,
                          device=buf_cat.device)
    rc = load("coef_update").coef_update_launch(
        buf_cat.element_size(), buf_cat.data_ptr(), src.data_ptr(),
        out.data_ptr(), n_c, n_buf, src.shape[0], stream_ptr(buf_cat))
    if rc != 0:
        raise RuntimeError(f"coef_update kernel launch failed (code {rc})")
    coef_update_stacked.launches += 1
    return out


coef_update_stacked.launches = 0


def coef_update(plan: RepartitionPlan, buf_cat: torch.Tensor,
                target: str = "dia", *,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """Apply a plan's P∘U to staged buffers (n_c, alpha*L + 1).

    Returns DIA bands (n_c, n_bands, m_c) or ELL values (n_c, m_c, K),
    gathered through the plan's int32 index on the buffers' device
    (:meth:`RepartitionPlan.src_on`); ``out`` (n_c, n_out) is written
    when given.
    """
    if target not in ("dia", "ell"):
        raise ValueError(f"unknown update target {target!r} (dia or ell)")
    if buf_cat.dim() != 2 or buf_cat.shape[1] != plan.sentinel + 1:
        raise ValueError(f"staged buffers (n_c, {plan.sentinel + 1}) "
                         f"expected, got {tuple(buf_cat.shape)}")
    vals = coef_update_stacked(buf_cat, plan.src_on(buf_cat.device, target),
                               out=out)
    n_c = buf_cat.shape[0]
    if target == "dia":
        return vals.view(n_c, len(plan.dia_offsets), plan.m_coarse)
    return vals.view(n_c, plan.m_coarse, plan.K)
