"""Fused Krylov-iteration kernels: CUDA kernels, plain versions, costs.

Two kernels (``csrc/krylov_fused.cu``) replace the TPU kernels of
``src/repro/kernels/krylov_fused/krylov_fused.py``:

* :func:`fused_matvec_dot` — ``(A p, p . A p)`` in one pass over the bands
  and ``p``; replaces ``spmv_dot_single`` (stacked wrapper
  ``fused_matvec_dot``);
* :func:`fused_update_step` — ``x' = x + alpha p``, ``r' = r - alpha Ap``,
  ``z = r' * inv_diag`` and the ``r'.z``, ``r'.r'`` dots in one pass;
  replaces ``fused_axpy_precond_single`` (stacked wrapper
  ``fused_update_step``).

Both are bound by bytes.  Each reduction writes one accum-width partial per
:data:`KERNEL_BLOCK_ROWS` consecutive flat rows, summed in a fixed tree
order (:func:`block_partials_plain` is that order in plain PyTorch); the
wrapper sums the partials with ``torch.sum``, a fixed order.  Beside each
kernel is its plain PyTorch version (:func:`spmv_dot_plain`,
:func:`fused_axpy_precond_plain`), which the wrappers take for CPU tensors
only; for CUDA tensors they launch the kernel or raise.
:func:`spmv_dot_partials` and :func:`axpy_precond_partials` return the
partials themselves (their plain versions :func:`spmv_dot_partials_plain`,
:func:`axpy_precond_partials_plain` compute them bit for bit).

The Krylov loops of :mod:`repro_torch.solvers.device_loop` write into
buffers they hold at fixed addresses and guard every iteration on a
one-element device flag: :func:`fused_matvec_dot_into` and
:func:`fused_update_step_into` are the two wrappers in that form (the
latter updates ``x`` and ``r`` in place, through the kernel's in-place
instantiation), with :func:`partials_buffers` for their scratch.  On the
CPU they run the plain versions and store through
:func:`~repro_torch.kernels.spmv_dia.spmv_dia.guarded_store`.

:func:`spmv_dot_cost` and :func:`fused_axpy_precond_cost` are the JAX
package's byte and flop contracts, as ints.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import dtype_code, load
from repro_torch.kernels.device_counts import count_ptr
from repro_torch.kernels.spmv_dia.spmv_dia import (
    KERNEL_BLOCK_ROWS, _offsets_arg, check_flag, check_out,
    check_stacked_operands, guarded_store, stream_ptr)
from repro_torch.sparse.distributed import spmv_dia

__all__ = ["fused_matvec_dot", "fused_update_step", "spmv_dot_partials",
           "axpy_precond_partials", "fused_matvec_dot_into",
           "fused_update_step_into", "axpy_precond_inplace",
           "partials_buffers", "spmv_dot_plain", "spmv_dot_partials_plain",
           "fused_axpy_precond_plain", "axpy_precond_partials_plain",
           "block_partials_plain", "check_axpy_operands", "spmv_dot_cost",
           "fused_axpy_precond_cost", "DEFAULT_BLOCK_ROWS"]

# the JAX kernels' row block, the default of the cost contracts below
DEFAULT_BLOCK_ROWS = 2048


def spmv_dot_cost(nb: int, m: int, plane: int, itemsize: int = 8,
                  block_rows: int = DEFAULT_BLOCK_ROWS,
                  accum_itemsize: int | None = None) -> dict:
    """Bytes and flops of ``(A p, p . A p)`` on one part of ``m`` rows.

    Bands once, ``x_pad`` once, ``Ap`` out, and ``ceil(m / block_rows)``
    partial slots at ``accum_itemsize`` (default: the storage width).  For
    the stacked kernel, pass the total row count, ``plane=0`` (the halo of
    a part is its neighbours' rows, already counted) and
    ``block_rows=KERNEL_BLOCK_ROWS``.
    """
    n_blocks = -(-m // block_rows)
    acc = accum_itemsize if accum_itemsize is not None else itemsize
    return {"bytes_accessed": (nb * m + (m + 2 * plane) + m) * itemsize
            + n_blocks * acc,
            "flops": 2 * nb * m + 2 * m, "transcendentals": 0}


def fused_axpy_precond_cost(m: int, itemsize: int = 8,
                            block_rows: int = DEFAULT_BLOCK_ROWS,
                            accum_itemsize: int | None = None) -> dict:
    """Bytes and flops of the fused axpy pair + Jacobi + two dots on ``m``
    rows: reads x, r, p, Ap, inv_diag; writes x', r', z and two partials
    per block."""
    n_blocks = -(-m // block_rows)
    acc = accum_itemsize if accum_itemsize is not None else itemsize
    return {"bytes_accessed": (5 * m + 3 * m) * itemsize + 2 * n_blocks * acc,
            "flops": 9 * m, "transcendentals": 0}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def spmv_dot_plain(bands: torch.Tensor, x: torch.Tensor, *,
                   offsets: tuple[int, ...], plane: int,
                   accum_dtype: torch.dtype | None = None):
    """``(A x, x . A x)`` over stacked parts; the dot consumes the
    accum-width ``Ax`` before it is narrowed to the storage dtype."""
    acc = accum_dtype or bands.dtype
    y = spmv_dia(bands.to(acc), x.to(acc), offsets=offsets, plane=plane)
    return y.to(bands.dtype), _vdot(x.to(acc), y)


def block_partials_plain(v: torch.Tensor,
                         block_rows: int = KERNEL_BLOCK_ROWS) -> torch.Tensor:
    """The kernels' reduction partials of ``v`` in their order: ``v``
    flattened and zero-padded to whole blocks of ``block_rows`` (a power of
    two), each block summed pairwise, ``a[:, :h] + a[:, h:]`` for ``h`` =
    ``block_rows / 2`` down to 1 (the tree order of ``csrc/common.cuh``)."""
    v = v.reshape(-1)
    n_blocks = -(-v.numel() // block_rows)
    a = v.new_zeros(n_blocks * block_rows)
    a[:v.numel()] = v
    a = a.reshape(n_blocks, block_rows)
    h = block_rows // 2
    while h >= 1:
        a = a[:, :h] + a[:, h:]
        h //= 2
    return a[:, 0]


def spmv_dot_partials_plain(bands: torch.Tensor, x: torch.Tensor, *,
                            offsets: tuple[int, ...], plane: int,
                            accum_dtype: torch.dtype | None = None):
    """``(A x, partials)`` as the kernel computes them, bit for bit: the
    SpMV at the accum width, narrowed, and :func:`block_partials_plain` of
    ``x . A x``'s accum-width terms."""
    acc = accum_dtype or bands.dtype
    xa = x.to(acc)
    y = spmv_dia(bands.to(acc), xa, offsets=offsets, plane=plane)
    return y.to(bands.dtype), block_partials_plain(xa * y)


def _axpy_vectors(x, r, p, Ap, inv_diag, alpha):
    a = alpha.to(x.dtype)
    rn = r - a * Ap
    return x + a * p, rn, rn * inv_diag


def fused_axpy_precond_plain(x, r, p, Ap, inv_diag, alpha,
                             accum_dtype: torch.dtype | None = None):
    """``(x', r', z, r'.z, r'.r')`` over stacked parts."""
    acc = accum_dtype or x.dtype
    xn, rn, z = _axpy_vectors(x, r, p, Ap, inv_diag, alpha)
    rn_a = rn.to(acc)
    return xn, rn, z, _vdot(rn_a, z.to(acc)), _vdot(rn_a, rn_a)


def axpy_precond_partials_plain(x, r, p, Ap, inv_diag, alpha,
                                accum_dtype: torch.dtype | None = None):
    """``(x', r', z, rz_partials, rr_partials)`` as the kernel computes
    them, bit for bit: the plain version's vectors and
    :func:`block_partials_plain` of the accum-width ``r'.z`` and ``r'.r'``
    terms."""
    acc = accum_dtype or x.dtype
    xn, rn, z = _axpy_vectors(x, r, p, Ap, inv_diag, alpha)
    rn_a = rn.to(acc)
    return (xn, rn, z, block_partials_plain(rn_a * z.to(acc)),
            block_partials_plain(rn_a * rn_a))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def spmv_dot_partials(bands: torch.Tensor, x: torch.Tensor, *,
                      offsets: tuple[int, ...], plane: int,
                      accum_dtype: torch.dtype | None = None,
                      out: tuple | None = None,
                      active: torch.Tensor | None = None):
    """``(A x, partials)``: ``A x`` in the storage dtype and the ``x . A x``
    partials, one per :data:`KERNEL_BLOCK_ROWS` flat rows, in the accum
    dtype.  ``out``: the two buffers ``(y, partials)`` to write (default:
    new ones); ``active``: the loop guard (needs ``out``).  On CPU
    tensors: :func:`spmv_dot_partials_plain`."""
    if bands.device.type == "cpu" and x.device.type == "cpu":
        y, part = spmv_dot_partials_plain(bands, x, offsets=offsets,
                                          plane=plane,
                                          accum_dtype=accum_dtype)
        if out is None:
            return guarded_store(None, y, active), part
        return (guarded_store(out[0], y, active),
                guarded_store(out[1], part, active))
    acc = accum_dtype or bands.dtype
    check_stacked_operands(bands, x, offsets, plane)
    code = dtype_code(bands.dtype, acc)
    P, nb, m = bands.shape
    n_part = -(-P * m // KERNEL_BLOCK_ROWS)
    if out is None:
        if active is not None:
            raise ValueError("a guarded call needs out=")
        y = torch.empty_like(x)
        part = torch.empty((n_part,), dtype=acc, device=x.device)
    else:
        y = check_out(out[0], x)
        part = out[1]
        if (part.shape != (n_part,) or part.dtype != acc
                or part.device != x.device or not part.is_contiguous()):
            raise ValueError(f"partials must be a contiguous ({n_part},) "
                             f"{acc} tensor on {x.device}")
    lib = load("krylov_fused")
    args = (code, bands.data_ptr(), x.data_ptr(), y.data_ptr(),
            part.data_ptr(), P, m, _offsets_arg(offsets), nb)
    if active is None:
        rc = lib.spmv_dot_launch(*args, stream_ptr(x))
    else:
        rc = lib.spmv_dot_guarded_launch(
            *args, check_flag(active, x.device),
            count_ptr("spmv_dot", x.device, active), stream_ptr(x))
    if rc != 0:
        raise RuntimeError(f"spmv_dot kernel launch failed (code {rc})")
    if active is None:  # a guarded launch counts itself on the device
        fused_matvec_dot.launches += 1
    return y, part


def fused_matvec_dot(bands: torch.Tensor, x: torch.Tensor, *,
                     offsets: tuple[int, ...], plane: int,
                     accum_dtype: torch.dtype | None = None):
    """``(A x, x . A x)``: bands (P, nb, m), x (P, m); the dot is a global
    0-d tensor in the accum dtype (``None``: the storage dtype)."""
    if bands.device.type == "cpu" and x.device.type == "cpu":
        return spmv_dot_plain(bands, x, offsets=offsets, plane=plane,
                              accum_dtype=accum_dtype)
    y, part = spmv_dot_partials(bands, x, offsets=offsets, plane=plane,
                                accum_dtype=accum_dtype)
    return y, part.sum()


def check_axpy_operands(vecs, alpha: torch.Tensor) -> list[int]:
    """Raise unless the five vectors (one shape, dtype and CUDA device;
    contiguous; 16-byte aligned, for the kernel's vector loads) and the
    one-element ``alpha`` on their device suit the kernel; returns the
    vectors' data pointers."""
    x = vecs[0]
    dev, dtype, shape = x.device, x.dtype, x.shape
    for v in vecs[1:]:
        if v.device != dev or v.dtype != dtype or v.shape != shape:
            raise ValueError("x, r, p, Ap, inv_diag must share device, dtype "
                             "and shape")
    if not all(v.is_contiguous() for v in vecs):
        raise ValueError("kernel operands must be contiguous")
    ptrs = [v.data_ptr() for v in vecs]
    if any(ptr % 16 for ptr in ptrs):
        raise ValueError("kernel operands must start on a 16-byte boundary")
    if dev.type != "cuda" or alpha.device != dev or alpha.numel() != 1:
        raise ValueError("alpha must be a one-element tensor on the vectors' "
                         "CUDA device")
    return ptrs


# the partial rows' stride in elements: 512 bytes or more apart, so the r.r
# row is aligned as a buffer of its own would be and torch.sum reduces it
# in the same order
_PARTIAL_STRIDE = 128


def _axpy_launch(vecs, alpha: torch.Tensor, acc: torch.dtype):
    """Launch the kernel on CUDA operands: ``(x', r', z, rz_partials,
    rr_partials)``, the partials two rows of one buffer."""
    x = vecs[0]
    code = dtype_code(x.dtype, acc)
    ptrs = check_axpy_operands(vecs, alpha)
    if alpha.dtype != acc:
        alpha = alpha.to(acc)
    n = x.numel()
    nb = -(-n // KERNEL_BLOCK_ROWS)
    stride = -(-nb // _PARTIAL_STRIDE) * _PARTIAL_STRIDE
    part = torch.empty(2 * stride, dtype=acc, device=x.device)
    xo, ro, zo = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    rz_ptr = part.data_ptr()
    rc = load("krylov_fused").axpy_precond_launch(
        code, *ptrs, alpha.data_ptr(), xo.data_ptr(), ro.data_ptr(),
        zo.data_ptr(), rz_ptr, rz_ptr + stride * part.element_size(), n,
        stream_ptr(x))
    if rc != 0:
        raise RuntimeError(f"axpy_precond kernel launch failed (code {rc})")
    fused_update_step.launches += 1
    return xo, ro, zo, part[:nb], part[stride:stride + nb]


def _on_cpu(vecs, alpha: torch.Tensor) -> bool:
    return alpha.device.type == "cpu" and all(v.device.type == "cpu"
                                              for v in vecs)


def axpy_precond_partials(x, r, p, Ap, inv_diag, alpha,
                          accum_dtype: torch.dtype | None = None):
    """``(x', r', z, rz_partials, rr_partials)``: the vectors in the
    storage dtype and the ``r'.z``, ``r'.r'`` partials, one per
    :data:`KERNEL_BLOCK_ROWS` flat rows, in the accum dtype.  On CPU
    tensors: :func:`axpy_precond_partials_plain`."""
    vecs = (x, r, p, Ap, inv_diag)
    if _on_cpu(vecs, alpha):
        return axpy_precond_partials_plain(*vecs, alpha,
                                           accum_dtype=accum_dtype)
    return _axpy_launch(vecs, alpha, accum_dtype or x.dtype)


def fused_update_step(x, r, p, Ap, inv_diag, alpha,
                      accum_dtype: torch.dtype | None = None):
    """Fused axpy pair + Jacobi apply + global ``(r'.z, r'.r')`` dots.

    Vectors stacked (P, m) in one storage dtype; ``alpha`` a 0-d tensor on
    the same device (any float dtype; narrowed to the storage dtype).
    Returns ``(x', r', z, rz, rr)``, the dots in the accum dtype.
    """
    vecs = (x, r, p, Ap, inv_diag)
    if _on_cpu(vecs, alpha):
        return fused_axpy_precond_plain(*vecs, alpha, accum_dtype=accum_dtype)
    xo, ro, zo, rz, rr = _axpy_launch(vecs, alpha, accum_dtype or x.dtype)
    return xo, ro, zo, rz.sum(), rr.sum()


# ---------------------------------------------------------------------------
# the Krylov loops' forms: fixed buffers, in place, guarded
# ---------------------------------------------------------------------------

def partials_buffers(n: int, accum_dtype: torch.dtype,
                     device: torch.device) -> dict:
    """The reductions' scratch for ``n`` flat rows: ``{"dot": the SpMV+dot
    partials, "rz", "rr": the axpy kernel's two partial rows}`` (the rows
    two views of one buffer laid out as :func:`fused_update_step`'s)."""
    nb = -(-n // KERNEL_BLOCK_ROWS)
    stride = -(-nb // _PARTIAL_STRIDE) * _PARTIAL_STRIDE
    axpy = torch.empty(2 * stride, dtype=accum_dtype, device=device)
    return {"dot": torch.empty(nb, dtype=accum_dtype, device=device),
            "rz": axpy[:nb], "rr": axpy[stride:stride + nb]}


def fused_matvec_dot_into(bands: torch.Tensor, x: torch.Tensor,
                          y: torch.Tensor, dot: torch.Tensor, part: dict, *,
                          offsets: tuple[int, ...], plane: int,
                          accum_dtype: torch.dtype | None = None,
                          active: torch.Tensor | None = None) -> None:
    """:func:`fused_matvec_dot` into ``y`` and the 0-d ``dot`` (accum
    dtype), through the partials of ``part`` (:func:`partials_buffers`),
    under the loop guard ``active``.  On a CUDA device the sum of the
    partials is ``torch.sum`` into ``dot``, unguarded: it only rewrites
    scratch."""
    if bands.device.type == "cpu" and x.device.type == "cpu":
        yy, d = spmv_dot_plain(bands, x, offsets=offsets, plane=plane,
                               accum_dtype=accum_dtype)
        guarded_store(y, yy, active)
        guarded_store(dot, d, active)
        return
    spmv_dot_partials(bands, x, offsets=offsets, plane=plane,
                      accum_dtype=accum_dtype, out=(y, part["dot"]),
                      active=active)
    torch.sum(part["dot"], dim=0, out=dot)


def axpy_precond_inplace(x, r, p, Ap, inv_diag, alpha, z, rz_part, rr_part,
                         accum_dtype: torch.dtype | None = None,
                         active: torch.Tensor | None = None) -> None:
    """``x <- x + alpha p`` and ``r <- r - alpha Ap`` in place, ``z <- r' *
    inv_diag`` and the ``r'.z``, ``r'.r'`` partials into ``rz_part``,
    ``rr_part``; nothing is written while the guard ``active`` is False.
    On CPU tensors: :func:`axpy_precond_partials_plain`, stored through
    :func:`guarded_store`."""
    vecs = (x, r, p, Ap, inv_diag)
    acc = accum_dtype or x.dtype
    if _on_cpu(vecs, alpha):
        new = axpy_precond_partials_plain(*vecs, alpha, accum_dtype=acc)
        for dst, val in zip((x, r, z, rz_part, rr_part), new):
            guarded_store(dst, val, active)
        return
    code = dtype_code(x.dtype, acc)
    ptrs = check_axpy_operands(vecs, alpha)
    check_out(z, x)
    if z.data_ptr() % 16:
        raise ValueError("kernel operands must start on a 16-byte boundary")
    nb = -(-x.numel() // KERNEL_BLOCK_ROWS)
    for part in (rz_part, rr_part):
        if (part.shape != (nb,) or part.dtype != acc
                or part.device != x.device or not part.is_contiguous()):
            raise ValueError(f"partials must be contiguous ({nb},) {acc} "
                             f"tensors on {x.device}")
    if alpha.dtype != acc:
        raise TypeError(f"alpha must be {acc}, got {alpha.dtype}")
    rc = load("krylov_fused").axpy_precond_inplace_launch(
        code, *ptrs, alpha.data_ptr(), z.data_ptr(), rz_part.data_ptr(),
        rr_part.data_ptr(), x.numel(), check_flag(active, x.device),
        count_ptr("axpy_precond", x.device, active), stream_ptr(x))
    if rc != 0:
        raise RuntimeError(f"axpy_precond (in place) kernel launch failed "
                           f"(code {rc})")
    if active is None:  # a guarded launch counts itself on the device
        fused_update_step.launches += 1


def fused_update_step_into(x, r, p, Ap, inv_diag, alpha, z, rz, rr,
                           part: dict, accum_dtype: torch.dtype | None = None,
                           active: torch.Tensor | None = None) -> None:
    """:func:`fused_update_step` with ``x`` and ``r`` updated in place,
    ``z`` and the 0-d dots ``rz``, ``rr`` (accum dtype) written, through
    the partials of ``part`` (:func:`partials_buffers`), under the loop
    guard ``active``.  On a CUDA device the two sums of the partials are
    ``torch.sum`` into ``rz`` and ``rr``, unguarded (scratch)."""
    vecs = (x, r, p, Ap, inv_diag)
    if _on_cpu(vecs, alpha):
        new = fused_axpy_precond_plain(*vecs, alpha, accum_dtype=accum_dtype)
        for dst, val in zip((x, r, z, rz, rr), new):
            guarded_store(dst, val, active)
        return
    axpy_precond_inplace(x, r, p, Ap, inv_diag, alpha, z, part["rz"],
                         part["rr"], accum_dtype=accum_dtype, active=active)
    torch.sum(part["rz"], dim=0, out=rz)
    torch.sum(part["rr"], dim=0, out=rr)


fused_matvec_dot.launches = 0
fused_update_step.launches = 0
