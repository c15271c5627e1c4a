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
out-of-place wrappers sum the partials with ``torch.sum``, a fixed order.
Beside each
kernel is its plain PyTorch version (:func:`spmv_dot_plain`,
:func:`fused_axpy_precond_plain`), which the wrappers take for CPU tensors
only; for CUDA tensors they launch the kernel or raise.
:func:`spmv_dot_partials` and :func:`axpy_precond_partials` return the
partials themselves (their plain versions :func:`spmv_dot_partials_plain`,
:func:`axpy_precond_partials_plain` compute them bit for bit).

The Krylov loops of :mod:`repro_torch.solvers.device_loop` write into
buffers they hold at fixed addresses and guard every iteration on a
one-element device flag: the guarded, ``out=`` forms of the wrappers
(:func:`axpy_precond_inplace` updates ``x`` and ``r`` in place, through
the kernel's in-place instantiation), with :func:`partials_buffers` for
their scratch.  On the CPU they run the plain versions and store through
:func:`~repro_torch.kernels.spmv_dia.spmv_dia.guarded_store`.  Given
``lanes=B`` they run a cohort of ``B`` systems of one shape as one launch
(:mod:`repro_torch.kernels.spmv_dia`): one flag, one ``alpha`` and one run
of partials per lane (:func:`lane_partials`).  The CG loop leaves its
partials to the loop's tail kernels, ``cg_alpha`` and ``cg_advance``
(:mod:`repro_torch.kernels.krylov_loop`), which sum them in their own
fixed tree.

The CG loop runs the SpMV+dot with its direction update folded in:
:func:`spmv_dot_direction` (kernel ``spmv_dot_direction_kernel``) forms
``p' = z + beta p`` (``z`` at the loop's first iteration) from the pair of
direction buffers at each lane's count ``k`` (``p[k % 2]`` read,
``p[(k + 1) % 2]`` written), then ``A p'`` and the ``p'.Ap'`` partials —
bitwise ``cg_direction`` followed by :func:`spmv_dot_partials`, one
launch and one round trip of ``p`` fewer.  Its plain version is
:func:`spmv_dot_direction_plain`; the loop's forms are
:func:`fused_matvec_dot_direction_into` and :func:`fused_update_step_into`
(partials only); given ``k``, the in-place axpy reads ``p[(k + 1) % 2]``.

:func:`spmv_dot_cost` and :func:`fused_axpy_precond_cost` are the JAX
package's byte and flop contracts, as ints.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import dtype_code, load
from repro_torch.kernels.device_counts import count_ptr
from repro_torch.kernels.krylov_loop.krylov_loop import (current_direction,
                                                         next_direction_plain,
                                                         store_direction)
from repro_torch.kernels.spmv_dia.spmv_dia import (
    KERNEL_BLOCK_ROWS, _offsets_arg, check_flag, check_lanes, check_out,
    check_stacked_operands, guarded_store, stream_ptr)
from repro_torch.sparse.distributed import spmv_dia

__all__ = ["fused_matvec_dot", "fused_update_step", "spmv_dot_partials",
           "axpy_precond_partials",
           "fused_update_step_into", "axpy_precond_inplace",
           "spmv_dot_direction", "spmv_dot_direction_plain",
           "fused_matvec_dot_direction_into", "spmv_dot_direction_cost",
           "partials_buffers", "spmv_dot_plain", "spmv_dot_partials_plain",
           "fused_axpy_precond_plain", "axpy_precond_partials_plain",
           "block_partials_plain", "lane_block_partials", "lane_partials",
           "lane_vdot", "check_axpy_operands", "spmv_dot_cost",
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


def spmv_dot_direction_cost(nb: int, n: int, itemsize: int = 8,
                            accum_itemsize: int | None = None) -> dict:
    """Bytes and flops of the direction update folded into the SpMV+dot
    on ``n`` stacked rows: the bands, ``z`` and the old direction read
    once, the new one and ``A p'`` written once, one partial per
    :data:`KERNEL_BLOCK_ROWS` rows; the flops of ``z + beta p`` counted
    once a row."""
    acc = accum_itemsize if accum_itemsize is not None else itemsize
    return {"bytes_accessed": (nb + 4) * n * itemsize
            + -(-n // KERNEL_BLOCK_ROWS) * acc,
            "flops": 2 * nb * n + 2 * n + 2 * n, "transcendentals": 0}


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


def lane_vdot(a: torch.Tensor, b: torch.Tensor,
              lanes: int | None = None) -> torch.Tensor:
    """The dot of ``a`` and ``b``: 0-d for ``lanes=None``; else ``(lanes,)``,
    lane ``l``'s the ``torch.dot`` of its own contiguous slices (the call
    that lane makes alone)."""
    if lanes is None:
        return _vdot(a, b)
    return torch.stack([torch.dot(u, v) for u, v in
                        zip(a.reshape(lanes, -1), b.reshape(lanes, -1))])


# the partial rows' stride in elements: 512 bytes or more apart, so the r.r
# row (and each lane's run) is aligned as a buffer of its own would be and
# torch.sum reduces it in the same order
_PARTIAL_STRIDE = 128


def lane_partials(n: int, lanes: int = 1) -> tuple[int, int]:
    """``(partials per lane, elements from one lane's to the next)`` of a
    reduction over ``n`` stacked rows in ``lanes`` lanes: one partial per
    :data:`KERNEL_BLOCK_ROWS` rows of a lane; one lane packs them, a
    cohort starts each lane's run at a multiple of 128."""
    npl = -(-(n // lanes) // KERNEL_BLOCK_ROWS)
    if lanes == 1:
        return npl, npl
    return npl, -(-npl // _PARTIAL_STRIDE) * _PARTIAL_STRIDE


def lane_block_partials(v: torch.Tensor, lanes: int = 1) -> torch.Tensor:
    """:func:`block_partials_plain` of each lane of ``v`` at its place in
    the cohort layout of :func:`lane_partials` (zeros between runs)."""
    if lanes == 1:
        return block_partials_plain(v)
    npl, stride = lane_partials(v.numel(), lanes)
    out = v.new_zeros(lanes * stride)
    for lane, vl in enumerate(v.reshape(lanes, -1)):
        out[lane * stride:lane * stride + npl] = block_partials_plain(vl)
    return out


def spmv_dot_plain(bands: torch.Tensor, x: torch.Tensor, *,
                   offsets: tuple[int, ...], plane: int,
                   accum_dtype: torch.dtype | None = None,
                   lanes: int = 1):
    """``(A x, x . A x)`` over stacked parts; the dot consumes the
    accum-width ``Ax`` before it is narrowed to the storage dtype.  With
    ``lanes > 1`` the dot is one per lane, ``(lanes,)``."""
    acc = accum_dtype or bands.dtype
    y = spmv_dia(bands.to(acc), x.to(acc), offsets=offsets, plane=plane,
                 lanes=lanes)
    return y.to(bands.dtype), lane_vdot(x.to(acc), y,
                                        None if lanes == 1 else lanes)


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
                            accum_dtype: torch.dtype | None = None,
                            lanes: int = 1):
    """``(A x, partials)`` as the kernel computes them, bit for bit: the
    SpMV at the accum width, narrowed, and :func:`block_partials_plain` of
    ``x . A x``'s accum-width terms (per lane, laid out as
    :func:`lane_partials` says)."""
    acc = accum_dtype or bands.dtype
    xa = x.to(acc)
    y = spmv_dia(bands.to(acc), xa, offsets=offsets, plane=plane,
                 lanes=lanes)
    return y.to(bands.dtype), lane_block_partials(xa * y, lanes)


def spmv_dot_direction_plain(bands: torch.Tensor, z: torch.Tensor,
                             p: torch.Tensor, beta: torch.Tensor,
                             k: torch.Tensor, *, offsets: tuple[int, ...],
                             plane: int,
                             accum_dtype: torch.dtype | None = None,
                             lanes: int = 1):
    """``(p', A p', partials)`` as :func:`spmv_dot_direction`'s kernel
    computes them, bit for bit, nothing stored: ``p'`` of
    :func:`~repro_torch.kernels.krylov_loop.krylov_loop.next_direction_plain`
    (from the pair ``p`` at the counts ``k``, one ``beta`` and ``k`` per
    lane), then :func:`spmv_dot_partials_plain` of ``p'``."""
    new = next_direction_plain(p, z, beta, k)
    y, part = spmv_dot_partials_plain(bands, new, offsets=offsets,
                                      plane=plane, accum_dtype=accum_dtype,
                                      lanes=lanes)
    return new, y, part


def _axpy_vectors(x, r, p, Ap, inv_diag, alpha):
    """``(x', r', z)`` with one ``alpha`` per lane (``alpha.numel()`` lanes,
    each a contiguous run of the vectors)."""
    lanes = alpha.numel()
    a = alpha.to(x.dtype).reshape(lanes, 1)

    def v(t):
        return t.reshape(lanes, -1)

    rn = v(r) - a * v(Ap)
    xn = v(x) + a * v(p)
    z = rn * v(inv_diag)
    return xn.view(x.shape), rn.view(x.shape), z.view(x.shape)


def fused_axpy_precond_plain(x, r, p, Ap, inv_diag, alpha,
                             accum_dtype: torch.dtype | None = None):
    """``(x', r', z, r'.z, r'.r')`` over stacked parts; a 0-d ``alpha``
    gives 0-d dots, a ``(B,)`` one the dots of ``B`` lanes."""
    acc = accum_dtype or x.dtype
    xn, rn, z = _axpy_vectors(x, r, p, Ap, inv_diag, alpha)
    rn_a = rn.to(acc)
    lanes = None if alpha.dim() == 0 else alpha.numel()
    return (xn, rn, z, lane_vdot(rn_a, z.to(acc), lanes),
            lane_vdot(rn_a, rn_a, lanes))


def axpy_precond_partials_plain(x, r, p, Ap, inv_diag, alpha,
                                accum_dtype: torch.dtype | None = None):
    """``(x', r', z, rz_partials, rr_partials)`` as the kernel computes
    them, bit for bit: the plain version's vectors and
    :func:`block_partials_plain` of the accum-width ``r'.z`` and ``r'.r'``
    terms (per lane of ``alpha.numel()``, laid out as
    :func:`lane_partials` says)."""
    acc = accum_dtype or x.dtype
    lanes = alpha.numel()
    xn, rn, z = _axpy_vectors(x, r, p, Ap, inv_diag, alpha)
    rn_a = rn.to(acc)
    return (xn, rn, z, lane_block_partials(rn_a * z.to(acc), lanes),
            lane_block_partials(rn_a * rn_a, lanes))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def spmv_dot_partials(bands: torch.Tensor, x: torch.Tensor, *,
                      offsets: tuple[int, ...], plane: int,
                      accum_dtype: torch.dtype | None = None,
                      out: tuple | None = None,
                      active: torch.Tensor | None = None,
                      lanes: int = 1):
    """``(A x, partials)``: ``A x`` in the storage dtype and the ``x . A x``
    partials, one per :data:`KERNEL_BLOCK_ROWS` flat rows of a lane, in the
    accum dtype (per lane as :func:`lane_partials` lays them out).
    ``out``: the two buffers ``(y, partials)`` to write (default: new
    ones); ``active``: the loop guard, one flag per lane (needs ``out``).
    On CPU tensors: :func:`spmv_dot_partials_plain`."""
    if bands.device.type == "cpu" and x.device.type == "cpu":
        y, part = spmv_dot_partials_plain(bands, x, offsets=offsets,
                                          plane=plane,
                                          accum_dtype=accum_dtype,
                                          lanes=lanes)
        if out is None:
            return guarded_store(None, y, active), part
        return (guarded_store(out[0], y, active),
                guarded_store(out[1], part, active))
    acc = accum_dtype or bands.dtype
    check_stacked_operands(bands, x, offsets, plane)
    code = dtype_code(bands.dtype, acc)
    P, nb, m = bands.shape
    P_lane = check_lanes(P, lanes)
    npl, stride = lane_partials(P * m, lanes)
    n_part = lanes * stride if lanes > 1 else npl
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
            part.data_ptr(), P_lane, m, _offsets_arg(offsets), nb, lanes,
            stride)
    if active is None:
        rc = lib.spmv_dot_launch(*args, stream_ptr(x))
    else:
        rc = lib.spmv_dot_guarded_launch(
            *args, check_flag(active, x.device, lanes),
            count_ptr("spmv_dot", x.device, active), stream_ptr(x))
    if rc != 0:
        raise RuntimeError(f"spmv_dot kernel launch failed (code {rc})")
    if active is None:  # a guarded launch counts itself on the device
        fused_matvec_dot.launches += 1
    return y, part


def check_direction_pair(p: torch.Tensor, like: torch.Tensor) -> None:
    """Raise unless ``p`` is a pair of direction buffers ``(2,
    *like.shape)`` of ``like``'s dtype and device, each contiguous."""
    if (p.shape != (2, *like.shape) or p.dtype != like.dtype
            or p.device != like.device
            or not (p[0].is_contiguous() and p[1].is_contiguous())):
        raise ValueError(f"the direction pair must be two contiguous "
                         f"{like.dtype} buffers of shape "
                         f"{tuple(like.shape)} on {like.device}")


def check_lane_scalars(lanes: int, device: torch.device,
                       **scalars: tuple) -> None:
    """Raise unless each named ``(tensor, dtype)`` holds one element of its
    dtype per lane, contiguous, on ``device``."""
    for name, (t, dtype) in scalars.items():
        if (t.dtype != dtype or t.numel() != lanes or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor "
                             f"of {lanes} element(s) on {device}")


def spmv_dot_direction(bands: torch.Tensor, z: torch.Tensor,
                       p: torch.Tensor, beta: torch.Tensor, k: torch.Tensor,
                       *, offsets: tuple[int, ...], plane: int,
                       accum_dtype: torch.dtype | None = None,
                       out: tuple | None = None,
                       active: torch.Tensor | None = None, lanes: int = 1):
    """The CG direction update folded into the SpMV+dot (module doc): in
    each lane, ``p' = z`` where its count ``k`` is 0 and ``z + beta p[k %
    2]`` after, written to ``p[(k + 1) % 2]``; returns ``(A p',
    partials)`` as :func:`spmv_dot_partials` lays them out.  ``z`` (P, m)
    and the pair ``p`` (:func:`~repro_torch.kernels.krylov_loop.
    krylov_loop.direction_pair`, (2, P, m)) in the bands' dtype; ``beta``
    (accum dtype) and ``k`` (int32) one element per lane; ``out``, the
    buffers ``(y, partials)`` to write (default: new ones); ``active``, the
    loop guard (needs ``out``).  On CPU tensors:
    :func:`spmv_dot_direction_plain`, stored as the kernel stores."""
    if out is None and active is not None:
        raise ValueError("a guarded call needs out=")
    if bands.device.type == "cpu" and z.device.type == "cpu":
        new, y, part = spmv_dot_direction_plain(
            bands, z, p, beta, k, offsets=offsets, plane=plane,
            accum_dtype=accum_dtype, lanes=lanes)
        store_direction(p, new, k, active)
        if out is None:
            return y, part
        return (guarded_store(out[0], y, active),
                guarded_store(out[1], part, active))
    acc = accum_dtype or bands.dtype
    check_stacked_operands(bands, z, offsets, plane)
    check_direction_pair(p, z)
    code = dtype_code(bands.dtype, acc)
    P, nb, m = bands.shape
    P_lane = check_lanes(P, lanes)
    check_lane_scalars(lanes, z.device, beta=(beta, acc),
                       k=(k, torch.int32))
    npl, stride = lane_partials(P * m, lanes)
    n_part = lanes * stride if lanes > 1 else npl
    if out is None:
        out = (torch.empty_like(z),
               torch.empty((n_part,), dtype=acc, device=z.device))
    y, part = check_out(out[0], z), out[1]
    if (part.shape != (n_part,) or part.dtype != acc
            or part.device != z.device or not part.is_contiguous()):
        raise ValueError(f"partials must be a contiguous ({n_part},) "
                         f"{acc} tensor on {z.device}")
    rc = load("krylov_fused").spmv_dot_direction_launch(
        code, bands.data_ptr(), z.data_ptr(), p[0].data_ptr(),
        p[1].data_ptr(), y.data_ptr(), part.data_ptr(), beta.data_ptr(),
        k.data_ptr(), P_lane, m, _offsets_arg(offsets), nb, lanes, stride,
        check_flag(active, z.device, lanes),
        count_ptr("spmv_dot_direction", z.device, active), stream_ptr(z))
    if rc != 0:
        raise RuntimeError(f"spmv_dot_direction kernel launch failed "
                           f"(code {rc})")
    if active is None:  # a guarded launch counts itself on the device
        spmv_dot_direction.launches += 1
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


def check_axpy_operands(vecs, alpha: torch.Tensor,
                        lanes: int = 1) -> list[int]:
    """Raise unless the five vectors (one shape, dtype and CUDA device;
    contiguous; 16-byte aligned, for the kernel's vector loads) and
    ``alpha``, one element per lane on their device, suit the kernel;
    returns the vectors' data pointers."""
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
    if (dev.type != "cuda" or alpha.device != dev
            or alpha.numel() != lanes or not alpha.is_contiguous()):
        raise ValueError(f"alpha must be a contiguous tensor of {lanes} "
                         f"element(s) on the vectors' CUDA device")
    return ptrs


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
                     device: torch.device, lanes: int = 1) -> dict:
    """The reductions' scratch for ``n`` flat rows in ``lanes`` lanes:
    ``{"dot": the SpMV+dot partials, "rz", "rr": the axpy kernel's two
    partial rows, "npl", "stride": partials per lane and the elements from
    one lane's to the next}`` (:func:`lane_partials`; for one lane the
    rows are two views of one buffer laid out as
    :func:`fused_update_step`'s)."""
    npl, stride = lane_partials(n, lanes)
    if lanes == 1:
        row = -(-npl // _PARTIAL_STRIDE) * _PARTIAL_STRIDE
        axpy = torch.empty(2 * row, dtype=accum_dtype, device=device)
        return {"dot": torch.empty(npl, dtype=accum_dtype, device=device),
                "rz": axpy[:npl], "rr": axpy[row:row + npl], "npl": npl,
                "stride": stride}
    size = lanes * stride
    axpy = torch.empty(2 * size, dtype=accum_dtype, device=device)
    return {"dot": torch.empty(size, dtype=accum_dtype, device=device),
            "rz": axpy[:size], "rr": axpy[size:], "npl": npl,
            "stride": stride}


def fused_matvec_dot_direction_into(bands: torch.Tensor, z: torch.Tensor,
                                    p: torch.Tensor, beta: torch.Tensor,
                                    k: torch.Tensor, Ap: torch.Tensor,
                                    part: dict, *,
                                    offsets: tuple[int, ...], plane: int,
                                    accum_dtype: torch.dtype | None = None,
                                    active: torch.Tensor | None = None,
                                    lanes: int = 1) -> None:
    """:func:`spmv_dot_direction` into ``Ap`` and the ``p'.Ap'`` partials
    ``part["dot"]`` (:func:`partials_buffers`), under the loop guard: the
    CG loop's fold.  The partials are summed by the loop's next launch,
    :func:`~repro_torch.kernels.krylov_loop.krylov_loop.cg_alpha`; on the
    CPU, the plain version stored as the kernel stores."""
    spmv_dot_direction(bands, z, p, beta, k, offsets=offsets, plane=plane,
                       accum_dtype=accum_dtype, out=(Ap, part["dot"]),
                       active=active, lanes=lanes)


def axpy_precond_inplace(x, r, p, Ap, inv_diag, alpha, z, rz_part, rr_part,
                         accum_dtype: torch.dtype | None = None,
                         active: torch.Tensor | None = None,
                         lanes: int = 1, k: torch.Tensor | None = None
                         ) -> None:
    """``x <- x + alpha p`` and ``r <- r - alpha Ap`` in place, ``z <- r' *
    inv_diag`` and the ``r'.z``, ``r'.r'`` partials into ``rz_part``,
    ``rr_part`` (per lane as :func:`lane_partials` lays them out); ``alpha``
    and the guard ``active`` hold one element per lane, and nothing of a
    lane is written while its flag is False.  With ``k`` (the CG loop's
    count, int32, one per lane) ``p`` is the pair of direction buffers and
    lane ``l`` reads ``p[(k[l] + 1) % 2]``, the direction
    :func:`spmv_dot_direction` wrote.  On CPU tensors:
    :func:`axpy_precond_partials_plain`, stored through
    :func:`guarded_store`."""
    pair = p
    if k is not None:
        p = current_direction(p, k) if p.device.type == "cpu" else p[0]
    vecs = (x, r, p, Ap, inv_diag)
    acc = accum_dtype or x.dtype
    if _on_cpu(vecs, alpha):
        new = axpy_precond_partials_plain(*vecs, alpha.reshape(lanes),
                                          accum_dtype=acc)
        for dst, val in zip((x, r, z, rz_part, rr_part), new):
            guarded_store(dst, val, active)
        return
    code = dtype_code(x.dtype, acc)
    ptrs = check_axpy_operands(vecs, alpha, lanes)
    p1, iter_ptr = ptrs[2], 0
    if k is not None:
        check_direction_pair(pair, x)
        check_lane_scalars(lanes, x.device, k=(k, torch.int32))
        p1, iter_ptr = pair[1].data_ptr(), k.data_ptr()
        if p1 % 16:
            raise ValueError("kernel operands must start on a 16-byte "
                             "boundary")
    check_out(z, x)
    if z.data_ptr() % 16:
        raise ValueError("kernel operands must start on a 16-byte boundary")
    n = check_lanes(x.numel(), lanes, x.element_size())
    npl, stride = lane_partials(x.numel(), lanes)
    size = lanes * stride if lanes > 1 else npl
    for part in (rz_part, rr_part):
        if (part.shape != (size,) or part.dtype != acc
                or part.device != x.device or not part.is_contiguous()):
            raise ValueError(f"partials must be contiguous ({size},) {acc} "
                             f"tensors on {x.device}")
    if alpha.dtype != acc:
        raise TypeError(f"alpha must be {acc}, got {alpha.dtype}")
    rc = load("krylov_fused").axpy_precond_inplace_launch(
        code, *ptrs[:3], p1, iter_ptr, *ptrs[3:], alpha.data_ptr(),
        z.data_ptr(), rz_part.data_ptr(),
        rr_part.data_ptr(), n, lanes, stride,
        check_flag(active, x.device, lanes),
        count_ptr("axpy_precond", x.device, active), stream_ptr(x))
    if rc != 0:
        raise RuntimeError(f"axpy_precond (in place) kernel launch failed "
                           f"(code {rc})")
    if active is None:  # a guarded launch counts itself on the device
        fused_update_step.launches += 1


def fused_update_step_into(x, r, p, Ap, inv_diag, alpha, z, part: dict,
                           accum_dtype: torch.dtype | None = None,
                           active: torch.Tensor | None = None,
                           lanes: int = 1,
                           k: torch.Tensor | None = None) -> None:
    """:func:`axpy_precond_inplace` into the partials of ``part``
    (:func:`partials_buffers`): ``x`` and ``r`` updated in place, ``z``
    and the ``r'.z``, ``r'.r'`` partials written under the loop guard
    ``active``; with ``k``, ``p`` is the direction pair.  The CG loop's
    axpy: the loop's next launch,
    :func:`~repro_torch.kernels.krylov_loop.krylov_loop.cg_advance`, sums
    the partials."""
    axpy_precond_inplace(x, r, p, Ap, inv_diag, alpha, z, part["rz"],
                         part["rr"], accum_dtype=accum_dtype, active=active,
                         lanes=lanes, k=k)


fused_matvec_dot.launches = 0
fused_update_step.launches = 0
spmv_dot_direction.launches = 0
