"""Stacked-part SpMV with z-slab halo exchange.

Arrays are stacked over the part axis (axis 0); the halo of part ``p`` is
the neighbouring parts' boundary planes.  The DIA target (see
:mod:`repro_torch.core.repartition`) stores 7 bands, so SpMV is seven
shifted multiply-adds on an ``x_pad = [down-halo | x | up-halo]`` vector.
The ELL target stores padded rows with explicit column indices into
``x_ext = [x | down-halo | up-halo]``: general but gather-based, the
oracle of the DIA path.

:func:`spmv_dia` here is the plain PyTorch version: the reference
backend's operator and the plain counterpart of the hand-written kernel in
:mod:`repro_torch.kernels.spmv_dia`.  :func:`spmv_ell` is plain PyTorch
only, as in the JAX package, which has no kernel for it.
"""
from __future__ import annotations

import torch

__all__ = ["halo_exchange", "spmv_dia", "spmv_ell", "x_pad", "x_ext"]


def halo_exchange(x: torch.Tensor, plane: int, lane_parts: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Neighbour planes for every part: (down_halo, up_halo), each (P, plane).

    ``down_halo[p] = x[p-1, -plane:]`` (zeros for p=0) and
    ``up_halo[p] = x[p+1, :plane]`` (zeros for p=P-1).  At the physical
    boundary the halo is zero — matching the zero interface coefficients
    there, so the product is exact.

    ``lane_parts``: the parts are a cohort of lanes of ``lane_parts``
    parts each, stacked; the halo is zero at every lane border as at the
    ends, so no part reads a neighbouring lane (``None``: one lane).
    """
    P = x.shape[0]
    if lane_parts is not None and lane_parts != P:
        return _lane_halo(x, plane, lane_parts)
    zeros = torch.zeros((1, plane) + tuple(x.shape[2:]), dtype=x.dtype,
                        device=x.device)
    down = torch.cat([zeros, x[:-1, -plane:]], dim=0)
    up = torch.cat([x[1:, :plane], zeros], dim=0)
    return down, up


def _lane_halo(x: torch.Tensor, plane: int, lane_parts: int):
    """:func:`halo_exchange` per lane of ``lane_parts`` parts."""
    P = x.shape[0]
    if P % lane_parts:
        raise ValueError(f"{P} parts are not lanes of {lane_parts}")
    rest = tuple(x.shape[2:])
    xl = x.reshape((P // lane_parts, lane_parts) + tuple(x.shape[1:]))
    zeros = torch.zeros((P // lane_parts, 1, plane) + rest, dtype=x.dtype,
                        device=x.device)
    down = torch.cat([zeros, xl[:, :-1, -plane:]], dim=1)
    up = torch.cat([xl[:, 1:, :plane], zeros], dim=1)
    return (down.reshape((P, plane) + rest), up.reshape((P, plane) + rest))


def x_pad(x: torch.Tensor, plane: int,
          lane_parts: int | None = None) -> torch.Tensor:
    """[down-halo | x | up-halo] layout for DIA shifts; (P, m + 2*plane)."""
    down, up = halo_exchange(x, plane, lane_parts)
    return torch.cat([down, x, up], dim=1)


def x_ext(x: torch.Tensor, plane: int) -> torch.Tensor:
    """[x | down-halo | up-halo] layout for ELL columns; (P, m + 2*plane)."""
    down, up = halo_exchange(x, plane)
    return torch.cat([x, down, up], dim=1)


def spmv_ell(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, *,
             plane: int) -> torch.Tensor:
    """Padded-ELL SpMV: y[p, i] = sum_k vals[p, i, k] * x_ext[p, cols[i, k]].

    vals: (P, m, K); cols: (m, K) or flattened (m*K,), int32 or int64,
    shared across parts (plan uniformity); x: (P, m).
    """
    P, m, K = vals.shape
    gathered = x_ext(x, plane).index_select(1, cols.reshape(-1))
    return torch.einsum("pik,pik->pi", vals, gathered.reshape(P, m, K))


def spmv_dia(bands: torch.Tensor, x: torch.Tensor, *,
             offsets: tuple[int, ...], plane: int,
             accum_dtype: torch.dtype | None = None,
             lanes: int = 1, halo=None) -> torch.Tensor:
    """Banded SpMV: y[p, i] = sum_d bands[p, d, i] * x_pad[p, plane + i + off_d].

    bands: (P, n_bands, m); x: (P, m).  Accumulates in band order at
    ``accum_dtype`` (``None``: the storage dtype) and returns ``y`` in the
    storage dtype.  ``lanes``: the parts are that many lanes stacked (a
    cohort), each a system of its own: no halo crosses a lane border.
    ``halo``: the ``(down, up)`` neighbour planes, each ``(P, plane)``, in
    place of :func:`halo_exchange`'s (parts whose neighbours are held
    elsewhere).
    """
    P, nb, m = bands.shape
    acc = accum_dtype or bands.dtype
    if P % lanes:
        raise ValueError(f"{P} parts do not split into {lanes} lanes")
    xp = (x_pad(x, plane, P // lanes) if halo is None
          else torch.cat([halo[0], x, halo[1]], dim=1))
    y = torch.zeros((P, m), dtype=acc, device=x.device)
    for d, off in enumerate(offsets):
        xw = xp[:, plane + off: plane + off + m]
        y = y + bands[:, d, :].to(acc) * xw.to(acc)
    return y.to(bands.dtype)
