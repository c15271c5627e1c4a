"""Stacked-part SpMV with z-slab halo exchange.

Arrays are stacked over the part axis (axis 0); the halo of part ``p`` is
the neighbouring parts' boundary planes.  The DIA target (see
:mod:`repro_torch.core.repartition`) stores 7 bands, so SpMV is seven
shifted multiply-adds on an ``x_pad = [down-halo | x | up-halo]`` vector.

:func:`spmv_dia` here is the plain PyTorch version: the reference
backend's operator and the plain counterpart of the hand-written kernel in
:mod:`repro_torch.kernels.spmv_dia`.
"""
from __future__ import annotations

import torch

__all__ = ["halo_exchange", "spmv_dia", "x_pad"]


def halo_exchange(x: torch.Tensor, plane: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Neighbour planes for every part: (down_halo, up_halo), each (P, plane).

    ``down_halo[p] = x[p-1, -plane:]`` (zeros for p=0) and
    ``up_halo[p] = x[p+1, :plane]`` (zeros for p=P-1).  At the physical
    boundary the halo is zero — matching the zero interface coefficients
    there, so the product is exact.
    """
    zeros = torch.zeros((1, plane) + tuple(x.shape[2:]), dtype=x.dtype,
                        device=x.device)
    down = torch.cat([zeros, x[:-1, -plane:]], dim=0)
    up = torch.cat([x[1:, :plane], zeros], dim=0)
    return down, up


def x_pad(x: torch.Tensor, plane: int) -> torch.Tensor:
    """[down-halo | x | up-halo] layout for DIA shifts; (P, m + 2*plane)."""
    down, up = halo_exchange(x, plane)
    return torch.cat([down, x, up], dim=1)


def spmv_dia(bands: torch.Tensor, x: torch.Tensor, *,
             offsets: tuple[int, ...], plane: int,
             accum_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Banded SpMV: y[p, i] = sum_d bands[p, d, i] * x_pad[p, plane + i + off_d].

    bands: (P, n_bands, m); x: (P, m).  Accumulates in band order at
    ``accum_dtype`` (``None``: the storage dtype) and returns ``y`` in the
    storage dtype.
    """
    P, nb, m = bands.shape
    acc = accum_dtype or bands.dtype
    xp = x_pad(x, plane)
    y = torch.zeros((P, m), dtype=acc, device=x.device)
    for d, off in enumerate(offsets):
        xw = xp[:, plane + off: plane + off + m]
        y = y + bands[:, d, :].to(acc) * xw.to(acc)
    return y.to(bands.dtype)
