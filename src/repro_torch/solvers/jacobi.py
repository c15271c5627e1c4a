"""Jacobi (diagonal) preconditioner for the stacked solvers."""
from __future__ import annotations

import torch

__all__ = ["jacobi_preconditioner", "safe_jacobi_inverse"]


def safe_jacobi_inverse(diag: torch.Tensor) -> torch.Tensor:
    """``1/diag`` with zero entries inverting to a safe 0, not inf.

    A zero diagonal entry has an exactly-zero residual, but ``inf * 0 =
    NaN`` — one unguarded Jacobi apply poisons every global reduction of
    the solve.  The inner ``where`` keeps the division itself finite.
    """
    nonzero = diag != 0
    one = torch.ones((), dtype=diag.dtype, device=diag.device)
    zero = torch.zeros((), dtype=diag.dtype, device=diag.device)
    return torch.where(nonzero, 1.0 / torch.where(nonzero, diag, one), zero)


def jacobi_preconditioner(diag: torch.Tensor):
    """Return M(r) = r / diag.  ``diag``: stacked (P, m) matrix diagonal."""
    inv = safe_jacobi_inverse(diag)

    def M(r: torch.Tensor) -> torch.Tensor:
        return r * inv

    return M
