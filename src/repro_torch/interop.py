"""Carry solver state and plans in and out of the port as numpy arrays.

The CFD system has no weights: what it carries is the field state
``PisoState(U, p, phi, phi_if, phi_b)`` and the repartition plan.  These
helpers move both across as plain numpy arrays, so a state developed by
another implementation (for example the JAX package, with ``np.asarray``
on each leaf) can be stepped on by the port.  Nothing here imports that
implementation.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.repartition import RepartitionPlan
from repro_torch.env import DTYPE, resolve_device
from repro_torch.fvm.piso import PisoState

__all__ = ["state_from_numpy", "state_to_numpy", "plan_from_numpy"]

_PLAN_INTS = ("alpha", "m_fine", "m_coarse", "plane", "buffer_len",
              "nnz_local", "nnz_localized", "nnz_halo")


def state_from_numpy(arrays: dict, device="cuda",
                     dtype: torch.dtype = DTYPE) -> PisoState:
    """A :class:`PisoState` from ``{field name: ndarray}`` (all five)."""
    dev = resolve_device(device)
    missing = [f for f in PisoState._fields if f not in arrays]
    if missing:
        raise KeyError(f"state fields missing: {missing}")
    return PisoState(**{f: torch.tensor(np.asarray(arrays[f]), dtype=dtype,
                                        device=dev)
                        for f in PisoState._fields})


def state_to_numpy(state: PisoState) -> dict:
    """``{field name: ndarray}`` of a :class:`PisoState` (copied to host)."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in PisoState._fields}


def plan_from_numpy(arrays: dict) -> RepartitionPlan:
    """A DIA :class:`RepartitionPlan` from its arrays and sizes.

    ``arrays`` holds ``dia_offsets``, ``dia_src`` and the integer fields
    (``alpha``, ``m_fine``, ``m_coarse``, ``plane``, ``buffer_len``,
    ``nnz_local``, ``nnz_localized``, ``nnz_halo``) — e.g. the fields of
    another implementation's plan.  The rebuilt plan carries no layout, so
    its ELL target is unavailable.
    """
    return RepartitionPlan(
        **{k: int(arrays[k]) for k in _PLAN_INTS},
        dia_offsets=np.asarray(arrays["dia_offsets"], dtype=np.int32),
        dia_src=np.asarray(arrays["dia_src"], dtype=np.int64))
