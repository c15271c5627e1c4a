"""Launch counters on the card for the Krylov loops' guarded launches.

A wrapper given the loop guard ``active`` on a CUDA device may be recording
into a CUDA graph that :mod:`repro_torch.solvers.device_loop` then replays
many times, with no Python call per replay.  So such a launch is counted
by its kernel: once the guard has passed, thread 0 of block 0 adds one to
the kernel's slot of a per-device int64 tensor (``csrc/common.cuh``:
``count_launch``).  The loop reads the slots once per sweep, together with
its iteration count, and adds them to the wrappers' ``launches``.  A launch
without a guard is counted by its wrapper, at the call.
"""
from __future__ import annotations

import torch

__all__ = ["SLOTS", "device_counts", "count_ptr"]

# the kernels that take the loop guard, one counter slot each
SLOTS = ("spmv_dia", "spmv_dot", "axpy_precond", "cg_direction", "cg_advance",
         "spmv_dot_direction")

_counts: dict = {}


def device_counts(device: torch.device | str) -> torch.Tensor:
    """The counters on ``device``: one int64 per name of :data:`SLOTS`,
    zero when first made, at a fixed address from then on."""
    device = torch.device(device)
    key = (device.index if device.index is not None
           else torch.cuda.current_device())
    counts = _counts.get(key)
    if counts is None:
        counts = _counts[key] = torch.zeros(len(SLOTS), dtype=torch.int64,
                                            device=device)
    return counts


def count_ptr(name: str, device: torch.device,
              active: torch.Tensor | None) -> int:
    """The address of kernel ``name``'s counter on ``device`` for a guarded
    launch; 0 (not counted on the device) when ``active`` is None."""
    if active is None:
        return 0
    counts = device_counts(device)
    return counts.data_ptr() + SLOTS.index(name) * counts.element_size()
