"""Launch counters on the card for the Krylov loops' guarded launches.

A wrapper given the loop guard ``active`` on a CUDA device may be recording
into a CUDA graph that :mod:`repro_torch.solvers.device_loop` then replays
many times, with no Python call per replay.  So such a launch is counted
by its kernel: once the guard has passed, thread 0 of block 0 adds one to
the kernel's slot of a per-device int64 tensor (``csrc/common.cuh``:
``count_launch``).  The loop reads the slots once per sweep, together with
its iteration count, and adds them to the wrappers' ``launches``
(:func:`launched`).  A launch without a guard is counted by its wrapper,
at the call.

``cg_advance`` rewrites the lanes' flags, one cluster a lane, so no thread
can read every lane's flag before some lane has rewritten its own: it
counts per lane instead, into a run of :data:`MAX_LANES` counters after
the slots.  Within a sweep a lane whose flag drops never runs again, so
the most any lane counted is the launches in which some lane ran, the
count the other kernels keep.
"""
from __future__ import annotations

import torch

__all__ = ["SLOTS", "PER_LANE", "MAX_LANES", "device_counts", "count_ptr",
           "launched"]

# the kernels that take the loop guard, one counter slot each
SLOTS = ("spmv_dia", "spmv_dot", "axpy_precond", "cg_direction", "cg_advance",
         "spmv_dot_direction", "cg_alpha")
# the kernel that counts per lane (its slot is not written), and the lanes
# its run of counters holds
PER_LANE = "cg_advance"
MAX_LANES = 1024

_counts: dict = {}


def device_counts(device: torch.device | str) -> torch.Tensor:
    """The counters on ``device``: one int64 per name of :data:`SLOTS`,
    then :data:`MAX_LANES` for :data:`PER_LANE`, zero when first made, at a
    fixed address from then on."""
    device = torch.device(device)
    key = (device.index if device.index is not None
           else torch.cuda.current_device())
    counts = _counts.get(key)
    if counts is None:
        counts = _counts[key] = torch.zeros(len(SLOTS) + MAX_LANES,
                                            dtype=torch.int64,
                                            device=device)
    return counts


def count_ptr(name: str, device: torch.device,
              active: torch.Tensor | None) -> int:
    """The address of kernel ``name``'s counter on ``device`` for a guarded
    launch (for :data:`PER_LANE`, of its lanes' run); 0 (not counted on the
    device) when ``active`` is None."""
    if active is None:
        return 0
    counts = device_counts(device)
    slot = len(SLOTS) if name == PER_LANE else SLOTS.index(name)
    return counts.data_ptr() + slot * counts.element_size()


def launched(read: list, lanes: int) -> dict:
    """The launches each kernel of :data:`SLOTS` counted, from the
    counters read as a list (:func:`device_counts` ``.tolist()``) after a
    sweep of ``lanes`` lanes: :data:`PER_LANE`'s the most any lane
    counted."""
    out = dict(zip(SLOTS, read[:len(SLOTS)]))
    out[PER_LANE] = max(read[len(SLOTS):len(SLOTS) + lanes])
    return out
