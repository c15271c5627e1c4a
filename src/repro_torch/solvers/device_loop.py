"""Device-resident Krylov loops — the port's counterpart of ``lax.while_loop``.

The JAX solvers run CG and BiCGStab inside ``jax.lax.while_loop``: no host
read per iteration.  Here a loop is a *body* that mutates a carry in place
(vectors and 0-d scalars allocated before the loop, at fixed addresses)
under a one-element device flag ``active``, which the body itself updates
at the end of each iteration (``rr > thr & k < maxiter``, and no
breakdown for BiCGStab).  :func:`run_loop` repeats it until the flag
drops.

**The route: an in-kernel guard.**  The card's PyTorch (2.11) exposes no
conditional graph nodes (``CUDAGraph.begin_capture_to_if_node`` appeared
later), so a skipped iteration cannot be a skipped node.  Instead every
kernel that writes the loop's state reads ``active`` first and returns at
once while it is False (:mod:`repro_torch.kernels.krylov_loop`, the
guarded entry points of the SpMV and axpy kernels), and every PyTorch
update of the state writes through a select on the flag.  PyTorch ops
between the kernels only rewrite scratch.  So a block of ``K[solver]``
iterations can be captured once as a CUDA graph and replayed whole: the
iterations past convergence change nothing.

The flag is read once at the start: a start that already stops the loop
(converged, a NaN residual, ``maxiter`` 0) runs no block.  **On a CUDA
device** the body is then run once on a side stream under a flag that is
False (it loads every kernel and library handle outside the capture and
changes nothing) and captured ``K[solver]`` times into one graph, which is
replayed until a host read of ``active`` says stop.  A solver bundle
keeps its loop's buffers and graph (``SolverOps.loops``; the graph is
captured at the block length of the bundle's first sweep), so its later
sweeps (the next refinement pass, the next velocity component) start the
buffers anew in place and replay without capturing; a new bundle (the
step's fresh bands) captures once.  The read is a non-blocking copy into
pinned memory behind an event, and one block is always in flight ahead of
it, so the card never waits on the host: a sweep of ``N > 0`` iterations
replays ``ceil(N / K) + 1`` blocks and reads the device ``ceil(N / K) +
2`` times (the start, each block's flag, the count ``k`` with the launch
counters).  A failed capture or replay raises; nothing falls back to a
host loop.

**On the CPU** the same body runs eagerly, ``K[solver]`` iterations per
block with the guard evaluated in each, blocks and reads exactly as on the
card.  That is what the CPU tests exercise; the plain versions of the
guarded kernels model the guard with a select.

**Launch counters.**  A replay makes no Python call, so a guarded kernel
counts its own launches on the device, only those that pass the guard
(:mod:`repro_torch.kernels.device_counts`; ``cg_advance`` per lane, the
most any lane counted).  :func:`run_loop` zeroes those counters before a
sweep's first block, reads them with ``k`` at its end and adds them to the
wrappers' ``launches``: the launches that did work, as the card counted
them.

**Lanes.**  A cohort's loop (``B`` systems of one shape,
:mod:`repro_torch.solvers.ops`) carries one flag per lane: each guarded
launch covers every lane and a lane whose flag has dropped is frozen, so
the loop runs until no flag is set and the host read per block reads the
``B`` flags.  The sweep's iterations are the most any lane ran.

Every sweep appends a :class:`LoopRecord` to the records that
:func:`loop_records` returns and :func:`reset_loop_records` clears.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Callable

import torch

from repro_torch.kernels import WRAPPERS, launch_counts
from repro_torch.kernels.device_counts import (device_counts,
                                               launched as launched_counts)

__all__ = ["K", "ROUTE", "LoopRecord", "run_loop", "loop_records",
           "reset_loop_records"]

# iterations per captured block, per solver (PERF.md §6 records the card's
# ms per iteration, capture ms and host reads at several lengths).  CG's
# iterations past convergence cost only the guarded launches; BiCGStab's
# PyTorch vector updates do their full work there, so its blocks are
# shorter.
K = {"cg": 8, "bicgstab": 2}
ROUTE = "in-kernel guard"


@dataclasses.dataclass(frozen=True)
class LoopRecord:
    """One sweep: its iterations (the most any lane ran), the blocks
    replayed, the host reads (flag reads plus the final read of ``k``), the
    seconds the capture took (0 on the CPU), the block length, the device
    type, the solver (``"cg"`` or ``"bicgstab"``), on a CUDA device the
    launches of each guarded kernel as its device counter read them, and
    the lanes (1 for one system)."""

    iters: int
    blocks: int
    host_reads: int
    capture_s: float
    K: int
    device: str
    solver: str
    launches: dict = dataclasses.field(default_factory=dict)
    lanes: int = 1


_records: list[LoopRecord] = []
# per device: the capture stream, the graph memory pool every sweep's graph
# shares, and the last graph captured.  A pool lives while a graph that
# uses it does (PyTorch frees it with its last graph and then refuses its
# id), so the last graph is kept until the next capture has begun.
_side_streams: dict = {}
_pools: dict = {}
_last_graph: dict = {}


def loop_records() -> list[LoopRecord]:
    return list(_records)


def reset_loop_records() -> None:
    _records.clear()


def _device_key(device: torch.device) -> int:
    return (device.index if device.index is not None
            else torch.cuda.current_device())


def _side_stream(device: torch.device):
    """One capture stream and one graph memory pool per device, shared by
    every loop's graph: a body's temporaries live only inside one iteration
    (what lasts is in buffers allocated outside the capture) and replays
    never overlap, so a capture may reuse what an earlier one freed."""
    key = _device_key(device)
    if key not in _side_streams:
        _side_streams[key] = torch.cuda.Stream(device=device)
        _pools[key] = torch.cuda.graph_pool_handle()
    return _side_streams[key], _pools[key]


def _capture(body: Callable, active: torch.Tensor, n: int):
    """``body(active)`` ``n`` times as one CUDA graph, after one run under
    a False flag on the capture stream; returns ``(graph, capture
    seconds)``.  Raises if a wrapper counted a launch at the call: an
    unguarded launch inside the block would go uncounted at each replay."""
    device = active.device
    side, pool = _side_stream(device)
    before = launch_counts()
    side.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    # no garbage collection while capturing: freeing an unreachable solver
    # bundle would destroy its graph (or free pool memory) mid-capture,
    # which invalidates the capture
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(side):
            body(torch.zeros_like(active))
            graph.capture_begin(pool=pool)
            try:
                for _ in range(n):
                    body(active)
            except BaseException:
                # end the broken capture; the body's error is the one to see
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
    finally:
        if gc_was_enabled:
            gc.enable()
    _last_graph[_device_key(device)] = graph  # the one before it may go
    torch.cuda.current_stream(device).wait_stream(side)
    capture_s = time.perf_counter() - t0
    if launch_counts() != before:
        raise RuntimeError(f"unguarded kernel launches in a captured block: "
                           f"{before} -> {launch_counts()}")
    return graph, capture_s


def run_loop(body: Callable, st, solver: str) -> int:
    """Run ``body(st.active)`` while the flag holds, in blocks of
    ``K[solver]`` (see the module doc); returns the iteration count, read
    once from the device counter ``st.k`` that the body advances.

    ``st`` holds the loop's buffers: the flags ``active`` and counts ``k``
    (one per lane) and ``graph``, the captured block (None until the first
    sweep on a CUDA device captures it; later sweeps over the same buffers
    replay it).  The flags are read once first: a start that already stops
    every lane (converged, NaN, ``maxiter`` 0) runs nothing.  Returns the
    most iterations any lane ran.
    """
    n_block = K[solver]
    active, k = st.active, st.k
    lanes = active.numel()
    device = active.device.type
    if not bool(active.any()):
        _records.append(LoopRecord(0, 0, 1, 0.0, n_block, device, solver,
                                   lanes=lanes))
        return 0
    on_card = device == "cuda"
    capture_s = 0.0
    if on_card:
        counts = device_counts(active.device)
        counts.zero_()
        if st.graph is None:
            st.graph, capture_s = _capture(body, active, n_block)
        graph = st.graph
        flags = [torch.empty(active.shape, dtype=torch.bool, pin_memory=True)
                 for _ in range(2)]
        done = [torch.cuda.Event(), torch.cuda.Event()]
    else:
        flags = [None, None]

    def launch(i):
        """One block, then its flag copied for a later read."""
        if on_card:
            graph.replay()
            flags[i].copy_(active, non_blocking=True)
            done[i].record()
        else:
            for _ in range(n_block):
                body(active)
            flags[i] = active.clone()

    launch(0)
    blocks, reads, i = 1, 1, 0
    while True:
        launch(1 - i)  # one block in flight ahead of the read
        blocks += 1
        if on_card:
            done[i].synchronize()
        reads += 1
        if not bool(flags[i].any()):
            break
        i = 1 - i
    # the last read waits for the block in flight: the graph is then idle
    if on_card:
        read = torch.cat((k.view(-1).to(counts.dtype), counts)).tolist()
        iters = max(read[:lanes])
        launched = launched_counts(read[lanes:], lanes)
        for name, n in launched.items():
            WRAPPERS[name].launches += n
    else:
        iters, launched = int(k.max()), {}
    _records.append(LoopRecord(iters, blocks, reads + 1, capture_s, n_block,
                               device, solver, launched, lanes))
    return iters
