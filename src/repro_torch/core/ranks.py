"""Ranks: one thread a device for a step over a mesh of distinct devices.

The paper runs one MPI rank a core: the CPU ranks assemble their fine
parts, the GPU ranks solve, and the repartitioning update carries the
coefficients between them.  The port runs such a step in one process as
the JAX package does under GSPMD, but without a compiler to place the
work: each distinct device of the ``(solve, assemble)`` mesh is a *rank*,
a thread that runs the step's phases on the device's own parts, and the
ranks meet at collectives where values cross devices.  :class:`Ranks` is
that communicator:

* :meth:`Ranks.exchange` — every rank hands in one Python value; between
  two barriers each rank reads the others' values through ``take`` (the
  copies a collective makes happen there, so no source is overwritten
  before every reader has copied it);
* :meth:`Ranks.carry` — a tensor copied from one device of the mesh to
  another, its bytes and seconds added to the ledger by kind (the move
  kinds of :class:`~repro_torch.core.update.MoveRecord`, or ``"scalars"``
  for the collectives' scalars); a copy between two places on one device
  is no copy;
* :meth:`Ranks.sum`, :meth:`Ranks.max`, :meth:`Ranks.all` — reductions of
  0-d values, each contribution taken to the host and combined there in
  rank order, so every rank holds the same bits (the loops' control
  follows them: every rank takes the same branch);
* :meth:`Ranks.run` — start the ranks, wait for them, re-raise the first
  failure (a failing rank breaks the barrier, so no rank waits forever;
  a barrier also gives up after :data:`TIMEOUT_S`).

A device named by the mesh is a place of its own: ``cpu`` and ``cpu:0``
are two ranks, and a copy between them is a real copy, counted between
devices, as the move rules count it.

:class:`MeshRanks` keeps a mesh's ranks and who holds what: the rows of
each part (a fine part of the stacked step, a row shard of the full
mesh) on the rank of its position's device, each coarse part's owner,
and the collectives that move rows between them (a block's neighbour
planes, rows to the owners and back).
"""
from __future__ import annotations

import threading
import time

import torch

from repro_torch.core.layout import canonical_device
from repro_torch.core.update import owner_positions, part_positions
from repro_torch.sparse.distributed import halo_exchange

__all__ = ["HOST", "TIMEOUT_S", "MeshRanks", "Ranks", "same_place"]

# the host's place: the staging copies of the host_buffer update
HOST = torch.device("cpu")
# a rank waits this long at a barrier before the step fails
TIMEOUT_S = 600.0


def same_place(a, b) -> bool:
    """Two devices of a mesh are one place (``cpu`` and ``cpu:0`` are
    not)."""
    return canonical_device(a) == canonical_device(b)


class Ranks:
    """The communicator of the ranks ``devices`` (one a distinct device, in
    rank order).  ``ledger`` (a :class:`~repro_torch.core.update.
    MoveRecord`, optional) receives each carry's bytes and seconds;
    ``waited[r]`` adds up the seconds rank ``r`` spent at barriers;
    ``sync`` (set by a timed step) makes a CUDA rank finish its queued work
    before it hands a value in, so a copy's seconds are the copy's."""

    def __init__(self, devices, ledger=None):
        self.devices = [canonical_device(d) for d in devices]
        if len(set(self.devices)) != len(self.devices):
            raise ValueError(f"ranks need distinct devices: {self.devices}")
        self.n = len(self.devices)
        self.ledger = ledger
        self.sync = False
        self.waited = [0.0] * self.n
        self._slots = [None] * self.n
        self._lock = threading.Lock()
        self._barrier = threading.Barrier(self.n, timeout=TIMEOUT_S)

    # -- the collectives ---------------------------------------------------
    def _wait(self, rank: int) -> None:
        t0 = time.perf_counter()
        self._barrier.wait()
        self.waited[rank] += time.perf_counter() - t0

    def exchange(self, rank: int, value, take=None):
        """Hand in ``value``; returns ``take(values)`` (default: the list of
        every rank's value, in rank order), run between two barriers."""
        if self.sync and self.devices[rank].type == "cuda":
            torch.cuda.synchronize(self.devices[rank])
        self._slots[rank] = value
        self._wait(rank)
        try:
            out = list(self._slots) if take is None else take(self._slots)
        finally:
            self._wait(rank)
            self._slots[rank] = None
        return out

    def carry(self, t: torch.Tensor, src, dst, kind: str, *,
              copy: bool = False) -> torch.Tensor:
        """``t`` (held at ``src``) at ``dst``: the tensor itself where the
        two are one place (a copy with ``copy``), else a copy there, its
        bytes and seconds added to the ledger under ``kind``."""
        if same_place(src, dst):
            return t.clone() if copy else t
        t0 = time.perf_counter()
        # a blocking copy: it waits for the work queued before it
        out = t.to(canonical_device(dst), copy=True)
        secs = time.perf_counter() - t0
        if self.ledger is not None:
            with self._lock:
                self.ledger.carry(kind, t.numel() * t.element_size(), secs)
        return out

    def _reduce(self, rank: int, vals, combine):
        """Each rank's 0-d ``vals`` combined over the ranks on the host, in
        rank order; the results on the rank's device."""
        dev = self.devices[rank]
        mine = self.carry(torch.stack(list(vals)), dev, HOST, "scalars")

        def take(slots):
            out = slots[0]
            for s in slots[1:]:
                out = combine(out, s)
            return self.carry(out, HOST, dev, "scalars")

        return tuple(self.exchange(rank, mine, take).unbind())

    def sum(self, rank: int, vals) -> tuple:
        """The sums over the ranks of each of ``vals``."""
        return self._reduce(rank, vals, torch.add)

    def max(self, rank: int, val: torch.Tensor) -> torch.Tensor:
        """The maximum over the ranks (NaN wins, as ``torch.max``)."""
        (out,) = self._reduce(
            rank, (val,), lambda a, b: torch.stack([a, b]).amax(0))
        return out

    def all(self, rank: int, flag: torch.Tensor) -> torch.Tensor:
        """True where every rank's ``flag`` is."""
        (out,) = self._reduce(rank, (flag,), torch.logical_and)
        return out

    def broadcast(self, rank: int, root: int, vals) -> tuple:
        """``root``'s 0-d ``vals`` on every rank's device (``vals`` is read
        on ``root`` only)."""
        dev = self.devices[rank]
        mine = None
        if rank == root:
            mine = tuple(self.carry(v, dev, HOST, "scalars") for v in vals)
        return self.exchange(rank, mine, lambda slots: tuple(
            self.carry(v, HOST, dev, "scalars") for v in slots[root]))

    # -- running the ranks -------------------------------------------------
    def run(self, fn) -> list:
        """``[fn(0), ..., fn(n - 1)]``, each on a thread of its own."""
        self._barrier = threading.Barrier(self.n, timeout=TIMEOUT_S)
        self.waited = [0.0] * self.n
        results = [None] * self.n
        errors = [None] * self.n

        def work(rank):
            try:
                if self.devices[rank].type == "cuda":
                    torch.cuda.set_device(self.devices[rank])
                results[rank] = fn(rank)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors[rank] = e
                self._barrier.abort()

        threads = [threading.Thread(target=work, args=(r,), name=f"rank{r}",
                                    daemon=True) for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = [e for e in errors if e is not None]
        if failed:
            real = [e for e in failed
                    if not isinstance(e, threading.BrokenBarrierError)]
            raise (real or failed)[0]
        return results


def _pieces(rows, rank_of, index) -> list[tuple[int, int, int]]:
    """``rows`` (global indices, in order) as ``(rank, i0, i1)`` runs of
    consecutive rows of one rank's block."""
    out = []
    for f in rows:
        s, i = rank_of[f], index[f]
        if out and out[-1][0] == s and out[-1][2] == i:
            out[-1] = (s, out[-1][1], i + 1)
        else:
            out.append((s, i, i + 1))
    return out


class MeshRanks:
    """A mesh's ranks and who holds what: ``devices`` (rank order, rank 0
    the first position's), ``parts[r]`` the fine parts rank ``r`` holds
    (sorted), ``positions[r]`` its positions, and per coarse partition
    (:meth:`coarse`) each coarse part's owner rank."""

    def __init__(self, mesh, n_parts: int, ledger=None):
        self.mesh = mesh
        self.n_parts = n_parts
        devs = [canonical_device(d) for d in mesh.flat()]
        self.devices = list(dict.fromkeys(devs))
        n = len(self.devices)
        self.rank_of_pos = [self.devices.index(d) for d in devs]
        self.positions = [[k for k, r in enumerate(self.rank_of_pos)
                           if r == rank] for rank in range(n)]
        self.part_pos = part_positions(mesh, n_parts)
        self.rank_of_part = [self.rank_of_pos[k] for k in self.part_pos]
        self.parts = [[f for f in range(n_parts)
                       if self.rank_of_part[f] == r] for r in range(n)]
        self.index = {f: i for ps in self.parts for i, f in enumerate(ps)}
        self.ranks = Ranks(self.devices, ledger=ledger)
        self._coarse: dict[int, dict] = {}

    def coarse(self, n_coarse: int) -> dict:
        """The coarse partition's layout: ``owner_pos`` and ``rank_of`` per
        coarse part, ``parts[r]`` the coarse parts rank ``r`` owns,
        ``index`` a coarse part's row in its owner's block, ``local`` the
        one rank owning them all (None when owners span devices)."""
        got = self._coarse.get(n_coarse)
        if got is None:
            own = owner_positions(self.mesh, n_coarse)
            rank_of = [self.rank_of_pos[k] for k in own]
            parts = [[c for c in range(n_coarse) if rank_of[c] == r]
                     for r in range(self.ranks.n)]
            owners = {r for r in rank_of}
            got = self._coarse[n_coarse] = dict(
                owner_pos=own, rank_of=rank_of, parts=parts,
                index={c: i for ps in parts for i, c in enumerate(ps)},
                local=owners.pop() if len(owners) == 1 else None)
        return got

    # -- neighbour planes ----------------------------------------------------
    def planes(self, rank: int, ids, rank_of, index, plane: int,
               kind: str):
        """``halo(x) -> (down, up)`` of rank ``rank``'s block of the parts
        ``ids`` (sorted, of ``len(rank_of)``; ``rank_of``/``index`` where
        each part is held): in-block neighbours as
        :func:`~repro_torch.sparse.distributed.halo_exchange` takes them,
        each run's outer neighbour copied in from the rank holding it (a
        collective, its copies under ``kind``)."""
        n_tot, ranks = len(rank_of), self.ranks
        down_fix = [(i, f - 1) for i, f in enumerate(ids)
                    if f > 0 and (i == 0 or ids[i - 1] != f - 1)]
        up_fix = [(i, f + 1) for i, f in enumerate(ids) if f < n_tot - 1
                  and (i == len(ids) - 1 or ids[i + 1] != f + 1)]
        dev, devs = ranks.devices[rank], ranks.devices

        def halo(x):
            down, up = halo_exchange(x, plane) if ids else (None, None)
            m = x.shape[1]

            def take(slots):
                for i, g in down_fix:
                    s = rank_of[g]
                    down[i] = ranks.carry(slots[s][index[g], m - plane:],
                                          devs[s], dev, kind)
                for i, g in up_fix:
                    s = rank_of[g]
                    up[i] = ranks.carry(slots[s][index[g], :plane], devs[s],
                                        dev, kind)

            ranks.exchange(rank, x, take)
            return down, up

        return halo

    def asm_halo(self, rank: int, plane: int):
        """The assembly's :meth:`planes` of rank ``rank``'s fine parts."""
        return self.planes(rank, self.parts[rank], self.rank_of_part,
                           self.index, plane, "halo")

    # -- rows to the owners and back ---------------------------------------
    def gather(self, rank: int, block: torch.Tensor, at, rows, kind: str):
        """Rank ``rank``'s rows ``rows`` (global fine parts, in order) from
        the blocks the ranks hand in (``block``, held at ``at``: the rank's
        device, or the host for a staged copy), as one tensor on the rank's
        device (None without rows)."""
        dev = self.devices[rank]
        plan = _pieces(rows, self.rank_of_part, self.index)

        def take(slots):
            if not plan:
                return None
            got = [self.ranks.carry(slots[s][0][i0:i1], slots[s][1], dev,
                                    kind) for s, i0, i1 in plan]
            return got[0] if len(got) == 1 else torch.cat(got)

        return self.ranks.exchange(rank, (block, at), take)

    def scatter(self, rank: int, coarse_rows, co: dict, alpha: int,
                kind: str) -> torch.Tensor:
        """Each owner's fine rows ``coarse_rows`` (``(n_owned * alpha,
        ...)``, None on a rank owning nothing) back to the rank of each
        fine part: rank ``rank``'s block ``(len(parts), ...)``."""
        dev = self.devices[rank]
        rank_of = [co["rank_of"][f // alpha] for f in range(self.n_parts)]
        index = {f: co["index"][f // alpha] * alpha + f % alpha
                 for f in range(self.n_parts)}
        plan = _pieces(self.parts[rank], rank_of, index)

        def take(slots):
            got = [self.ranks.carry(slots[s][i0:i1], self.devices[s], dev,
                                    kind) for s, i0, i1 in plan]
            return got[0] if len(got) == 1 else torch.cat(got)

        return self.ranks.exchange(rank, coarse_rows, take)
