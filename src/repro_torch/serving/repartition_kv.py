"""The paper's alpha-fusion repartitioning applied to disaggregated serving.

The port of the JAX package's ``serving/repartition_kv.py``.  The
over/under-subscription mismatch the paper solves for CFD (fine assembly
partition vs coarse solve partition) recurs in LLM serving: prefill wants
many parts (compute-bound, like matrix assembly), decode few, memory-bound
ones (like the linear solve).  The plan is a *blockwise alpha-fusion
connection* over the batch dimension: decode group ``k`` owns the
sequences of the alpha prefill groups
``{alpha*k, ..., alpha*k + alpha - 1}`` (paper §3's DOF ownership rule),
built once from the batch size (:mod:`repro_torch.core.partition`).

On a :class:`~repro_torch.launch.mesh.DeviceMesh` the handoff reshards
the stacked cache from the fine batch partition (prefill layout: B over
``("data", "model")``, :meth:`KVRepartitionPlan.fine_spec`) to the coarse
decode layout (B over ``data``, the cache length over ``model``,
:meth:`KVRepartitionPlan.coarse_spec`): :func:`repartition_cache` runs
:func:`~repro_torch.models.sharding.reshard`'s explicit move plan where
XLA emits its grouped all-gather/all-to-all, and counts the bytes moved.
``schedule="host_buffer"`` takes JAX's two hops through the
batch-over-``data`` layout (a layout, not host memory, as in JAX).  With
every position on one card the moves are device-local copies.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.partition import BlockPartition, alpha_fusion
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models.sharding import (MoveStats, NamedSharding,
                                         PartitionSpec as P, Sharded, reshard)

__all__ = ["KVRepartitionPlan", "repartition_cache", "SCHEDULES"]

SCHEDULES = ("device_direct", "host_buffer")


@dataclasses.dataclass(frozen=True)
class KVRepartitionPlan:
    """Blockwise batch-fusion plan between prefill and decode partitions."""

    alpha: int
    n_fine: int      # prefill groups
    n_coarse: int    # decode groups
    batch: int

    @staticmethod
    def build(batch: int, n_fine: int, alpha: int) -> "KVRepartitionPlan":
        fine = BlockPartition.uniform(batch, n_fine)
        conn = alpha_fusion(fine, alpha)
        return KVRepartitionPlan(alpha=alpha, n_fine=n_fine,
                                 n_coarse=conn.n_coarse, batch=batch)

    def owned_rows(self, k: int) -> np.ndarray:
        """The batch rows decode group ``k`` owns: those of prefill groups
        ``alpha*k .. alpha*k + alpha - 1``, one contiguous block."""
        fine = BlockPartition.uniform(self.batch, self.n_fine)
        return alpha_fusion(fine, self.alpha).coarse.global_ids(k)

    def fine_spec(self) -> P:
        """Prefill-side cache layout: batch sharded over both mesh axes."""
        return P(None, ("data", "model"), None, None, None)

    def coarse_spec(self) -> P:
        """Decode-side layout: batch over data, cache length over model."""
        return P(None, "data", "model", None, None)


def repartition_cache(plan: KVRepartitionPlan, mesh: DeviceMesh, cache,
                      schedule: str = "device_direct",
                      stats: dict | None = None):
    """Reshard a stacked cache tree of :class:`Sharded` leaves from the
    prefill to the decode layout: 5-D K/V leaves to
    ``plan.coarse_spec()``, every other leaf batch-sharded over ``data``.

    ``schedule='host_buffer'`` goes through the fully batch-gathered
    layout ``P(None, "data", None, None, None)`` (two hops, the paper's
    fig. 9 'HB' path) instead of the single reshard.  ``stats``, when
    given, gets ``"moved"``: the :class:`MoveStats` of every hop.
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; one of "
                         f"{SCHEDULES}")
    moved = MoveStats()

    def hop(leaf, spec):
        nonlocal moved
        out, m = reshard(leaf, NamedSharding(mesh, spec))
        moved += m
        return out

    def move(leaf):
        if isinstance(leaf, dict):
            return {k: move(v) for k, v in leaf.items()}
        if not isinstance(leaf, Sharded) or leaf.mesh != mesh:
            raise ValueError("repartition_cache moves Sharded leaves on "
                             f"{mesh!r}")
        if leaf.ndim != 5:  # mamba/rwkv states etc.: just batch-shard
            return hop(leaf, P(None, "data", *([None] * (leaf.ndim - 2))))
        if schedule == "host_buffer":
            staged = hop(leaf, P(None, "data", None, None, None))
            return hop(staged, plan.coarse_spec())
        return hop(leaf, plan.coarse_spec())

    out = move(cache)
    if stats is not None:
        stats["moved"] = moved
    return out
