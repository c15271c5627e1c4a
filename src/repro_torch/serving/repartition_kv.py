"""The paper's alpha-fusion repartitioning applied to disaggregated serving.

The port of the plan half of the JAX package's
``serving/repartition_kv.py``.  The over/under-subscription mismatch the
paper solves for CFD (fine assembly partition vs coarse solve partition)
recurs in LLM serving: prefill wants many parts (compute-bound, like
matrix assembly), decode few, memory-bound ones (like the linear solve).
The plan is a *blockwise alpha-fusion connection* over the batch
dimension: decode group ``k`` owns the sequences of the alpha prefill
groups ``{alpha*k, ..., alpha*k + alpha - 1}`` (paper §3's DOF ownership
rule), built once from the batch size (:mod:`repro_torch.core.partition`).

Moving a cache between the two layouts is a layout over a mesh of cards
(the JAX module's ``repartition_cache`` and its specs) and is not part of
the one-card port.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.partition import BlockPartition, alpha_fusion

__all__ = ["KVRepartitionPlan"]


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
