"""Blockwise partitions and the alpha-fusion connection (paper §3).

The paper uses a *blockwise* distribution: GPU (coarse/solve) rank ``k`` owns the
same DOFs as the alpha CPU (fine/assembly) ranks ``{alpha*k, ..., alpha*k+alpha-1}``.
Everything here is host-side planning code (numpy) executed once (the port's
own copy of the JAX package's module); the KV repartition plan
(:mod:`repro_torch.serving.repartition_kv`) is built on it.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "BlockPartition",
    "AlphaConnection",
    "alpha_fusion",
]


@dataclasses.dataclass(frozen=True)
class BlockPartition:
    """A 1-D blockwise partition of ``n_global`` DOFs into ``n_parts`` parts.

    ``offsets`` has length ``n_parts + 1``; part ``r`` owns global rows
    ``[offsets[r], offsets[r+1])``.
    """

    offsets: np.ndarray

    @staticmethod
    def uniform(n_global: int, n_parts: int) -> "BlockPartition":
        if n_global % n_parts != 0:
            raise ValueError(
                f"uniform partition requires n_parts | n_global, got {n_global} % {n_parts}"
            )
        size = n_global // n_parts
        return BlockPartition(np.arange(n_parts + 1, dtype=np.int64) * size)

    @property
    def n_parts(self) -> int:
        return len(self.offsets) - 1

    @property
    def n_global(self) -> int:
        return int(self.offsets[-1])

    def size(self, part: int) -> int:
        return int(self.offsets[part + 1] - self.offsets[part])

    def owner_of(self, global_ids: np.ndarray) -> np.ndarray:
        """Owning part for each global row id (vectorized)."""
        return np.searchsorted(self.offsets, np.asarray(global_ids), side="right") - 1

    def to_local(self, global_ids: np.ndarray, part: int) -> np.ndarray:
        return np.asarray(global_ids) - self.offsets[part]

    def to_global(self, local_ids: np.ndarray, part: int) -> np.ndarray:
        return np.asarray(local_ids) + self.offsets[part]

    def global_ids(self, part: int) -> np.ndarray:
        return np.arange(self.offsets[part], self.offsets[part + 1], dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class AlphaConnection:
    """Connection between a fine (assembly) and a coarse (solve) partition.

    Coarse part ``k`` owns fine parts ``fine_parts_of(k) = [alpha*k, alpha*(k+1))``.
    Because the distribution is blockwise the coarse partition owns *contiguous*
    global DOF ranges — the fused local ordering is simply the concatenation of
    the fine local orderings (paper §3 step 3).
    """

    fine: BlockPartition
    coarse: BlockPartition
    alpha: int

    def coarse_of(self, fine_part: int | np.ndarray) -> int | np.ndarray:
        return np.asarray(fine_part) // self.alpha

    def fine_parts_of(self, coarse_part: int) -> np.ndarray:
        return np.arange(coarse_part * self.alpha, (coarse_part + 1) * self.alpha)

    def fused_row_offset(self, fine_part: int) -> int:
        """Offset of fine part's rows inside its coarse part's local ordering."""
        k = fine_part // self.alpha
        return int(self.fine.offsets[fine_part] - self.coarse.offsets[k])

    @property
    def n_fine(self) -> int:
        return self.fine.n_parts

    @property
    def n_coarse(self) -> int:
        return self.coarse.n_parts


def alpha_fusion(fine: BlockPartition, alpha: int) -> AlphaConnection:
    """Build the blockwise alpha-fusion connection (paper §3).

    ``n_coarse = n_fine / alpha``; coarse part k's row range is the union of its
    fine parts' ranges (contiguous because the distribution is blockwise).
    """
    if alpha < 1:
        raise ValueError(f"alpha must be >= 1, got {alpha}")
    if fine.n_parts % alpha != 0:
        raise ValueError(
            f"alpha must divide n_fine: {fine.n_parts} % {alpha} != 0"
        )
    coarse_offsets = fine.offsets[::alpha].copy()
    coarse = BlockPartition(coarse_offsets)
    return AlphaConnection(fine=fine, coarse=coarse, alpha=alpha)
