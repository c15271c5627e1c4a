"""Distributed LDU matrix format (OpenFOAM host-side layout) — paper §3.

OpenFOAM stores a matrix as three arrays over the *local* part:

* ``diag``  — one coefficient per cell,
* ``upper`` — per internal face ``f``: coefficient ``a(owner[f], neigh[f])``,
* ``lower`` — per internal face ``f``: coefficient ``a(neigh[f], owner[f])``,

plus one *interface* coefficient array per processor boundary (the coupling to
cells owned by another rank).

The **coefficient buffer** of a part is the concatenation
``[diag | upper | lower | iface_0 | iface_1 | ...]`` — this is exactly the
"continuous buffer array" each CPU rank ships to its owning GPU rank in the
paper's update procedure.  All planning code here is host-side numpy; runtime
buffers are stacked tensors with a leading part axis.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.fvm.mesh import CavityMesh

__all__ = ["LDULayout", "buffer_from_parts"]


@dataclasses.dataclass(frozen=True)
class LDULayout:
    """Symbolic per-part LDU addressing (identical across parts by uniformity).

    ``iface_rows[s]``/``iface_remote_rows[s]``/``iface_offsets[s]`` describe
    interface slot ``s`` (for the slab decomposition: s=0 "down", s=1 "up").
    """

    n_cells: int
    owner: np.ndarray          # (F,) int32 local rows
    neigh: np.ndarray          # (F,)
    iface_rows: np.ndarray     # (S, B) int32 local rows
    iface_remote_rows: np.ndarray  # (S, B) int32 local rows on remote part
    iface_part_offset: np.ndarray  # (S,) int8, e.g. [-1, +1]

    @staticmethod
    def from_mesh(mesh: CavityMesh) -> "LDULayout":
        ifs = mesh.ifaces
        return LDULayout(
            n_cells=mesh.n_cells,
            owner=mesh.owner,
            neigh=mesh.neigh,
            iface_rows=np.stack([s.rows for s in ifs]),
            iface_remote_rows=np.stack([s.remote_rows for s in ifs]),
            iface_part_offset=np.array([s.part_offset for s in ifs], dtype=np.int8),
        )

    @property
    def n_faces(self) -> int:
        return len(self.owner)

    @property
    def n_ifaces(self) -> int:
        return self.iface_rows.shape[0]

    @property
    def iface_size(self) -> int:
        return self.iface_rows.shape[1]

    @property
    def buffer_len(self) -> int:
        """Length of one part's LDU coefficient buffer."""
        return self.n_cells + 2 * self.n_faces + self.n_ifaces * self.iface_size


def buffer_from_parts(diag, upper, lower, ifaces):
    """Concatenate per-part coefficient arrays into stacked LDU buffers.

    Args are stacked over parts: diag (P, m), upper/lower (P, F),
    ifaces (P, S, B).  Returns (P, L) with L = m + 2F + S*B.
    Works for numpy arrays and torch tensors.
    """
    P = diag.shape[0]
    return _concat([diag, upper, lower, ifaces.reshape(P, -1)], axis=1)


def _concat(xs, axis):
    if isinstance(xs[0], np.ndarray):
        return np.concatenate(xs, axis=axis)
    return torch.cat(xs, dim=axis)
