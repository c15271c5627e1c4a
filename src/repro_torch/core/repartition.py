"""The repartitioning procedure (paper §3) — plan construction.

Fuses the LDU matrices of ``alpha`` fine (CPU/assembly) parts into one coarse
(GPU/solve) part, *symbolically, once*:

1. extract the sparsity pattern from the host LDU matrices, including all
   coupling (interface) terms,
2. "send" local + non-local patterns to the owning coarse part (here: a
   host-side concatenation — the blockwise distribution makes the target
   contiguous),
3. fuse received local patterns into a single local pattern; interface
   entries whose communication partner landed on the same coarse part are
   **localized** (become ordinary local couplings); the rest stay in the
   non-local (halo) matrix.

The plan yields the paper's three data structures:

* the fused **sparsity pattern** — a 7-band **DIA** target (a structured
  FVM matrix is banded, so SpMV becomes shifted vector products), which is
  what the solver path reads, and a padded **ELL** target built lazily on
  first access (nothing on the main path reads it);
* the **update pattern U** — realized as gather indices ``*_src`` from the
  concatenated per-part coefficient buffers;
* the **permutation P** — folded into the same ``*_src`` index arrays
  (buffer order → solver order).

Everything here is numpy and runs once on the host; runtime application
lives in :mod:`repro_torch.core.update`.  The gather indices go to a device
once per plan and device, as int32 (:meth:`RepartitionPlan.src_on`,
:meth:`RepartitionPlan.ell_cols_on`).  At the paper's smallest mesh
(210^3 cells, alpha = 30) the plan covers about 65M buffer entries, so the
duplicate check uses a counting pass rather than a sort.

:func:`layout_fingerprint` and :func:`mesh_fingerprint` are the plan
cache's keys (:class:`repro_torch.core.controller.PlanCache`): the same
strings as the JAX package's, character for character.
"""
from __future__ import annotations

import dataclasses
import hashlib
from functools import cached_property

import numpy as np
import torch

from repro_torch.core.ldu import LDULayout
from repro_torch.fvm.mesh import CavityMesh

__all__ = ["RepartitionPlan", "build_plan", "plan_for_mesh",
           "layout_fingerprint", "mesh_fingerprint", "fuse_parts_coo"]

ELL_K = 8  # max row degree of a fused 7-point-stencil matrix (see _ell)


@dataclasses.dataclass(frozen=True)
class RepartitionPlan:
    """Precomputed repartitioning of an LDU-distributed matrix (see module doc).

    Shapes: ``m_c = alpha * m_f`` fused rows; ``L`` = per-fine-part buffer
    length; concat buffer length ``alpha * L`` (+1 sentinel zero slot).

    ``ell_src[i] == alpha*L`` (the sentinel) marks an empty ELL slot.
    ``x_ext`` layout: ``[local (m_c) | down halo (plane) | up halo (plane)]``.
    ``x_pad`` layout: ``[down halo | local | up halo]`` (for DIA shifts).
    """

    alpha: int
    m_fine: int
    m_coarse: int
    plane: int
    buffer_len: int
    # DIA target
    dia_offsets: np.ndarray  # (n_bands,) int32 element offsets
    dia_src: np.ndarray      # (n_bands, m_c) int64 → concat-buffer index
    # bookkeeping (paper: local vs non-local split after localization)
    nnz_local: int
    nnz_localized: int       # formerly non-local entries that became local
    nnz_halo: int            # entries that remain in the non-local matrix
    # the symbolic source of the lazily built ELL target (None for a plan
    # rebuilt from arrays, which then carries the ELL target only if `ell`
    # is given)
    layout: LDULayout | None = dataclasses.field(default=None, repr=False,
                                                 compare=False)
    K: int = ELL_K
    # the ELL target's (ell_cols, ell_src) arrays, when given ready-made
    ell: tuple[np.ndarray, np.ndarray] | None = dataclasses.field(
        default=None, repr=False, compare=False)
    # device copies of the indices: {(name, device): tensor}
    _on_device: dict = dataclasses.field(default_factory=dict, init=False,
                                         repr=False, compare=False)

    @property
    def sentinel(self) -> int:
        return self.alpha * self.buffer_len

    @property
    def ell_cols(self) -> np.ndarray:
        """(m_c, K) int32 → x_ext index (built on first access)."""
        return self._ell[0]

    @property
    def ell_src(self) -> np.ndarray:
        """(m_c, K) int64 → concat-buffer index (built on first access)."""
        return self._ell[1]

    def src_on(self, device, target: str = "dia") -> torch.Tensor:
        """The flattened ``dia_src`` (n_bands*m_c,) or ``ell_src``
        (m_c*K,) as int32 on ``device``, copied there once."""
        n_buf = self.sentinel + 1
        if n_buf > np.iinfo(np.int32).max:
            raise ValueError(f"buffer of {n_buf} entries exceeds int32 "
                             "indexing")
        return self._device_copy(
            target + "_src", device,
            lambda: self.dia_src if target == "dia" else self.ell_src)

    def ell_cols_on(self, device) -> torch.Tensor:
        """The flattened ``ell_cols`` (m_c*K,) int32 on ``device``."""
        return self._device_copy("ell_cols", device, lambda: self.ell_cols)

    def _device_copy(self, name: str, device, host) -> torch.Tensor:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # one copy whether the caller says "cuda" or "cuda:0"
            device = torch.device("cuda", torch.cuda.current_device())
        key = (name, device)
        t = self._on_device.get(key)
        if t is None:
            t = self._on_device[key] = torch.as_tensor(
                host().reshape(-1).astype(np.int32), device=device)
        return t

    @cached_property
    def _ell(self) -> tuple[np.ndarray, np.ndarray]:
        if self.ell is not None:
            return self.ell
        if self.layout is None:
            raise ValueError("this plan carries no layout to build ELL from")
        rows, cols, _ = _fused_entries(self.layout, self.alpha)
        m_c, plane = self.m_coarse, self.plane
        n_entries = len(rows)
        ell_col_of = np.where(
            cols < 0, m_c + (cols + plane),                      # down halo
            np.where(cols >= m_c, m_c + plane + (cols - m_c),    # up halo
                     cols))
        # entries take slots in buffer order per row
        order = np.argsort(rows, kind="stable")
        sorted_rows = rows[order]
        row_start = np.searchsorted(sorted_rows, np.arange(m_c))
        slot = np.arange(n_entries, dtype=np.int64) - row_start[sorted_rows]
        if int(slot.max()) + 1 > self.K:
            raise ValueError(
                f"row degree {int(slot.max()) + 1} exceeds ELL_K={self.K}")
        ell_src = np.full((m_c, self.K), self.sentinel, dtype=np.int64)
        ell_cols = np.zeros((m_c, self.K), dtype=np.int32)
        ell_src[sorted_rows, slot] = order
        ell_cols[sorted_rows, slot] = ell_col_of[order].astype(np.int32)
        return ell_cols, ell_src


def _fused_entries(layout: LDULayout, alpha: int):
    """Steps 1+2: per-entry (fused row, signed fused col) in buffer order.

    Fused columns lie in ``[-plane, m_c + plane)``; returns ``(rows, cols,
    (nnz_local, nnz_localized, nnz_halo))``.
    """
    m = layout.n_cells
    B = layout.iface_size
    rows, cols = [], []
    local_ct = localized_ct = halo_ct = 0
    for l in range(alpha):
        base = l * m
        # diag
        rows.append(np.arange(m, dtype=np.int64) + base)
        cols.append(np.arange(m, dtype=np.int64) + base)
        # upper a(o,n), lower a(n,o)
        rows.append(layout.owner.astype(np.int64) + base)
        cols.append(layout.neigh.astype(np.int64) + base)
        rows.append(layout.neigh.astype(np.int64) + base)
        cols.append(layout.owner.astype(np.int64) + base)
        local_ct += m + 2 * layout.n_faces
        # interfaces — step 3: localize if the partner fine part is in-group
        for s in range(layout.n_ifaces):
            l_remote = l + int(layout.iface_part_offset[s])
            rows.append(layout.iface_rows[s].astype(np.int64) + base)
            cols.append(layout.iface_remote_rows[s].astype(np.int64)
                        + l_remote * m)
            if 0 <= l_remote < alpha:
                localized_ct += B
            else:
                halo_ct += B
    return (np.concatenate(rows), np.concatenate(cols),
            (local_ct, localized_ct, halo_ct))


def build_plan(layout: LDULayout, alpha: int, *, nx: int | None = None,
               plane: int | None = None) -> RepartitionPlan:
    """Build the fused-matrix plan for one (interior) coarse group.

    By slab-uniformity the plan is identical for every coarse part; boundary
    coarse parts simply carry zero coefficients in the slots of physically
    absent interfaces (assembly masks them), so no per-part plans are needed.

    ``nx``/``plane`` define the band structure; ``plane`` defaults to the
    interface size (slab decomposition).
    """
    L = layout.buffer_len
    plane = layout.iface_size if plane is None else plane
    m_c = alpha * layout.n_cells
    rows, cols, (local_ct, localized_ct, halo_ct) = _fused_entries(layout,
                                                                   alpha)
    n_entries = len(rows)
    if n_entries != alpha * L:
        raise AssertionError((n_entries, alpha, L))

    if nx is None:
        # generic fallback: derive the band set from the data
        offsets = np.unique(cols - rows)
    else:
        offsets = np.array([-plane, -nx, -1, 0, 1, nx, plane], dtype=np.int64)
    off = cols - rows
    del cols
    band_of = np.searchsorted(offsets, off)
    if not np.all(offsets[np.clip(band_of, 0, len(offsets) - 1)] == off):
        raise ValueError("matrix is not representable on the given bands")
    del off
    # later entries with identical (band, row) would overwrite; refuse any
    flat = band_of * m_c + rows
    if np.bincount(flat, minlength=len(offsets) * m_c).max(initial=0) > 1:
        raise ValueError("duplicate (band,row) entries — DIA target invalid")
    del flat
    dia_src = np.full((len(offsets), m_c), alpha * L, dtype=np.int64)
    dia_src[band_of, rows] = np.arange(n_entries, dtype=np.int64)

    return RepartitionPlan(
        alpha=alpha, m_fine=layout.n_cells, m_coarse=m_c, plane=plane,
        buffer_len=L, dia_offsets=offsets.astype(np.int32), dia_src=dia_src,
        nnz_local=local_ct, nnz_localized=localized_ct, nnz_halo=halo_ct,
        layout=layout)


def plan_for_mesh(mesh: CavityMesh, alpha: int) -> RepartitionPlan:
    layout = LDULayout.from_mesh(mesh)
    return build_plan(layout, alpha, nx=mesh.nx, plane=mesh.plane)


# ---------------------------------------------------------------------------
# Fingerprints — stable keys for the controller's plan cache.
# ---------------------------------------------------------------------------

def layout_fingerprint(layout: LDULayout) -> str:
    """Stable content hash of the symbolic sparsity structure.

    Two layouts with the same fingerprint produce identical plans for any
    alpha, so the plan cache can key on ``(fingerprint, alpha, target)``
    and share plans across solvers and re-created mesh objects.  The
    arrays are hashed in their stored dtypes (int32, and int8 for the part
    offsets), which the JAX package's ``LDULayout`` shares.
    """
    h = hashlib.sha256()
    h.update(f"n_cells={layout.n_cells};".encode())
    for arr in (layout.owner, layout.neigh, layout.iface_rows,
                layout.iface_remote_rows, layout.iface_part_offset):
        h.update(np.ascontiguousarray(arr).tobytes())
        h.update(b";")
    return h.hexdigest()[:16]


def mesh_fingerprint(mesh: CavityMesh) -> str:
    """Structural mesh hash: geometry + decomposition (not field values)."""
    h = hashlib.sha256(
        f"cavity;{mesh.nx};{mesh.ny};{mesh.nz};{mesh.n_parts};{mesh.h}"
        .encode())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# Generic COO fusion — the reference the property tests hold plans to.
# ---------------------------------------------------------------------------

def fuse_parts_coo(part_rows: list[np.ndarray], part_cols: list[np.ndarray],
                   m_fine: int, alpha: int):
    """Reference fusion of alpha parts' (local_row, global_col) COO patterns.

    Returns (rows, cols, is_local) of the fused coarse part in fused-local
    row numbering, with cols kept global.  ``is_local`` marks entries whose
    column is owned by the coarse part (the paper's localization criterion:
    ``j ∈ I_GPU(r) = ∪ I_CPU(alpha r + l)``).
    """
    if len(part_rows) != alpha or len(part_cols) != alpha:
        raise ValueError(f"expected {alpha} parts' patterns, got "
                         f"{len(part_rows)} and {len(part_cols)}")
    rows, cols = [], []
    for l in range(alpha):
        rows.append(np.asarray(part_rows[l], dtype=np.int64) + l * m_fine)
        cols.append(np.asarray(part_cols[l], dtype=np.int64))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    is_local = (cols >= 0) & (cols < alpha * m_fine)
    return rows, cols, is_local
