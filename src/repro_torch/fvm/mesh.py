"""Structured lidDrivenCavity3D mesh with slab ("simple") decomposition.

Mirrors the paper's benchmark setup (§4): a uniform cubic grid, decomposed into
equally-sized subdomains. The paper uses ``(2*3*5*7*n_p)^3`` cells so the domain
is divisible by a wide range of part counts; we keep the same trick for the
full-scale configs and smaller multiples for tests.

Decomposition is a 1-D slab split along ``z`` (OpenFOAM "simple" with
``n=(1,1,P)``), which makes every part structurally identical:

* local cell id = ``i + nx*j + nx*ny*kl`` with ``kl`` the slab-local z index,
* the same internal-face addressing (``owner``/``neigh``) for every part,
* at most two processor interfaces ("down" → part-1, "up" → part+1), each an
  ``nx*ny`` plane, masked out on the first/last part,
* physical boundary patches: x0/x1/y0/y1 walls on every part, bottom wall on
  part 0, moving lid (z = max, velocity (1,0,0)) on the last part.

Uniformity is what lets the distributed state be stored as stacked arrays with
a leading part axis.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CavityMesh", "IfaceSpec", "PatchSpec", "DOWN", "UP"]

DOWN, UP = 0, 1  # interface slots


@dataclasses.dataclass(frozen=True)
class IfaceSpec:
    """One processor interface of a part (identical layout for every part)."""

    name: str
    part_offset: int        # -1 (down) or +1 (up)
    rows: np.ndarray        # (n_bf,) local owner-cell ids on this part
    remote_rows: np.ndarray  # (n_bf,) local cell ids on the remote part


@dataclasses.dataclass(frozen=True)
class PatchSpec:
    """A physical boundary patch (Dirichlet/zero-gradient handled in assembly)."""

    name: str
    rows: np.ndarray        # (n_bf,) local owner-cell ids
    normal: tuple[float, float, float]
    only_part: int | None   # None → present on all parts; 0 / P-1 for z patches


@dataclasses.dataclass(frozen=True)
class CavityMesh:
    """Uniform hex grid ``nx*ny*nz`` over a unit-ish cube, split into P z-slabs."""

    nx: int
    ny: int
    nz: int
    n_parts: int
    h: float  # uniform spacing (dx = dy = dz)

    @staticmethod
    def cube(n: int, n_parts: int = 1, length: float = 0.1) -> "CavityMesh":
        """The paper's cubic cavity: ``n^3`` cells, edge ``length`` (OpenFOAM 0.1m)."""
        return CavityMesh(nx=n, ny=n, nz=n, n_parts=n_parts, h=length / n)

    def __post_init__(self):
        if self.nz % self.n_parts != 0:
            raise ValueError(f"n_parts must divide nz: {self.nz} % {self.n_parts}")

    # ---- sizes -----------------------------------------------------------
    @property
    def nzl(self) -> int:
        """Slab thickness (cells along z per part)."""
        return self.nz // self.n_parts

    @property
    def n_cells(self) -> int:
        """Cells per part."""
        return self.nx * self.ny * self.nzl

    @property
    def n_cells_global(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def plane(self) -> int:
        return self.nx * self.ny

    @property
    def volume(self) -> float:
        return self.h ** 3

    @property
    def area(self) -> float:
        return self.h ** 2

    # ---- local addressing (identical for every part) ---------------------
    def cell_id(self, i, j, kl):
        return i + self.nx * (j + self.ny * kl)

    def _internal_faces(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """owner, neigh, axis (0=x,1=y,2=z) for all part-internal faces.

        OpenFOAM convention: owner < neigh; faces ordered x-dir, y-dir, z-dir,
        each in lexicographic cell order. This ordering is the LDU face order.
        """
        nx, ny, nzl = self.nx, self.ny, self.nzl
        i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nzl),
                              indexing="ij")
        own, ngb, ax = [], [], []
        # x faces: between (i, j, k) and (i+1, j, k)
        m = i < nx - 1
        own.append(self.cell_id(i[m], j[m], k[m]))
        ngb.append(self.cell_id(i[m] + 1, j[m], k[m]))
        ax.append(np.zeros(m.sum(), dtype=np.int8))
        # y faces
        m = j < ny - 1
        own.append(self.cell_id(i[m], j[m], k[m]))
        ngb.append(self.cell_id(i[m], j[m] + 1, k[m]))
        ax.append(np.ones(m.sum(), dtype=np.int8))
        # z faces (slab-internal only)
        m = k < nzl - 1
        own.append(self.cell_id(i[m], j[m], k[m]))
        ngb.append(self.cell_id(i[m], j[m], k[m] + 1))
        ax.append(np.full(m.sum(), 2, dtype=np.int8))
        owner = np.concatenate(own).astype(np.int32)
        neigh = np.concatenate(ngb).astype(np.int32)
        axis = np.concatenate(ax)
        order = np.argsort(owner, kind="stable")  # OpenFOAM upper-triangular order
        return owner[order], neigh[order], axis[order]

    @property
    def owner(self) -> np.ndarray:
        return self._faces_cache()[0]

    @property
    def neigh(self) -> np.ndarray:
        return self._faces_cache()[1]

    @property
    def face_axis(self) -> np.ndarray:
        return self._faces_cache()[2]

    def _faces_cache(self):
        if not hasattr(self, "_faces"):
            object.__setattr__(self, "_faces", self._internal_faces())
        return self._faces

    @property
    def n_faces(self) -> int:
        return len(self.owner)

    # ---- processor interfaces --------------------------------------------
    def _plane_cells(self, kl: int) -> np.ndarray:
        i, j = np.meshgrid(np.arange(self.nx), np.arange(self.ny), indexing="ij")
        return self.cell_id(i, j, kl).ravel(order="F").astype(np.int32)

    @property
    def ifaces(self) -> tuple[IfaceSpec, IfaceSpec]:
        bottom = self._plane_cells(0)
        top = self._plane_cells(self.nzl - 1)
        return (
            IfaceSpec("down", -1, rows=bottom, remote_rows=top),
            IfaceSpec("up", +1, rows=top, remote_rows=bottom),
        )

    def iface_mask(self) -> np.ndarray:
        """(n_parts, 2) bool — which interfaces physically exist per part."""
        mask = np.ones((self.n_parts, 2), dtype=bool)
        mask[0, DOWN] = False
        mask[self.n_parts - 1, UP] = False
        return mask

    # ---- physical boundary patches ----------------------------------------
    @property
    def patches(self) -> tuple[PatchSpec, ...]:
        nx, ny, nzl = self.nx, self.ny, self.nzl
        j, k = np.meshgrid(np.arange(ny), np.arange(nzl), indexing="ij")
        x0 = self.cell_id(0, j, k).ravel().astype(np.int32)
        x1 = self.cell_id(nx - 1, j, k).ravel().astype(np.int32)
        i, k = np.meshgrid(np.arange(nx), np.arange(nzl), indexing="ij")
        y0 = self.cell_id(i, 0, k).ravel().astype(np.int32)
        y1 = self.cell_id(i, ny - 1, k).ravel().astype(np.int32)
        bottom = self._plane_cells(0)
        lid = self._plane_cells(self.nzl - 1)
        return (
            PatchSpec("wall_x0", x0, (-1, 0, 0), None),
            PatchSpec("wall_x1", x1, (1, 0, 0), None),
            PatchSpec("wall_y0", y0, (0, -1, 0), None),
            PatchSpec("wall_y1", y1, (0, 1, 0), None),
            PatchSpec("wall_bottom", bottom, (0, 0, -1), 0),
            PatchSpec("lid", lid, (0, 0, 1), self.n_parts - 1),
        )

    def patch_mask(self) -> np.ndarray:
        """(n_parts, n_patches) bool — patch presence per part."""
        P = self.n_parts
        mask = np.ones((P, len(self.patches)), dtype=bool)
        for pi, patch in enumerate(self.patches):
            if patch.only_part is not None:
                mask[:, pi] = False
                mask[patch.only_part, pi] = True
        return mask

    # ---- convenience -------------------------------------------------------
    def with_parts(self, n_parts: int) -> "CavityMesh":
        return dataclasses.replace(self, n_parts=n_parts)

    def global_cell_ids(self, part: int) -> np.ndarray:
        return np.arange(self.n_cells, dtype=np.int64) + part * self.n_cells
