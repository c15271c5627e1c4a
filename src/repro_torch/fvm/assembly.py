"""FVM assembly for icoFOAM on the slab-decomposed box mesh (PyTorch).

Assembles, on the **fine (CPU/assembly) partition**, the LDU coefficients of

* the momentum predictor  ``ddt(U) + div(phi, U) - nu*laplacian(U) = -grad(p)``
  (upwind convection, central diffusion — the same matrix for all three
  velocity components, per OpenFOAM), and
* the segregated pressure equation ``laplacian(rAU, p) = div(phiHbyA)``.

All tensors are stacked over the fine part axis (P, ...).  Boundary
conditions come from a :class:`~repro_torch.fvm.cases.FlowCase` (one
:class:`~repro_torch.fvm.cases.PatchBC` per box face).  The default is the
paper's lid-driven cavity — no-slip walls, a moving lid at z = max,
zeroGradient pressure with a reference cell — whose boundary faces all
have zero normal velocity.  Inlet/outlet cases carry a **boundary-flux
plane pair** ``phi_b`` of shape ``(P, 2, B)`` (slot ``DOWN`` = the ``z0``
face, slot ``UP`` = ``z1``): inlets contribute a fixed Dirichlet flux and
a convective inflow source, outlets drop the boundary diffusion term
(zero-gradient U), pin ``p = 0`` over the half cell (no reference cell
needed), and get their flux corrected conservatively alongside the
internal faces.  Boundary diffusion of Dirichlet patches uses the
half-cell distance h/2.

**Deterministic sums.**  Every face-to-cell sum over the internal faces
(``owner``/``neigh`` repeat: a cell owns up to three faces) goes through a
gather table built once in numpy (:class:`CellSum`): column ``k`` holds each
cell's ``k``-th contributing face in face order, so the sum is a fixed
sequence of gathers and adds — the order the JAX package's scatter-add
takes on the CPU — and never an atomic scatter.  Interface and patch rows
are unique within each add, which is a plain indexed update.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from repro_torch.env import DTYPE, resolve_device
from repro_torch.fvm.cases import (FlowCase, INLET, MOVING_WALL, OUTLET,
                                   PatchBC, get_case)
from repro_torch.fvm.mesh import CavityMesh, DOWN, UP
from repro_torch.sparse.distributed import halo_exchange

__all__ = ["CavityAssembly", "MomentumSystem", "PressureSystem", "CellSum"]


@dataclasses.dataclass
class MomentumSystem:
    """LDU coefficients (fine partition) + per-component RHS."""

    diag: torch.Tensor    # (P, m)
    upper: torch.Tensor   # (P, F)  a(owner, neigh)
    lower: torch.Tensor   # (P, F)  a(neigh, owner)
    iface: torch.Tensor   # (P, 2, B) interface coefficients (masked at z-bounds)
    source: torch.Tensor  # (P, m, 3)


@dataclasses.dataclass
class PressureSystem:
    diag: torch.Tensor    # (P, m)
    upper: torch.Tensor   # (P, F)
    lower: torch.Tensor   # (P, F)
    iface: torch.Tensor   # (P, 2, B)
    source: torch.Tensor  # (P, m)
    g_int: torch.Tensor   # (P, F) face conductances (for flux correction)
    g_if: torch.Tensor    # (P, 2, B)
    g_b: torch.Tensor     # (P, 2, B) outlet (Dirichlet-p) boundary conductances


class CellSum:
    """Deterministic ``base.at[:, idx].add(v)`` for a repeated index.

    ``table[c, k]`` is the position in ``idx`` of cell ``c``'s ``k``-th
    entry in index order, or ``len(idx)`` (a zero slot) past its last one.
    """

    def __init__(self, idx: np.ndarray, n_cells: int, device):
        n = len(idx)
        order = np.argsort(idx, kind="stable")
        counts = np.bincount(idx, minlength=n_cells)
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(n) - start[idx[order]]
        table = np.full((n_cells, max(int(counts.max(initial=0)), 1)), n,
                        dtype=np.int64)
        table[idx[order], rank] = order
        self.columns = [torch.as_tensor(table[:, k], device=device)
                        for k in range(table.shape[1])]

    def add(self, base: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """``base`` (P, m, ...) plus ``v`` (P, n, ...) summed per cell."""
        pad = torch.zeros((v.shape[0], 1) + tuple(v.shape[2:]),
                          dtype=v.dtype, device=v.device)
        vp = torch.cat([v, pad], dim=1)
        for col in self.columns:
            base = base + vp.index_select(1, col)
        return base


def _add_rows(base: torch.Tensor, rows: torch.Tensor, v,
              comp: int | None = None) -> torch.Tensor:
    """``base.at[:, rows(, comp)].add(v)`` for unique ``rows``."""
    out = base.clone()
    if comp is None:
        out[:, rows] = base[:, rows] + v
    else:
        out[:, rows, comp] = base[:, rows, comp] + v
    return out


def _patch_role(normal) -> str:
    """Geometric role of a patch from its outward normal (cases.ROLES)."""
    axis = int(np.argmax(np.abs(normal)))
    return "xyz"[axis] + ("1" if normal[axis] > 0 else "0")


class CavityAssembly:
    """Precomputed static addressing + assembly routines for one mesh.

    ``case`` binds a :class:`~repro_torch.fvm.cases.FlowCase` (name,
    instance, or ``None`` for the classic cavity built from
    ``lid_speed``); masks, Dirichlet velocities, boundary-flux slots and
    the pressure reference policy derive from it.  All tensors live on
    ``device``.
    """

    def __init__(self, mesh: CavityMesh, *, nu: float = 0.01,
                 lid_speed: float = 1.0, dtype: torch.dtype = DTYPE,
                 case: FlowCase | str | None = None, device="cuda"):
        self.device = dev = resolve_device(device)
        self.mesh = mesh
        self.nu = nu
        self.lid_speed = lid_speed
        self.dtype = dtype
        if case is None:
            # the historical default: the cavity with its lid at lid_speed
            case = get_case("cavity", u_ref=lid_speed)
            case = dataclasses.replace(
                case, bcs={"z1": PatchBC(MOVING_WALL,
                                         U=(lid_speed, 0.0, 0.0))})
        self.case = get_case(case)
        P = mesh.n_parts
        self.owner = torch.as_tensor(mesh.owner, dtype=torch.int64, device=dev)
        self.neigh = torch.as_tensor(mesh.neigh, dtype=torch.int64, device=dev)
        self.face_axis = torch.as_tensor(mesh.face_axis, dtype=torch.int64,
                                         device=dev)
        self.own_sum = CellSum(mesh.owner, mesh.n_cells, dev)
        self.ngb_sum = CellSum(mesh.neigh, mesh.n_cells, dev)
        ifs = mesh.ifaces
        self.if_rows = torch.as_tensor(np.stack([s.rows for s in ifs]),
                                       dtype=torch.int64, device=dev)
        # (P, 2) presence mask for interfaces, broadcast over faces
        self.if_mask = torch.as_tensor(mesh.iface_mask(), dtype=dtype,
                                       device=dev)[:, :, None]
        # boundary patches: per-patch BC kind + Dirichlet velocity, bound
        # from the case by geometric role.  patch_Ub entries are (3,)
        # uniform values or (n_bf, 3) per-face values (profiled inlets).
        self.patch_rows = [torch.as_tensor(p.rows, dtype=torch.int64,
                                           device=dev) for p in mesh.patches]
        self.patch_mask = torch.as_tensor(mesh.patch_mask(), dtype=dtype,
                                          device=dev)  # (P, n_patches)
        self.patch_kind = [self.case.bc(_patch_role(p.normal)).kind
                           for p in mesh.patches]
        self.patch_Ub = [self._patch_Ub(p) for p in mesh.patches]
        self.patch_normal = [torch.as_tensor(p.normal, dtype=dtype,
                                             device=dev)
                             for p in mesh.patches]
        self.V = mesh.volume
        self.A = mesh.area
        self.h = mesh.h
        self.plane = mesh.plane
        self.n_parts = P
        # a cohort view (lane_view) stacks lanes of lane_parts parts each
        self.lane_parts = P
        self.n_lanes = 1
        self.m = mesh.n_cells
        self._patch_nz = [p.normal[2] for p in mesh.patches]
        # z-plane patches own the (P, 2, B) boundary-flux slots: slot DOWN
        # is the z0 face, slot UP the z1 face (rows match if_rows order)
        self._z_patch = {DOWN if nz < 0 else UP: pi
                         for pi, nz in enumerate(self._patch_nz) if nz != 0}
        self._needs_ref = self.case.needs_ref
        # called with each field whose neighbour planes are read across
        # parts (a solver over a mesh counts those moves); None: no one
        self.on_halo = None
        # a block view's neighbour planes (block_view); None: the parts
        # here are all the parts
        self._block_halo = None
        # the rows whose cell 0 is the pressure reference (None: part 0 of
        # every lane)
        self.ref_rows = None
        # a block view's global part indices (block_view; None: the parts
        # here are parts 0, 1, ... of each lane)
        self.part_ids = None

    def _halo(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The neighbour planes of ``x`` (:func:`halo_exchange`, or a block
        view's exchange), reported to ``on_halo`` first."""
        if self.on_halo is not None:
            self.on_halo(x)
        if self._block_halo is not None:
            return self._block_halo(x)
        return halo_exchange(x, self.plane, self.lane_parts)

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def _patch_Ub(self, patch) -> torch.Tensor:
        """Dirichlet boundary velocity of one patch: (3,) uniform, or
        (n_bf, 3) per-face for a profiled inlet (outlets get zeros: their
        velocity is zero-gradient, never sourced)."""
        bc = self.case.bc(_patch_role(patch.normal))
        U = torch.as_tensor(bc.U if bc.kind != OUTLET else (0.0, 0.0, 0.0),
                            dtype=self.dtype, device=self.device)
        if bc.kind == INLET and bc.profile == "upper_half":
            # plane rows are _plane_cells order: t -> (i = t % nx,
            # j = t // nx); the inlet spans the j >= ny/2 half
            j = np.arange(len(patch.rows)) // self.mesh.nx
            prof = torch.as_tensor(j >= self.mesh.ny // 2, dtype=self.dtype,
                                   device=self.device)
            return prof[:, None] * U[None, :]
        return U

    def _z_Ub_face(self, slot: int) -> torch.Tensor:
        """(B, 3) Dirichlet velocity over a z-plane slot (zeros for an
        outlet: inflow across an outlet convects nothing)."""
        Ub = self.patch_Ub[self._z_patch[slot]]
        return torch.atleast_2d(Ub).expand(self.plane, 3)

    # ------------------------------------------------------------------
    # part-activity masks (size-class padding) and cohort views
    # ------------------------------------------------------------------
    def dynamic_masks(self, n_active) -> tuple[torch.Tensor, torch.Tensor]:
        """``(if_mask, patch_mask)`` as functions of ``n_active``.

        ``n_active`` is the number of *real* leading parts of a lane;
        parts at and beyond it are size-class zero padding (ghost slabs)
        with no interfaces and no boundary patches.  The lid patch rides
        on the last active part and the bottom wall on part 0, matching
        the static masks of a :class:`~repro_torch.fvm.mesh.
        PaddedCavityMesh`.  A 0-d ``n_active`` gives one lane's masks,
        ``(P, 2, 1)`` and ``(P, n_patches)``; a ``(B,)`` tensor gives a
        cohort's, one lane after another, ``(B*P, 2, 1)`` and ``(B*P,
        n_patches)``.  They are computed on the device from the tensor, so
        one program serves every real size of a size class.  A block view
        (:meth:`block_view`) gives its own parts' rows, each part's by its
        global index.
        """
        n = torch.as_tensor(n_active, device=self.device).reshape(-1, 1)
        ids = (torch.arange(self.lane_parts, device=self.device)
               if self.part_ids is None else self.part_ids)[None, :]
        act = ids < n
        down = act & (ids >= 1)
        up = ids < (n - 1)
        if_mask = torch.stack([down, up], dim=2).to(self.dtype)
        cols = []
        for nz in self._patch_nz:
            if nz > 0:        # lid: last active part
                cols.append(act & (ids == n - 1))
            elif nz < 0:      # bottom wall: part 0
                cols.append(act & (ids == 0))
            else:             # side walls: every active part
                cols.append(act)
        patch_mask = torch.stack(cols, dim=2).to(self.dtype)
        return (if_mask.reshape(-1, 2)[:, :, None],
                patch_mask.reshape(-1, len(cols)))

    def with_masks(self, if_mask: torch.Tensor,
                   patch_mask: torch.Tensor) -> "CavityAssembly":
        """A shallow view of this assembly with the activity masks swapped
        (static addressing shared): how the padded program binds the masks
        of its ``n_active`` operand."""
        a = copy.copy(self)
        a.if_mask = if_mask
        a.patch_mask = patch_mask
        return a

    def lane_view(self, lanes: int) -> "CavityAssembly":
        """A view of this assembly over a cohort of ``lanes`` lanes, fields
        stacked ``(lanes * P, ...)``, one lane's parts after another.  Each
        lane is assembled exactly as it is alone (the same per-part
        operations): the halo is zero at every lane border, so nothing
        reads a neighbouring lane; the static masks repeat per lane; each
        lane's part 0 carries its own reference cell."""
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        a = copy.copy(self)
        a.n_lanes = lanes
        a.n_parts = lanes * self.lane_parts
        a.if_mask = self.if_mask.repeat(lanes, 1, 1)
        a.patch_mask = self.patch_mask.repeat(lanes, 1)
        return a

    def block_view(self, parts, device, halo) -> "CavityAssembly":
        """A view of this assembly over the fine parts ``parts`` (sorted
        global part indices) on ``device``, fields stacked ``(len(parts),
        ...)``: the static addressing copied there, the masks of those
        parts, the pressure reference on global part 0 where the block
        holds it, and ``halo(x) -> (down, up)`` giving each part's
        neighbour planes (some held elsewhere).  Each part is assembled
        exactly as in the whole, the same per-part operations; a padded
        program's activity masks (:meth:`dynamic_masks`) follow the parts'
        global indices."""
        dev = torch.device(device)

        def to(t):
            return t.to(dev)

        def cells(cs):
            c = copy.copy(cs)
            c.columns = [to(col) for col in cs.columns]
            return c

        idx = torch.as_tensor(list(parts), dtype=torch.int64)
        a = copy.copy(self)
        a.device = dev
        a.owner, a.neigh, a.face_axis = (to(self.owner), to(self.neigh),
                                         to(self.face_axis))
        a.own_sum, a.ngb_sum = cells(self.own_sum), cells(self.ngb_sum)
        a.if_rows = to(self.if_rows)
        a.if_mask = to(self.if_mask.index_select(0, idx.to(
            self.if_mask.device)))
        a.patch_rows = [to(r) for r in self.patch_rows]
        a.patch_mask = to(self.patch_mask.index_select(0, idx.to(
            self.patch_mask.device)))
        a.patch_Ub = [to(u) for u in self.patch_Ub]
        a.patch_normal = [to(n) for n in self.patch_normal]
        a.n_parts = a.lane_parts = len(parts)
        a.ref_rows = [i for i, f in enumerate(parts) if f == 0]
        a.part_ids = idx.to(dev)
        a._block_halo = halo
        a.on_halo = None
        return a

    # ------------------------------------------------------------------
    # face interpolation / fluxes
    # ------------------------------------------------------------------
    def face_flux(self, U: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """phi (P,F) internal fluxes and phi_if (P,2,B) interface fluxes.

        phi_f = 0.5*(U_o + U_n)[axis] * A, oriented owner→neigh.  Interface
        fluxes are *outward* of the owning part (down: -z, up: +z).
        """
        P = U.shape[0]
        F = self.owner.shape[0]
        Uf = 0.5 * (U.index_select(1, self.owner)
                    + U.index_select(1, self.neigh))
        axis = self.face_axis.view(1, F, 1).expand(P, F, 1)
        phi = torch.gather(Uf, 2, axis)[..., 0] * self.A
        # interface: halo of w-velocity planes
        w = U[..., 2]
        # remote plane values
        down, up = self._halo(w)
        phi_down = -self.A * 0.5 * (w[:, self.if_rows[DOWN]] + down)
        phi_up = +self.A * 0.5 * (w[:, self.if_rows[UP]] + up)
        phi_if = torch.stack([phi_down, phi_up], dim=1) * self.if_mask
        return phi, phi_if

    def boundary_flux(self, U: torch.Tensor) -> torch.Tensor:
        """(P, 2, B) outward boundary fluxes of the z-plane patches.

        Dirichlet patches (walls, lid, inlets) contribute their *fixed*
        flux ``U_b . n A`` — independent of ``U``, zero for every wall —
        while an outlet's zero-gradient flux extrapolates the owner-cell
        velocity.  x/y wall patches never carry a normal flux (the case
        registry restricts inlet/outlet to z-faces).
        """
        P = U.shape[0]
        phi_b = self._zeros(P, 2, self.plane)
        for slot, pi in self._z_patch.items():
            nz = self._patch_nz[pi]
            if self.patch_kind[pi] == OUTLET:
                f = U[:, self.patch_rows[pi], 2] * (nz * self.A)
            else:
                w = torch.atleast_2d(self.patch_Ub[pi])[:, 2]  # (1,) or (B,)
                f = (w * (nz * self.A)).expand(P, self.plane)
            phi_b[:, slot] = f * self.patch_mask[:, pi][:, None]
        return phi_b

    # ------------------------------------------------------------------
    # Gauss gradient with zero-gradient boundary pressure
    # ------------------------------------------------------------------
    def grad(self, p: torch.Tensor) -> torch.Tensor:
        """(P, m, 3) Gauss gradient of a cell scalar field."""
        P, m = p.shape
        g = self._zeros(P, m, 3)
        pf = 0.5 * (p[:, self.owner] + p[:, self.neigh])  # (P, F)
        sf = torch.nn.functional.one_hot(self.face_axis, 3).to(
            self.dtype) * self.A  # (F, 3)
        contrib = pf[:, :, None] * sf[None, :, :]
        g = self.own_sum.add(g, contrib)
        g = self.ngb_sum.add(g, -contrib)
        # interfaces: S = ±A e_z outward
        down, up = self._halo(p)
        pf_down = 0.5 * (p[:, self.if_rows[DOWN]] + down) * self.if_mask[:, DOWN]
        pf_up = 0.5 * (p[:, self.if_rows[UP]] + up) * self.if_mask[:, UP]
        g = _add_rows(g, self.if_rows[DOWN], -self.A * pf_down, comp=2)
        g = _add_rows(g, self.if_rows[UP], self.A * pf_up, comp=2)
        # boundaries: zero-gradient ⇒ p_b = p_owner, S = A n_outward;
        # outlets pin p_b = 0 (Dirichlet), so their face term vanishes
        for rows, mask, n, kind in zip(self.patch_rows, self.patch_mask.T,
                                       self.patch_normal, self.patch_kind):
            if kind == OUTLET:
                continue
            pb = p[:, rows] * mask[:, None]
            g = _add_rows(g, rows, pb[:, :, None] * (self.A * n)[None, None, :])
        return g / self.V

    def divergence(self, phi: torch.Tensor, phi_if: torch.Tensor,
                   phi_b: torch.Tensor | None = None) -> torch.Tensor:
        """(P, m) cell divergence of face fluxes (outward-positive);
        ``phi_b`` adds the z-plane boundary fluxes."""
        P = phi.shape[0]
        d = self._zeros(P, self.m)
        d = self.own_sum.add(d, phi)
        d = self.ngb_sum.add(d, -phi)
        d = _add_rows(d, self.if_rows[DOWN], phi_if[:, DOWN])
        d = _add_rows(d, self.if_rows[UP], phi_if[:, UP])
        if phi_b is not None:
            d = _add_rows(d, self.if_rows[DOWN], phi_b[:, DOWN])
            d = _add_rows(d, self.if_rows[UP], phi_b[:, UP])
        return d

    # ------------------------------------------------------------------
    # momentum predictor
    # ------------------------------------------------------------------
    def assemble_momentum(self, U_old: torch.Tensor, phi: torch.Tensor,
                          phi_if: torch.Tensor, p: torch.Tensor | None,
                          dt, phi_b: torch.Tensor | None = None,
                          gradp: torch.Tensor | None = None
                          ) -> MomentumSystem:
        """``dt``: a float, or a tensor of one value per part (a cohort's
        per-lane timesteps).  ``gradp`` short-circuits the
        pressure-gradient source: a caller that already holds ``grad(p)``
        (the pipelined executor carries it across the step boundary) passes
        it with ``p=None``."""
        P, m = U_old.shape[:2]
        F = phi.shape[1]
        if torch.is_tensor(dt):
            # a true division, as the float path's (``V / tensor`` would
            # multiply by the reciprocal)
            vdt = (torch.full_like(dt, self.V) / dt).reshape(P, 1)
            diag = vdt.expand(P, m)
            source = vdt[..., None] * U_old
        else:
            diag = torch.full((P, m), self.V / dt, dtype=self.dtype,
                              device=self.device)
            source = (self.V / dt) * U_old
        upper = self._zeros(P, F)
        lower = self._zeros(P, F)
        iface = torch.zeros_like(phi_if)

        # convection, upwind
        diag = self.own_sum.add(diag, torch.clamp_min(phi, 0.0))
        upper = upper + torch.clamp_max(phi, 0.0)
        diag = self.ngb_sum.add(diag, torch.clamp_min(-phi, 0.0))
        lower = lower + torch.clamp_max(-phi, 0.0)
        diag = _add_rows(diag, self.if_rows[DOWN],
                         torch.clamp_min(phi_if[:, DOWN], 0.0))
        diag = _add_rows(diag, self.if_rows[UP],
                         torch.clamp_min(phi_if[:, UP], 0.0))
        iface = iface + torch.clamp_max(phi_if, 0.0)

        # boundary convection (z-plane patches, upwind): outflow convects
        # the owner value (diagonal), inflow the Dirichlet boundary
        # velocity (source).  Identically zero for the cavity.
        if phi_b is not None:
            for slot in (DOWN, UP):
                rows = self.if_rows[slot]
                diag = _add_rows(diag, rows,
                                 torch.clamp_min(phi_b[:, slot], 0.0))
                Ub = self._z_Ub_face(slot)
                source = _add_rows(
                    source, rows,
                    (-torch.clamp_max(phi_b[:, slot], 0.0))[..., None]
                    * Ub[None, :, :])

        # diffusion, central
        g = self.nu * self.A / self.h
        gf = torch.full((P, F), g, dtype=self.dtype, device=self.device)
        diag = self.own_sum.add(diag, gf)
        diag = self.ngb_sum.add(diag, gf)
        upper = upper - g
        lower = lower - g
        diag = _add_rows(diag, self.if_rows[DOWN], g * self.if_mask[:, DOWN])
        diag = _add_rows(diag, self.if_rows[UP], g * self.if_mask[:, UP])
        iface = iface - g * self.if_mask

        # boundary diffusion (Dirichlet walls/lid/inlets, half-cell
        # distance); outlets are zero-gradient — no boundary term
        gb = self.nu * self.A / (0.5 * self.h)
        for rows, mask, Ub, kind in zip(self.patch_rows, self.patch_mask.T,
                                        self.patch_Ub, self.patch_kind):
            if kind == OUTLET:
                continue
            diag = _add_rows(diag, rows, gb * mask[:, None])
            source = _add_rows(
                source, rows,
                gb * mask[:, None, None] * torch.atleast_2d(Ub)[None, ...])

        # pressure gradient source
        source = source - self.V * (self.grad(p) if gradp is None else gradp)
        return MomentumSystem(diag, upper, lower, iface, source)

    def offdiag_apply(self, sys, x: torch.Tensor) -> torch.Tensor:
        """y = (A - diag) x on the fine partition (for OpenFOAM's H())."""
        y = torch.zeros_like(x)
        y = self.own_sum.add(y, sys.upper * x[:, self.neigh])
        y = self.ngb_sum.add(y, sys.lower * x[:, self.owner])
        down, up = self._halo(x)
        y = _add_rows(y, self.if_rows[DOWN], sys.iface[:, DOWN] * down)
        y = _add_rows(y, self.if_rows[UP], sys.iface[:, UP] * up)
        return y

    # ------------------------------------------------------------------
    # PISO pressure equation
    # ------------------------------------------------------------------
    def assemble_pressure_matrix(self, rAU: torch.Tensor,
                                 ref_boost: float = 1.0) -> PressureSystem:
        """The corrector-invariant half of :meth:`assemble_pressure`: every
        coefficient depends only on ``rAU``.  Returns a zero source."""
        P, m = rAU.shape
        rAUf = 0.5 * (rAU[:, self.owner] + rAU[:, self.neigh])
        g_int = rAUf * self.A / self.h
        down, up = self._halo(rAU)
        g_down = 0.5 * (rAU[:, self.if_rows[DOWN]] + down) * self.A / self.h
        g_up = 0.5 * (rAU[:, self.if_rows[UP]] + up) * self.A / self.h
        g_if = torch.stack([g_down, g_up], dim=1) * self.if_mask

        diag = self._zeros(P, m)
        diag = self.own_sum.add(diag, g_int)
        diag = self.ngb_sum.add(diag, g_int)
        diag = _add_rows(diag, self.if_rows[DOWN], g_if[:, DOWN])
        diag = _add_rows(diag, self.if_rows[UP], g_if[:, UP])
        upper = -g_int
        lower = -g_int
        iface = -g_if

        # outlet Dirichlet-p conductances, (P, 2, B) plane pair
        g_b = self._zeros(P, 2, self.plane)
        for slot, pi in self._z_patch.items():
            if self.patch_kind[pi] != OUTLET:
                continue
            rows = self.if_rows[slot]
            gb = rAU[:, rows] * (self.A / (0.5 * self.h))
            g_b[:, slot] = gb * self.patch_mask[:, pi][:, None]
            diag = _add_rows(diag, rows, g_b[:, slot])

        if self._needs_ref:
            # reference cell: diag *= (1 + boost) at cell 0 of each lane
            # (an outlet pins the pressure level instead)
            boost = self._zeros(P, m)
            rows = (slice(None, None, self.lane_parts)
                    if self.ref_rows is None else self.ref_rows)
            boost[rows, 0] = ref_boost
            diag = diag * (1.0 + boost)
        return PressureSystem(diag, upper, lower, iface, self._zeros(P, m),
                              g_int, g_if, g_b)

    def assemble_pressure(self, rAU: torch.Tensor, phiHbyA: torch.Tensor,
                          phiHbyA_if: torch.Tensor,
                          phiHbyA_b: torch.Tensor | None = None,
                          ref_boost: float = 1.0) -> PressureSystem:
        """-laplacian(rAU, p) = -div(phiHbyA), SPD form for CG.

        Face conductance ``g_f = rAU_f * A / h`` with linear interpolation
        of rAU.  Outlet patches carry a Dirichlet p = 0 at the half-cell
        distance (``g_b = rAU * A / (h/2)`` on the diagonal only), which
        pins the pressure level.  Cases without an outlet are all-Neumann:
        there the global reference cell (part 0, cell 0) gets its diagonal
        boosted (``setReference``, refValue = 0), removing the nullspace.
        """
        sys = self.assemble_pressure_matrix(rAU, ref_boost=ref_boost)
        return dataclasses.replace(
            sys, source=-self.divergence(phiHbyA, phiHbyA_if, phiHbyA_b))

    def correct_flux(self, sysP: PressureSystem, phiHbyA, phiHbyA_if, p):
        """phi = phiHbyA - g_f (p_n - p_o); conservative by construction."""
        dp = p[:, self.neigh] - p[:, self.owner]
        phi = phiHbyA - sysP.g_int * dp
        down, up = self._halo(p)
        dp_down = down - p[:, self.if_rows[DOWN]]   # outward (-z): remote - local
        dp_up = up - p[:, self.if_rows[UP]]
        phi_if = phiHbyA_if - torch.stack(
            [sysP.g_if[:, DOWN] * dp_down, sysP.g_if[:, UP] * dp_up], dim=1)
        return phi, phi_if * self.if_mask

    def correct_boundary_flux(self, sysP: PressureSystem, phiHbyA_b, p):
        """phi_b = phiHbyA_b - g_b (p_b - p_o) with outlet p_b = 0.

        ``g_b`` is zero except on outlet planes, so inlet and wall fluxes
        pass through unchanged; outlet fluxes pick up the Dirichlet
        correction that keeps the corrected field conservative cell-wise.
        """
        corr = torch.stack(
            [sysP.g_b[:, DOWN] * p[:, self.if_rows[DOWN]],
             sysP.g_b[:, UP] * p[:, self.if_rows[UP]]], dim=1)
        return phiHbyA_b + corr
