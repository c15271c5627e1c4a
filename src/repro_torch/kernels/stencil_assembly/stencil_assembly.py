"""On-device momentum assembly (refactoring baseline): kernel, plain version,
entry point.

The paper contrasts plugin-style acceleration (assembly on the CPU ranks,
repartitioned solve on the card — the main path) with refactoring the
assembly onto the accelerator.  :func:`momentum_bands` is the latter for
the momentum equation: face fluxes and conductances straight to the 7 DIA
bands, with no LDU buffers and no update pattern.  It is cavity-only, as
the JAX package's ``momentum_bands_pallas`` is, and the PISO step does not
call it.

The kernel (``csrc/stencil_assembly.cu``) replaces the TPU kernel
``momentum_bands_single`` of ``src/repro/kernels/stencil_assembly/
stencil_assembly.py``.  It is bound by bytes: 7 values read and 7 written
per row.  Its plain version is :func:`momentum_bands_plain`, a port of the
JAX package's ``ref.py``.

Both read the stacked (P, m) input arrays flat, with ``[0, P*m)`` the only
valid range: the ``-plane`` read at a part's first plane lands on the
previous part's top plane (the TPU wrapper's halo fill of ``phi_z`` and
``gz``), and a ``-1`` or ``-nx`` read across a row, plane or part edge
lands on a cell whose ``+x`` / ``+y`` face is absent, where the inputs
are zero (the TPU wrapper's zero pad).  So no padded copies are made.

:func:`momentum_bands_stacked` takes the plain version for tensors on the
CPU only; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.fvm.mesh import CavityMesh
from repro_torch.kernels._build import DTYPE_CODES, load
from repro_torch.kernels.spmv_dia.spmv_dia import stream_ptr
from repro_torch.sparse.distributed import halo_exchange

__all__ = ["momentum_bands", "face_arrays", "momentum_bands_stacked",
           "momentum_bands_plain", "momentum_bands_cost",
           "check_face_operands"]

N_BANDS = 7
_KERNEL_DTYPES = (torch.float64, torch.float32)


def momentum_bands_cost(n_rows: int, itemsize: int = 8) -> dict:
    """Bytes and operations of one stacked call (ints): 7 input arrays read
    once and 7 bands written once; per row 19 additions and 12 min/max."""
    return {"bytes_accessed": 2 * N_BANDS * n_rows * itemsize,
            "flops": 31 * n_rows, "transcendentals": 0}


def _back(a: torch.Tensor, s: int) -> torch.Tensor:
    """``a`` read flat at ``g - s``, zero below 0; same (P, m) shape."""
    if s == 0:
        return a
    flat = a.reshape(-1)
    n = flat.numel()
    k = min(s, n)
    return torch.cat([flat.new_zeros(k), flat[:n - k]]).reshape(a.shape)


def momentum_bands_plain(phi_x, phi_y, phi_z, gx, gy, gz, bnd, *, nx: int,
                         plane: int, vdt: float) -> torch.Tensor:
    """(P, 7, m) momentum DIA bands from (P, m) cell-indexed face arrays.

    Band order ``[-plane, -nx, -1, 0, +1, +nx, +plane]``; the diagonal is
    summed left to right in the TPU kernel's order.
    """
    pxm, pym, pzm = _back(phi_x, 1), _back(phi_y, nx), _back(phi_z, plane)
    cgxm, cgym, cgzm = _back(gx, 1), _back(gy, nx), _back(gz, plane)

    def mn(a):
        return torch.clamp_max(a, 0.0)

    def mx(a):
        return torch.clamp_min(a, 0.0)

    diag = (vdt + bnd
            + mx(phi_x) + gx + mx(-pxm) + cgxm
            + mx(phi_y) + gy + mx(-pym) + cgym
            + mx(phi_z) + gz + mx(-pzm) + cgzm)
    return torch.stack([
        mn(-pzm) - cgzm,
        mn(-pym) - cgym,
        mn(-pxm) - cgxm,
        diag,
        mn(phi_x) - gx,
        mn(phi_y) - gy,
        mn(phi_z) - gz,
    ], dim=1)


def check_face_operands(arrays) -> None:
    """Raise unless the seven (P, m) arrays suit the kernel."""
    first = arrays[0]
    if first.device.type != "cuda" or first.dim() != 2:
        raise ValueError(f"(P, m) CUDA tensors expected, got "
                         f"{tuple(first.shape)} on {first.device}")
    if first.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"dtype {first.dtype} not in {_KERNEL_DTYPES}")
    for a in arrays:
        if (a.device != first.device or a.dtype != first.dtype
                or a.shape != first.shape):
            raise ValueError("the seven face arrays must share device, dtype "
                             "and shape")
        if not a.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def momentum_bands_stacked(phi_x, phi_y, phi_z, gx, gy, gz, bnd, *, nx: int,
                           plane: int, vdt: float) -> torch.Tensor:
    """Stacked momentum bands: seven (P, m) face arrays → (P, 7, m)."""
    arrays = (phi_x, phi_y, phi_z, gx, gy, gz, bnd)
    kw = dict(nx=nx, plane=plane, vdt=vdt)
    if all(a.device.type == "cpu" for a in arrays):
        return momentum_bands_plain(*arrays, **kw)
    check_face_operands(arrays)
    P, m = phi_x.shape
    out = torch.empty((P, N_BANDS, m), dtype=phi_x.dtype,
                      device=phi_x.device)
    rc = load("stencil_assembly").momentum_bands_launch(
        DTYPE_CODES[(phi_x.dtype, phi_x.dtype)],
        *(a.data_ptr() for a in arrays), out.data_ptr(), P, m, nx, plane,
        float(vdt), stream_ptr(phi_x))
    if rc != 0:
        raise RuntimeError(f"momentum_bands kernel launch failed (code {rc})")
    momentum_bands_stacked.launches += 1
    return out


momentum_bands_stacked.launches = 0


# ---------------------------------------------------------------------------
# the entry point: face arrays from the velocity field, then the kernel
# ---------------------------------------------------------------------------

def _cell_masks(mesh: CavityMesh):
    """Static per-cell masks (numpy): face presence and boundary faces."""
    nx, ny, nzl = mesh.nx, mesh.ny, mesh.nzl
    i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nzl),
                          indexing="ij")
    inv = np.argsort((i + nx * (j + ny * k)).ravel())

    def field(arr):
        return arr.ravel()[inv].astype(np.float64)

    mask_x = field(i < nx - 1)                      # has a +x internal face
    mask_y = field(j < ny - 1)
    mask_z_int = field(k < nzl - 1)                 # slab-internal +z face
    mask_z_top = field(k == nzl - 1)                # face into the next part
    # boundary-face count per cell: x/y walls everywhere, z walls on the
    # end parts only
    bnd_xy = field((i == 0).astype(int) + (i == nx - 1) + (j == 0)
                   + (j == ny - 1))
    bnd_bottom = field(k == 0)     # part 0 only
    bnd_top = field(k == nzl - 1)  # part P-1 only (the lid)
    return (mask_x, mask_y, mask_z_int, mask_z_top, bnd_xy, bnd_bottom,
            bnd_top)


@functools.lru_cache(maxsize=4)
def _device_masks(mesh: CavityMesh, device: torch.device,
                  dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
    """:func:`_cell_masks` on ``device``, built once per mesh."""
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in _cell_masks(mesh))


def face_arrays(U: torch.Tensor, *, mesh: CavityMesh, nu: float,
                dt: float) -> tuple[tuple[torch.Tensor, ...], dict]:
    """The kernel's operands for U (P, m, 3) on partition ``mesh``.

    Returns the seven (P, m) arrays ``(phi_x, phi_y, phi_z, gx, gy, gz,
    bnd)`` and the scalars ``{nx, plane, vdt}``: the JAX package's
    ``momentum_bands_pallas`` preparation — interpolated velocities,
    masked, with the next part's bottom plane for the z faces; the
    conductances and boundary closures — in the same order of operations,
    without its padding.
    """
    P, m, _ = U.shape
    if P != mesh.n_parts or m != mesh.n_cells:
        raise ValueError(f"U {tuple(U.shape)} does not fit a mesh of "
                         f"{mesh.n_parts} parts of {mesh.n_cells} cells")
    nx, plane, A, h = mesh.nx, mesh.plane, mesh.area, mesh.h
    g = nu * A / h
    gb = nu * A / (0.5 * h)
    vdt = mesh.volume / dt
    dtype, dev = U.dtype, U.device
    mask_x, mask_y, mz_int, mz_top, bnd_xy, bnd_bot, bnd_top = _device_masks(
        mesh, dev, dtype)
    parts = torch.arange(P, device=dev)

    def part_flag(cond):
        return cond.to(dtype)[:, None]

    def shift_left(a, s):  # a[:, c + s], zero-filled, within the part
        return torch.cat([a[:, s:], a.new_zeros((P, s))], dim=1)

    u, v, w = U[..., 0], U[..., 1], U[..., 2]
    phi_x = 0.5 * (u + shift_left(u, 1)) * A * mask_x
    phi_y = 0.5 * (v + shift_left(v, nx)) * A * mask_y
    # z faces: slab-internal ones, and the face into the next part (halo)
    _, up = halo_exchange(w, plane)
    w_up = shift_left(w, plane) + torch.nn.functional.pad(up, (m - plane, 0))
    mask_z = mz_int + mz_top * part_flag(parts < P - 1)
    phi_z = 0.5 * (w + w_up) * A * mask_z
    ones = torch.ones((P, 1), dtype=dtype, device=dev)
    gx = g * mask_x * ones
    gy = g * mask_y * ones
    gz = g * mask_z
    bnd = gb * (bnd_xy * ones + bnd_bot * part_flag(parts == 0)
                + bnd_top * part_flag(parts == P - 1))
    return ((phi_x, phi_y, phi_z, gx, gy, gz, bnd),
            {"nx": nx, "plane": plane, "vdt": vdt})


def momentum_bands(U: torch.Tensor, *, mesh: CavityMesh, nu: float,
                   dt: float) -> torch.Tensor:
    """(P, 7, m) momentum DIA bands from U (P, m, 3) on partition ``mesh``.

    The counterpart of the JAX package's ``momentum_bands_pallas``
    (cavity only): :func:`face_arrays`, then the kernel on a CUDA ``U`` or
    its plain version on a CPU ``U``.
    """
    arrays, scalars = face_arrays(U, mesh=mesh, nu=nu, dt=dt)
    return momentum_bands_stacked(*arrays, **scalars)
