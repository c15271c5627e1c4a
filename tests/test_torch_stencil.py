"""The port's on-device momentum assembly (the refactoring baseline) against
the JAX package, on the CPU.

JAX runs its Pallas ``momentum_bands_single`` in interpret mode, its
``ref.py`` oracle and its ``momentum_bands_pallas`` wrapper; the port runs
its plain version (which its wrapper takes for CPU tensors) and its entry
point ``momentum_bands``.  The port reads the stacked face arrays flat
instead of padding every part; these tests hold that read against the JAX
wrapper's padding, at the part-edge cells too.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.fvm.mesh import CavityMesh as JaxMesh
from repro.kernels.stencil_assembly.ops import momentum_bands_pallas
from repro.kernels.stencil_assembly.ref import momentum_bands_ref
from repro.kernels.stencil_assembly.stencil_assembly import (
    momentum_bands_single)

from repro_torch.core.ldu import buffer_from_parts
from repro_torch.core.repartition import plan_for_mesh
from repro_torch.core.update import update_device_direct
from repro_torch.fvm.assembly import CavityAssembly
from repro_torch.fvm.mesh import CavityMesh
from repro_torch.fvm.piso import PisoSolver
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.stencil_assembly import (face_arrays, momentum_bands,
                                                  momentum_bands_cost,
                                                  momentum_bands_plain)

NU, DT = 0.02, 1e-3
# the JAX kernel's block must divide the part size (tests/test_kernels.py)
BLOCK_ROWS = 64


def _padded(a, plane, halo):
    """(P, m) → (P, plane + m + plane) as the JAX wrapper pads a part: zero
    pads, or (``halo``) the left pad filled from the previous part."""
    P, _ = a.shape
    left = np.zeros((P, plane), a.dtype)
    if halo:
        left[1:] = a[:-1, -plane:]
    return np.concatenate([left, a, np.zeros((P, plane), a.dtype)], axis=1)


def _jax_ref(arrays, halos, *, nx, plane, vdt, kernel=False):
    """JAX's per-part bands for (P, m) numpy face arrays → (P, 7, m)."""
    padded = [_padded(a, plane, h) for a, h in zip(arrays, halos)]
    fn = momentum_bands_ref
    kw = dict(nx=nx, plane=plane, vdt=vdt)
    if kernel:
        fn, kw = momentum_bands_single, dict(kw, block_rows=BLOCK_ROWS,
                                             interpret=True)
    return np.stack([np.asarray(fn(*(jnp.asarray(a[p]) for a in padded),
                                   **kw))
                     for p in range(arrays[0].shape[0])])


@pytest.mark.parametrize("P,m,nx,plane", [(1, 256, 8, 64), (3, 192, 8, 64),
                                          (2, 128, 4, 16)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_momentum_bands_plain_matches_ref_and_pallas_interpret(P, m, nx,
                                                               plane, dtype):
    """Random face arrays: the flat read is the JAX padding with every left
    pad filled from the previous part."""
    rng = np.random.default_rng(P * m)
    arrays = [rng.standard_normal((P, m)).astype(dtype) for _ in range(7)]
    kw = dict(nx=nx, plane=plane, vdt=3.0)
    got = momentum_bands_plain(*(torch.as_tensor(a) for a in arrays), **kw)
    assert got.shape == (P, 7, m) and got.dtype == getattr(torch, dtype)
    for kernel in (False, True):
        want = _jax_ref(arrays, [True] * 7, kernel=kernel, **kw)
        np.testing.assert_array_equal(got.numpy(), want)


def _U(mesh, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((mesh.n_parts, mesh.n_cells, 3))


def test_flat_halo_read_at_part_edges():
    """On real face arrays (4 parts) the flat read equals the JAX wrapper's
    padding: zero pads for x/y, the previous part's top plane for z."""
    mesh = CavityMesh.cube(8, 4)
    nx, plane, m = mesh.nx, mesh.plane, mesh.n_cells
    arrays, kw = face_arrays(torch.as_tensor(_U(mesh, 0)), mesh=mesh, nu=NU,
                             dt=DT)
    phi_x, phi_y, phi_z, gx, gy, gz, _ = (a.numpy() for a in arrays)
    # the -1 read of a row's first cell and the -nx read of a plane's first
    # row land on cells without a +x / +y face: zero, as the zero pad
    i, j = np.arange(m) % nx, (np.arange(m) // nx) % mesh.ny
    for a in (phi_x, gx):
        assert (a[:, i == nx - 1] == 0).all()
    for a in (phi_y, gy):
        assert (a[:, j == mesh.ny - 1] == 0).all()
    # the -plane read of a part's first plane is the previous part's top
    # plane, which holds the faces between the parts
    for a in (phi_z, gz):
        flat = a.reshape(-1)
        for p in range(1, mesh.n_parts):
            np.testing.assert_array_equal(
                flat[p * m - plane: p * m], a[p - 1, -plane:])
        assert (a[:-1, -plane:] != 0).any()
    halos = [False, False, True, False, False, True, False]
    want = _jax_ref([a.numpy() for a in arrays], halos, **kw)
    np.testing.assert_array_equal(momentum_bands_plain(*arrays, **kw).numpy(),
                                  want)


def test_momentum_bands_matches_pallas():
    mesh = CavityMesh.cube(8, 2)
    U = _U(mesh, 5)
    reset_launch_counts()
    got = momentum_bands(torch.as_tensor(U), mesh=mesh, nu=NU, dt=DT)
    assert set(launch_counts().values()) == {0}
    want = np.asarray(momentum_bands_pallas(
        jnp.asarray(U), mesh=JaxMesh.cube(8, 2), nu=NU, dt=DT,
        block_rows=BLOCK_ROWS))
    assert got.shape == want.shape == (2, 7, mesh.n_cells)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("alpha", [1, 2, 4])
def test_momentum_bands_equal_assembly_then_update(alpha):
    """The port's two paths: fine assembly + the alpha-fusion update, and
    the on-device assembly on the coarse partition (tests/test_kernels.py's
    bar: 1e-12).  At alpha 1 the update is the solver's own."""
    fine = CavityMesh.cube(8, 4)
    coarse = fine.with_parts(4 // alpha)
    U = torch.as_tensor(_U(fine, 4))
    asm = CavityAssembly(fine, nu=NU, device="cpu")
    phi, phi_if = asm.face_flux(U)
    sysM = asm.assemble_momentum(U, phi, phi_if, torch.zeros(4, fine.n_cells),
                                 DT)
    ldu = (sysM.diag, sysM.upper, sysM.lower, sysM.iface)
    if alpha == 1:
        solver = PisoSolver(fine, alpha=1, nu=NU, device="cpu")
        bands_a = solver._bands(solver.plan_mom, *ldu)
    else:
        grouped = buffer_from_parts(*ldu).reshape(4 // alpha, alpha, -1)
        bands_a = update_device_direct(plan_for_mesh(fine, alpha), grouped)
    bands_b = momentum_bands(U.reshape(4 // alpha, coarse.n_cells, 3),
                             mesh=coarse, nu=NU, dt=DT)
    np.testing.assert_allclose(bands_b.numpy(), bands_a.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_momentum_bands_refuses_a_mismatched_mesh():
    with pytest.raises(ValueError, match="does not fit"):
        momentum_bands(torch.zeros(2, 10, 3), mesh=CavityMesh.cube(4, 2),
                       nu=NU, dt=DT)


def test_momentum_bands_cost_counts_bytes_once():
    c = momentum_bands_cost(9_261_000)
    assert c["bytes_accessed"] == 14 * 8 * 9_261_000
    assert momentum_bands_cost(100, itemsize=4)["bytes_accessed"] == 5600
