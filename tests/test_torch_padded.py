"""Size-class padding in the port against the JAX package, on the CPU.

The padded mesh's masks, patches and fingerprint exactly; the assembly's
``dynamic_masks`` (one lane and a cohort's) exactly; the ``gradp=``
momentum form and the pressure matrix under masks at 1e-12; a padded
solver's run at 1e-10 with identical counts (its ghost slabs exactly zero,
its real slabs bitwise the unpadded mesh's run); and the cohort view of the
assembly, each lane bitwise its assembly alone.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.repartition import mesh_fingerprint as jax_fingerprint
from repro.fvm.assembly import CavityAssembly as JaxAssembly
from repro.fvm.mesh import CavityMesh as JaxMesh
from repro.fvm.mesh import PaddedCavityMesh as JaxPadded
from repro.fvm.piso import PisoSolver as JaxPisoSolver

from repro_torch.core.repartition import mesh_fingerprint
from repro_torch.fvm.assembly import CavityAssembly
from repro_torch.fvm.mesh import CavityMesh, PaddedCavityMesh
from repro_torch.fvm.piso import PisoSolver
from repro_torch.interop import mesh_fields, mesh_from_fields

ASSEMBLY = 1e-12
PARITY = 1e-10
# (nx, nz per part, real parts, class)
PADS = [(4, 2, 2, 4), (4, 1, 3, 4), (3, 2, 1, 2), (4, 2, 4, 4)]


def _pair(nx, nzl, real, cls):
    mesh = CavityMesh(nx=nx, ny=nx, nz=nzl * real, n_parts=real, h=0.1 / nx)
    jmesh = JaxMesh(nx=nx, ny=nx, nz=nzl * real, n_parts=real, h=0.1 / nx)
    return PaddedCavityMesh.pad(mesh, cls), JaxPadded.pad(jmesh, cls)


@pytest.mark.parametrize("pad", PADS)
def test_padded_mesh_matches_jax(pad):
    mesh, jmesh = _pair(*pad)
    np.testing.assert_array_equal(mesh.iface_mask(), jmesh.iface_mask())
    np.testing.assert_array_equal(mesh.patch_mask(), jmesh.patch_mask())
    assert len(mesh.patches) == len(jmesh.patches)
    for a, b in zip(mesh.patches, jmesh.patches):
        assert (a.name, a.normal, a.only_part) == (b.name, b.normal,
                                                   b.only_part)
        np.testing.assert_array_equal(a.rows, b.rows)
    assert (mesh.n_parts_active, mesh.n_cells_active) == (
        jmesh.n_parts_active, jmesh.n_cells_active)
    assert mesh_fingerprint(mesh) == jax_fingerprint(jmesh)
    assert mesh_from_fields(mesh_fields(mesh)) == mesh


def test_pad_refuses_what_jax_refuses():
    mesh, _ = _pair(4, 2, 2, 4)
    for bad in (lambda: PaddedCavityMesh.pad(mesh, 8),
                lambda: PaddedCavityMesh.pad(CavityMesh.cube(4, 4), 2),
                lambda: PaddedCavityMesh(nx=4, ny=4, nz=8, n_parts=4,
                                         h=0.1, n_parts_real=0)):
        with pytest.raises(ValueError):
            bad()


def _assemblies(pad):
    mesh, jmesh = _pair(*pad)
    return (CavityAssembly(mesh, device="cpu"), JaxAssembly(jmesh), mesh)


@pytest.mark.parametrize("pad", PADS[:2])
def test_dynamic_masks_match_jax(pad):
    asm, jasm, mesh = _assemblies(pad)
    P = mesh.n_parts
    for n in range(P + 1):
        got = asm.dynamic_masks(n)
        want = jasm.dynamic_masks(jnp.asarray(n))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a cohort's masks: one lane after another
    ns = [P, 0, 1, P - 1]
    cohort = asm.lane_view(len(ns)).dynamic_masks(torch.tensor(ns))
    for k, g in enumerate(cohort):
        want = np.concatenate([np.asarray(jasm.dynamic_masks(
            jnp.asarray(n))[k]) for n in ns])
        np.testing.assert_array_equal(g.numpy(), want)
    # the static masks of a padded mesh are its dynamic ones at its size
    static = (asm.if_mask, asm.patch_mask)
    for s, d in zip(static, asm.dynamic_masks(mesh.n_parts_real)):
        assert torch.equal(s, d)


def _fields(mesh, seed):
    rng = np.random.default_rng(seed)
    P, m, F, B = mesh.n_parts, mesh.n_cells, mesh.n_faces, mesh.plane
    return {"U": rng.standard_normal((P, m, 3)),
            "phi": rng.standard_normal((P, F)),
            "phi_if": rng.standard_normal((P, 2, B)),
            "phi_b": rng.standard_normal((P, 2, B)),
            "p": rng.standard_normal((P, m))}


def _close(got, want, what):
    a, b = got.numpy(), np.asarray(want)
    assert a.shape == b.shape, what
    scale = max(float(np.abs(b).max()), 1e-300)
    assert float(np.abs(a - b).max()) <= ASSEMBLY * scale, what


@pytest.mark.parametrize("pad", PADS[:2])
@pytest.mark.parametrize("n_active", [1, 2])
def test_gradp_momentum_and_pressure_matrix_match_jax(pad, n_active):
    asm, jasm, mesh = _assemblies(pad)
    f = _fields(mesh, 3)
    t = {k: torch.tensor(v) for k, v in f.items()}
    j = {k: jnp.asarray(v) for k, v in f.items()}
    masks = asm.dynamic_masks(n_active)
    jmasks = jasm.dynamic_masks(jnp.asarray(n_active))
    a, ja = asm.with_masks(*masks), jasm.with_masks(*jmasks)
    dt = 2e-3
    g = a.grad(t["p"])
    _close(g, ja.grad(j["p"]), "grad")
    by_p = a.assemble_momentum(t["U"], t["phi"], t["phi_if"], t["p"], dt,
                               phi_b=t["phi_b"])
    by_g = a.assemble_momentum(t["U"], t["phi"], t["phi_if"], None, dt,
                               phi_b=t["phi_b"], gradp=g)
    want = ja.assemble_momentum(j["U"], j["phi"], j["phi_if"], None, dt,
                                phi_b=j["phi_b"], gradp=ja.grad(j["p"]))
    for name in ("diag", "upper", "lower", "iface", "source"):
        assert torch.equal(getattr(by_g, name), getattr(by_p, name)), name
        _close(getattr(by_g, name), getattr(want, name), name)
    rAU = a.V / by_g.diag
    sysP = a.assemble_pressure_matrix(rAU)
    jsys = ja.assemble_pressure_matrix(ja.V / want.diag)
    for name in ("diag", "upper", "lower", "iface", "g_int", "g_if", "g_b"):
        _close(getattr(sysP, name), getattr(jsys, name), name)


def test_lane_view_assembles_each_lane_as_alone():
    """Three lanes with different fields (and dt) through one cohort view:
    each lane's coefficients bitwise its assembly alone."""
    mesh = CavityMesh.cube(4, 2)
    asm = CavityAssembly(mesh, device="cpu")
    lanes = [_fields(mesh, s) for s in range(3)]
    dts = [1e-3, 2e-3, 3e-3]
    view = asm.lane_view(3)
    stacked = {k: torch.tensor(np.concatenate([f[k] for f in lanes]))
               for k in lanes[0]}
    dt = torch.tensor(dts, dtype=torch.float64).repeat_interleave(
        mesh.n_parts)
    got = view.assemble_momentum(stacked["U"], stacked["phi"],
                                 stacked["phi_if"], stacked["p"], dt,
                                 phi_b=stacked["phi_b"])
    gotP = view.assemble_pressure_matrix(view.V / got.diag)
    for i, (f, dti) in enumerate(zip(lanes, dts)):
        t = {k: torch.tensor(v) for k, v in f.items()}
        want = asm.assemble_momentum(t["U"], t["phi"], t["phi_if"], t["p"],
                                     dti, phi_b=t["phi_b"])
        wantP = asm.assemble_pressure_matrix(asm.V / want.diag)
        sl = slice(i * mesh.n_parts, (i + 1) * mesh.n_parts)
        for name in ("diag", "upper", "lower", "iface", "source"):
            assert torch.equal(getattr(got, name)[sl], getattr(want, name)), \
                name
        for name in ("diag", "upper", "g_if"):
            assert torch.equal(getattr(gotP, name)[sl],
                               getattr(wantP, name)), name


@pytest.fixture(scope="module")
def jax_padded_run():
    _, jmesh = _pair(4, 2, 2, 4)
    solver = JaxPisoSolver(jmesh, alpha=2, solver_backend="reference",
                           pipeline="off")
    state, stats = solver.run_steps(solver.initial_state(), 2e-3, 2)
    return ({f: np.asarray(getattr(state, f)) for f in state._fields},
            {f: np.asarray(getattr(stats, f)) for f in stats._fields})


def test_padded_solver_matches_jax_and_the_unpadded_mesh(jax_padded_run):
    state_j, stats_j = jax_padded_run
    mesh, _ = _pair(4, 2, 2, 4)
    solver = PisoSolver(mesh, alpha=2, device="cpu")
    assert solver.padded and solver.program.extra_keys == ("n_active",)
    assert solver._extras() == (2,) and solver._filler_extras() == (0,)
    state, stats = solver.run_steps(solver.initial_state(), 2e-3, 2)
    for f in state._fields:
        a, b = getattr(state, f).numpy(), state_j[f]
        assert float(np.abs(a - b).max()) <= PARITY * max(
            float(np.abs(b).max()), 1e-300), f
        # ghost slabs stay exactly zero
        assert not getattr(state, f)[2:].any(), f
    for f in ("mom_iters", "p_iters", "converged", "diverged", "hit_cap"):
        np.testing.assert_array_equal(getattr(stats, f).numpy(), stats_j[f])
    plain = PisoSolver(CavityMesh(nx=4, ny=4, nz=4, n_parts=2, h=0.025),
                       alpha=2, device="cpu")
    ref, ref_stats = plain.run_steps(plain.initial_state(), 2e-3, 2)
    for f in state._fields:
        assert torch.equal(getattr(state, f)[:2], getattr(ref, f)), f
    assert torch.equal(stats.p_iters, ref_stats.p_iters)
