"""The port's Krylov solvers against the JAX package's reference backend.

Same systems for both (``laplacian_buffers`` of ``tests/test_solvers.py``,
made with numpy), the JAX side on ``reference_ops``, the port on both of
its backends (on the CPU the fused backend runs the kernels' plain
versions).  The bar: identical iteration counts and flags, solutions within
1e-10.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.repartition import plan_for_mesh as jax_plan_for_mesh
from repro.core.update import update_device_direct as jax_update
from repro.fvm.mesh import CavityMesh as JaxMesh
from repro.solvers.bicgstab import bicgstab as jax_bicgstab
from repro.solvers.cg import cg as jax_cg
from repro.solvers.jacobi import jacobi_preconditioner as jax_jacobi
from repro.solvers.ops import reference_ops as jax_reference_ops
from repro.sparse.distributed import spmv_dia as jax_spmv_dia

from repro_torch.core.repartition import plan_for_mesh
from repro_torch.core.update import update_device_direct
from repro_torch.fvm.mesh import CavityMesh
from repro_torch.solvers.bicgstab import bicgstab
from repro_torch.solvers.cg import cg
from repro_torch.solvers.jacobi import jacobi_preconditioner
from repro_torch.solvers.ops import (fused_stacked_ops, reference_ops,
                                     resolve_backend)
from repro_torch.sparse.distributed import spmv_dia

from test_solvers import laplacian_buffers

PARITY = 1e-10


def _systems(alpha: int, skew: bool):
    """(JAX ops, {port backend: ops}, b as numpy) for one laplacian system
    on cube(4, 4) fused by ``alpha``; ``skew`` halves the upper band (a
    non-symmetric, convection-like matrix for BiCGStab)."""
    mesh = JaxMesh.cube(4, 4)
    layout, buffers, diag = laplacian_buffers(mesh)
    buffers = np.array(buffers)
    if skew:
        buffers[:, layout.segments()["upper"]] *= 0.5
    n_c = mesh.n_parts // alpha
    rng = np.random.default_rng(7)
    b = rng.standard_normal(mesh.n_cells_global).reshape(n_c, -1)

    plan_j = jax_plan_for_mesh(mesh, alpha)
    offsets = tuple(int(o) for o in plan_j.dia_offsets)
    bands_j = jax_update(plan_j, jnp.asarray(buffers).reshape(n_c, alpha, -1))
    diag_j = jnp.asarray(diag).reshape(n_c, -1)
    ops_j = jax_reference_ops(
        lambda v: jax_spmv_dia(bands_j, v, offsets=offsets,
                               plane=plan_j.plane), jax_jacobi(diag_j))

    plan = plan_for_mesh(CavityMesh.cube(4, 4), alpha)
    bands = update_device_direct(
        plan, torch.as_tensor(buffers).reshape(n_c, alpha, -1))
    diag_t = torch.as_tensor(diag).reshape(n_c, -1)
    ops_t = {
        "reference": reference_ops(
            lambda v: spmv_dia(bands, v, offsets=offsets, plane=plan.plane),
            jacobi_preconditioner(diag_t)),
        "fused": fused_stacked_ops(bands, diag_t, offsets=offsets,
                                   plane=plan.plane),
    }
    return ops_j, ops_t, b


def _assert_same(res_t, res_j):
    assert res_t.iters == int(res_j.iters)
    assert res_t.converged == bool(res_j.converged)
    assert res_t.hit_cap == bool(res_j.hit_cap)
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x),
                               rtol=0, atol=PARITY)


SOLVERS = [(cg, jax_cg, False), (bicgstab, jax_bicgstab, True)]


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("alpha", [1, 2, 4])
@pytest.mark.parametrize("solver,jax_solver,skew", SOLVERS)
def test_solver_matches_jax_reference(solver, jax_solver, skew, alpha,
                                      backend):
    ops_j, ops_t, b = _systems(alpha, skew)
    res_j = jax_solver(ops_j, jnp.asarray(b), jnp.zeros_like(jnp.asarray(b)),
                       tol=1e-10, maxiter=500)
    res_t = solver(ops_t[backend], torch.as_tensor(b),
                   torch.zeros(b.shape, dtype=torch.float64), tol=1e-10,
                   maxiter=500)
    assert res_t.converged and not res_t.hit_cap
    _assert_same(res_t, res_j)
    assert float(res_t.residual) == pytest.approx(float(res_j.residual),
                                                  rel=1e-6)


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("solver,jax_solver,skew", SOLVERS)
def test_forced_cap_reports_hit_cap(solver, jax_solver, skew, backend):
    ops_j, ops_t, b = _systems(2, skew)
    res_j = jax_solver(ops_j, jnp.asarray(b), jnp.zeros_like(jnp.asarray(b)),
                       tol=1e-14, maxiter=2)
    res_t = solver(ops_t[backend], torch.as_tensor(b),
                   torch.zeros(b.shape, dtype=torch.float64), tol=1e-14,
                   maxiter=2)
    assert res_t.iters == 2 and res_t.hit_cap and not res_t.converged
    assert np.isfinite(float(res_t.residual))
    _assert_same(res_t, res_j)


@pytest.mark.parametrize("solver,jax_solver", [(cg, jax_cg),
                                               (bicgstab, jax_bicgstab)])
def test_nan_rhs_signature(solver, jax_solver):
    """A NaN rhs: 0 iterations, converged and hit_cap both False."""
    b = np.ones((2, 32))
    b[0, 0] = np.nan
    res_j = jax_solver(lambda v: 2.0 * v, jnp.asarray(b),
                       jnp.zeros_like(jnp.asarray(b)), tol=1e-10)
    res_t = solver(lambda v: 2.0 * v, torch.as_tensor(b),
                   torch.zeros((2, 32), dtype=torch.float64), tol=1e-10)
    assert res_t.iters == 0 == int(res_j.iters)
    assert not res_t.converged and not res_t.hit_cap
    assert not bool(res_j.converged) and not bool(res_j.hit_cap)


@pytest.mark.parametrize("case", ["b_zero", "identity", "rotation"])
def test_bicgstab_breakdown_guards_match_jax(case):
    """The breakdown guards: b = 0, an exact first half-step (A = I) and
    a serious Lanczos breakdown (a rotation) end as the JAX solver ends."""
    rng = np.random.default_rng(7)
    if case == "b_zero":
        b, x0, R = np.zeros((1, 8)), np.ones((1, 8)), np.eye(8)
    elif case == "identity":
        b, x0, R = rng.standard_normal((1, 16)), np.zeros((1, 16)), np.eye(16)
    else:
        b, x0 = np.array([[1.0, 0.0]]), np.zeros((1, 2))
        R = np.array([[0.0, 1.0], [-1.0, 0.0]])
    R_j, R_t = jnp.asarray(R), torch.as_tensor(R)
    res_j = jax_bicgstab(lambda v: v @ R_j.T, jnp.asarray(b),
                         jnp.asarray(x0), tol=1e-12, maxiter=50)
    res_t = bicgstab(lambda v: v @ R_t.T, torch.as_tensor(b),
                     torch.as_tensor(x0), tol=1e-12, maxiter=50)
    assert np.isfinite(res_t.x.numpy()).all()
    _assert_same(res_t, res_j)


def test_resolve_backend():
    assert resolve_backend("auto", "cpu") == "reference"
    assert resolve_backend("auto", "cuda") == "fused"
    assert resolve_backend("fused", "cpu") == "fused"
    with pytest.raises(ValueError):
        resolve_backend("pallas", "cpu")
