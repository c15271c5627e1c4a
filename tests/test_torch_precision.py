"""The port's mixed-precision refinement against the JAX package, on the CPU.

The refined policies (``f32_ir``, ``bf16_ir``) run the Krylov inner sweeps
at the storage dtype inside an outer f64 loop.  JAX runs its reference
backend (``_refined_reference_ops`` of ``tests/test_solvers.py``;
``solver_backend="reference"``, ``pipeline="off"`` for the PISO runs); the
port runs both of its backends (on the CPU the fused backend runs the
kernels' plain versions).

The bar: the refined answers within 1e-10 of JAX's and of the port's own
f64 answer, equal flags.  The two libraries sum their float32 and bfloat16
dots in different orders (and the port's fused backend accumulates each
bfloat16 SpMV row in float32, as its kernels do, where JAX's reference
accumulates in bfloat16), so an inner sweep may take another path through
the same tolerance: counts are held equal where they came out equal and
otherwise within the stated slack.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.repartition import plan_for_mesh as jax_plan_for_mesh
from repro.core.update import update_device_direct as jax_update
from repro.fvm.mesh import CavityMesh as JaxMesh
from repro.fvm.piso import PisoSolver as JaxPisoSolver
from repro.solvers.bicgstab import bicgstab as jax_bicgstab
from repro.solvers.cg import cg as jax_cg
from repro.solvers.ops import reference_ops as jax_reference_ops
from repro.solvers.precision import get_policy as jax_get_policy

from repro_torch.core.repartition import plan_for_mesh
from repro_torch.core.update import update_device_direct
from repro_torch.fvm.mesh import CavityMesh
from repro_torch.fvm.piso import PisoSolver, PisoState
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.solvers.bicgstab import bicgstab
from repro_torch.solvers.cg import cg
from repro_torch.solvers.jacobi import jacobi_preconditioner
from repro_torch.solvers.ops import fused_stacked_ops, reference_ops
from repro_torch.solvers.precision import POLICIES, get_policy
from repro_torch.sparse.distributed import spmv_dia

from helpers import global_dense
from test_solvers import _refined_reference_ops, laplacian_buffers

PARITY = 1e-10
REFINED = ("f32_ir", "bf16_ir")
BACKENDS = ("reference", "fused")
# solver level (cube(4, 4), tol 1e-12): inner totals differ by at most
# this many iterations (measured: 0 or 1)
INNER_SLACK = 2
# PISO level (cube(8, 4), 3 steps, tol 1e-12): a pressure solve's inner
# total within this share of JAX's (measured: up to 17 of 127, when one
# side needs one more outer pass than the other)
P_ITERS_REL_SLACK = 0.25
DT = 2e-4


# ---------------------------------------------------------------------------
# the solvers
# ---------------------------------------------------------------------------

def _port_ops(policy, backend, bands, diag, offsets, plane):
    """The bundle ``PisoSolver._solver_ops`` builds for ``backend``."""
    pol = get_policy(policy)
    if backend == "fused":
        return fused_stacked_ops(bands, diag, offsets=offsets, plane=plane,
                                 policy=pol)
    if not pol.refine:
        return reference_ops(
            lambda v: spmv_dia(bands, v, offsets=offsets, plane=plane),
            jacobi_preconditioner(diag))
    bands_lo = bands.to(pol.storage_dtype)
    diag_lo = diag.to(pol.storage_dtype)
    return reference_ops(
        lambda v: spmv_dia(bands_lo, v, offsets=offsets, plane=plane),
        jacobi_preconditioner(diag_lo), policy=pol,
        matvec_hi=lambda v: spmv_dia(bands, v, offsets=offsets, plane=plane))


@pytest.fixture(scope="module")
def spd_system():
    """``tests/test_solvers.py``'s refined-policy system (cube(4, 4),
    alpha 2, a normalised rhs of a known solution) for both libraries,
    with JAX's answer per (solver, policy)."""
    mesh = JaxMesh.cube(4, 4)
    layout, buffers, diag = laplacian_buffers(mesh)
    A_dense = global_dense(layout, buffers)
    n_c = mesh.n_parts // 2
    plan_j = jax_plan_for_mesh(mesh, 2)
    bands_j = jax_update(plan_j, jnp.asarray(buffers).reshape(n_c, 2, -1),
                         target="dia")
    offsets = tuple(int(o) for o in plan_j.dia_offsets)
    diag_j = jnp.asarray(diag).reshape(n_c, plan_j.m_coarse)
    rng = np.random.default_rng(11)
    x_true = rng.standard_normal(mesh.n_cells_global)
    b = (A_dense @ x_true).reshape(n_c, plan_j.m_coarse)
    b = b / np.linalg.norm(b)

    jax_res = {}
    for name, solver in (("cg", jax_cg), ("bicgstab", jax_bicgstab)):
        for pol in ("f64",) + REFINED:
            ops = _refined_reference_ops(pol, bands_j, diag_j, offsets,
                                         plan_j.plane)
            jax_res[name, pol] = solver(ops, jnp.asarray(b),
                                        jnp.zeros_like(jnp.asarray(b)),
                                        tol=1e-12, maxiter=500)

    plan = plan_for_mesh(CavityMesh.cube(4, 4), 2)
    bands = update_device_direct(
        plan, torch.as_tensor(np.asarray(buffers)).reshape(n_c, 2, -1))
    return {"bands": bands, "diag": torch.tensor(np.asarray(diag_j)),
            "offsets": offsets, "plane": plan.plane,
            "b": torch.as_tensor(b), "jax": jax_res}


SOLVERS = {"cg": cg, "bicgstab": bicgstab}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("policy", REFINED)
@pytest.mark.parametrize("name", ["cg", "bicgstab"])
def test_refined_solver_matches_jax(name, policy, backend, spd_system):
    s = spd_system
    args = (s["bands"], s["diag"], s["offsets"], s["plane"])
    b, x0 = s["b"], torch.zeros_like(s["b"])
    reset_launch_counts()
    res = SOLVERS[name](_port_ops(policy, backend, *args), b, x0, tol=1e-12,
                        maxiter=500)
    res64 = SOLVERS[name](_port_ops("f64", backend, *args), b, x0,
                          tol=1e-12, maxiter=500)
    assert set(launch_counts().values()) == {0}  # the CPU runs no kernel
    res_j = s["jax"][name, policy]
    assert res.x.dtype == torch.float64
    assert res.converged and not res.hit_cap
    assert res.converged == bool(res_j.converged)
    assert res.hit_cap == bool(res_j.hit_cap)
    assert res.outer_iters >= 1 and res64.outer_iters == 0
    np.testing.assert_allclose(res.x.numpy(), np.asarray(res_j.x), rtol=0,
                               atol=PARITY)
    np.testing.assert_allclose(res.x.numpy(), res64.x.numpy(), rtol=0,
                               atol=PARITY)
    # the correction sweeps really ran at low precision: more inner
    # iterations in all than the straight f64 solve
    assert res.iters >= res64.iters
    # counts: the same arithmetic widths as JAX's reference give the same
    # number of outer passes; the fused backend's float32 row sums under
    # bfloat16 storage may end one pass apart
    outer_slack = 1 if (backend, policy) == ("fused", "bf16_ir") else 0
    assert abs(res.outer_iters - int(res_j.outer_iters)) <= outer_slack
    assert abs(res.iters - int(res_j.iters)) <= INNER_SLACK


@pytest.mark.parametrize("policy", REFINED)
@pytest.mark.parametrize("name", ["cg", "bicgstab"])
def test_refined_nan_rhs_signature(name, policy):
    """A NaN rhs stops the outer loop at once: 0 inner and 0 outer
    iterations, converged and hit_cap both False — as in JAX."""
    b = np.ones((2, 32))
    b[0, 0] = np.nan
    op_j = lambda v: 2.0 * v  # noqa: E731
    res_j = {"cg": jax_cg, "bicgstab": jax_bicgstab}[name](
        jax_reference_ops(op_j, policy=jax_get_policy(policy),
                          matvec_hi=op_j),
        jnp.asarray(b), jnp.zeros((2, 32)), tol=1e-10)
    op = lambda v: 2.0 * v  # noqa: E731
    res = SOLVERS[name](reference_ops(op, policy=policy, matvec_hi=op),
                        torch.as_tensor(b),
                        torch.zeros((2, 32), dtype=torch.float64), tol=1e-10)
    assert res.iters == 0 == int(res_j.iters)
    assert res.outer_iters == 0 == int(res_j.outer_iters)
    assert not res.converged and not res.hit_cap
    assert not bool(res_j.converged) and not bool(res_j.hit_cap)


@pytest.mark.parametrize("name", ["cg", "bicgstab"])
def test_refined_inner_cap_reports_hit_cap(name, spd_system):
    """An inner sweep that stops at ``maxiter`` raises ``hit_cap`` once the
    outer loop gives up unconverged, as JAX's flags say."""
    s = spd_system
    args = (s["bands"], s["diag"], s["offsets"], s["plane"])
    res = SOLVERS[name](_port_ops("f32_ir", "reference", *args), s["b"],
                        torch.zeros_like(s["b"]), tol=1e-12, maxiter=1)
    pol = get_policy("f32_ir")
    assert not res.converged and res.hit_cap
    assert res.outer_iters == pol.max_outer and res.iters == pol.max_outer


def test_fused_bundle_downcasts_once_and_replays_in_f64(spd_system):
    s = spd_system
    seen = []
    for name, pol in POLICIES.items():
        ops = fused_stacked_ops(s["bands"], s["diag"], offsets=s["offsets"],
                                plane=s["plane"], policy=pol)
        x = s["b"].to(pol.storage_dtype)
        y = ops.matvec(x)
        assert y.dtype == pol.storage_dtype and ops.policy is pol
        _, pAp = ops.matvec_dot(x)
        assert pAp.dtype == pol.accum_dtype
        assert (ops.matvec_hi is None) == (not pol.refine)
        if pol.refine:
            y_hi = ops.matvec_hi(s["b"])
            assert y_hi.dtype == torch.float64
            assert torch.equal(y_hi, spmv_dia(s["bands"], s["b"],
                                              offsets=s["offsets"],
                                              plane=s["plane"]))
        seen.append(name)
    assert seen == ["f64", "f32_ir", "bf16_ir"]


# ---------------------------------------------------------------------------
# PISO under a policy
# ---------------------------------------------------------------------------

def _jax_numpy(tree):
    return {f: np.asarray(getattr(tree, f)) for f in tree._fields}


@pytest.fixture(scope="module")
def jax_f32_runs():
    """{alpha: (final state, stats)} of JAX's f32_ir cavity, 3 steps."""
    out = {}
    for alpha in (1, 2, 4):
        solver = JaxPisoSolver(JaxMesh.cube(8, 4), alpha=alpha,
                               precision="f32_ir", mom_tol=1e-12,
                               p_tol=1e-12, solver_backend="reference",
                               pipeline="off")
        state, stats = solver.run(3, DT)
        out[alpha] = (_jax_numpy(state), _jax_numpy(stats))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("alpha", [1, 2, 4])
def test_piso_f32_ir_matches_jax(alpha, backend, jax_f32_runs):
    """Tolerances 1e-12 on both solves, so that the parity is not the
    solver tolerance."""
    state_j, stats_j = jax_f32_runs[alpha]
    solver = PisoSolver(CavityMesh.cube(8, 4), alpha=alpha,
                        precision="f32_ir", mom_tol=1e-12, p_tol=1e-12,
                        solver_backend=backend, device="cpu")
    state, stats = solver.run(3, DT)
    for f in PisoState._fields:
        a, b = getattr(state, f).numpy(), state_j[f]
        scale = max(float(np.abs(b).max()), 1e-300)
        assert float(np.abs(a - b).max()) <= PARITY * scale, f
    for f in ("converged", "diverged", "hit_cap"):
        np.testing.assert_array_equal(getattr(stats, f).numpy(), stats_j[f])
    assert bool(stats.converged.all())
    np.testing.assert_array_equal(stats.mom_iters.numpy(),
                                  stats_j["mom_iters"])
    p_t, p_j = stats.p_iters.numpy(), stats_j["p_iters"]
    assert (np.abs(p_t - p_j) <= P_ITERS_REL_SLACK * p_j).all(), (p_t, p_j)


def test_precision_is_read_at_every_solve():
    """One solver, three policies in turn from one state: each refined
    step lands within 1e-10 of the f64 step (tolerances 1e-12)."""
    solver = PisoSolver(CavityMesh.cube(4, 2), alpha=2, mom_tol=1e-12,
                        p_tol=1e-12, device="cpu")
    state0 = solver.initial_state()
    steps = {}
    for pol in ("f64", "f32_ir", "f64"):
        solver.precision = pol
        steps.setdefault(pol, []).append(solver.step(state0, DT))
    (s64a, t64a), (s64b, t64b) = steps["f64"]
    assert all(torch.equal(a, b) for a, b in zip(s64a, s64b))
    s32, t32 = steps["f32_ir"][0]
    assert bool(t32.converged)
    for f in PisoState._fields:
        a, b = getattr(s32, f), getattr(s64a, f)
        assert float((a - b).abs().max()) <= PARITY * max(
            float(b.abs().max()), 1e-300), f
    with pytest.raises(ValueError, match="precision"):
        PisoSolver(CavityMesh.cube(4, 2), alpha=2, precision="f16",
                   device="cpu")


def test_bf16_ir_cavity_diverges_as_in_jax():
    """The all-Neumann cavity pressure (pinned by one reference cell) has
    low modes that bf16-rounded bands do not keep: JAX's reference
    diverges to NaN in the first step, and so does the port on both
    backends — diverged True, converged False, no cap."""
    jax_solver = JaxPisoSolver(JaxMesh.cube(8, 4), alpha=2,
                               precision="bf16_ir",
                               solver_backend="reference", pipeline="off")
    _, stats_j = jax_solver.run(1, DT)
    assert bool(stats_j.diverged[0]) and not bool(stats_j.converged[0])
    assert not bool(stats_j.hit_cap[0])
    for backend in BACKENDS:
        solver = PisoSolver(CavityMesh.cube(8, 4), alpha=2,
                            precision="bf16_ir", solver_backend=backend,
                            device="cpu")
        _, stats = solver.run(1, DT)
        assert bool(stats.diverged[0]), backend
        assert not bool(stats.converged[0]) and not bool(stats.hit_cap[0])


@pytest.mark.parametrize("backend", BACKENDS)
def test_bf16_ir_channel_converges(backend):
    """With a Dirichlet outlet the bf16 sweeps converge: the channel is
    where bf16_ir runs.  Within the solver tolerance of the f64 run."""
    runs = {}
    for pol in ("f64", "bf16_ir"):
        solver = PisoSolver(CavityMesh.cube(8, 4), alpha=2, case="channel",
                            precision=pol, solver_backend=backend,
                            device="cpu")
        runs[pol] = solver.run(2, DT)
    (s64, _), (s16, t16) = runs["f64"], runs["bf16_ir"]
    assert bool(t16.converged.all()) and not bool(t16.hit_cap.any())
    assert float(t16.continuity_err.max()) < 1e-6
    # both solves stop at p_tol 1e-8 / mom_tol 1e-7 of their own paths
    assert float((s16.U - s64.U).abs().max()) <= 1e-6 * float(
        s64.U.abs().max())


def test_bf16_ir_channel_at_the_main_path_settings_fails_as_in_jax():
    """At the 210^3 run's settings (dt = 0.5 h, p_tol 1e-10, p_maxiter
    6000) bf16_ir does not converge on the channel at 16^3 either: JAX's
    reference ends its first step diverged (NaN in the second pressure
    solve), and so does the port on both backends.  bfloat16 bands leave
    the refinement no contraction once eps * cond(A) passes 1."""
    kw = dict(alpha=4, case="channel", precision="bf16_ir", p_tol=1e-10,
              p_maxiter=6000)
    dt = 0.5 * CavityMesh.cube(16, 4).h  # the launcher's Co 0.5
    _, stats_j = JaxPisoSolver(JaxMesh.cube(16, 4), solver_backend="reference",
                               pipeline="off", **kw).run(1, dt)
    assert bool(stats_j.diverged[0]) and not bool(stats_j.converged[0])
    for backend in BACKENDS:
        _, stats = PisoSolver(CavityMesh.cube(16, 4), solver_backend=backend,
                              device="cpu", **kw).run(1, dt)
        assert bool(stats.diverged[0]), backend
        assert not bool(stats.converged[0]) and not bool(stats.hit_cap[0])


def test_port_policy_table_is_the_references():
    from repro.solvers.precision import POLICIES as JAX_POLICIES

    assert tuple(POLICIES) == tuple(JAX_POLICIES)
    for name, pol in POLICIES.items():
        ref = JAX_POLICIES[name]
        for f in ("storage", "accum", "storage_itemsize", "accum_itemsize",
                  "refine", "inner_tol", "max_outer"):
            assert getattr(pol, f) == getattr(ref, f), (name, f)
