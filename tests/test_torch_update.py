"""The port's value update (coef_update kernel module, core/update.py, the
ELL target, UpdaterPool, rebind_alpha) against the JAX package, on the CPU.

JAX runs its Pallas ``coef_update_single`` in interpret mode and its
``ref.py`` oracle; the port runs its wrappers, which on CPU tensors take the
plain version.  A gather does no arithmetic, so every value comparison is
exact; SpMV comparisons are held to 1e-12 and PISO steps to the port's
parity bar (1e-10 of each field's max, identical counts and flags).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.repartition import plan_for_mesh as jax_plan_for_mesh
from repro.core import update as jax_update
from repro.fvm.mesh import CavityMesh as JaxMesh
from repro.fvm.piso import PisoSolver as JaxPisoSolver
from repro.kernels.coef_update.coef_update import coef_update_single
from repro.kernels.coef_update.ops import coef_update_pallas
from repro.kernels.coef_update.ref import coef_update_ref
from repro.sparse.distributed import spmv_ell as jax_spmv_ell

from repro_torch.core import update
from repro_torch.core.repartition import RepartitionPlan, plan_for_mesh
from repro_torch.fvm.mesh import CavityMesh
from repro_torch.fvm.piso import PisoSolver, PisoState
from repro_torch.interop import plan_from_numpy, state_from_numpy
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.coef_update import (coef_update, coef_update_plain,
                                             coef_update_stacked)
from repro_torch.sparse.distributed import spmv_dia, spmv_ell

ALPHAS = (1, 2, 4)
TARGETS = ("dia", "ell")
PARITY = 1e-10
DT = 2e-4


def _gather_operands(n_buf, n_out, seed):
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal(n_buf + 1)
    buf[-1] = 0.0
    src = rng.integers(0, n_buf + 1, n_out).astype(np.int32)
    src[:: 7] = n_buf  # the sentinel slot, the last one
    return buf, src


@pytest.mark.parametrize("n_buf,n_out,block", [
    (1000, 4096, 512), (5000, 8192, 1024), (1000, 777, 256)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_coef_update_plain_matches_pallas_interpret_and_ref(n_buf, n_out,
                                                            block, dtype):
    buf, src = _gather_operands(n_buf, n_out, seed=n_out)
    # the TPU kernel takes n_out % block == 0: pad with the sentinel
    pad = (-n_out) % block
    src_pad = np.concatenate([src, np.full(pad, n_buf, np.int32)])
    buf_j = jnp.asarray(buf, getattr(jnp, dtype))
    want_k = np.asarray(coef_update_single(buf_j, jnp.asarray(src_pad),
                                           block=block, interpret=True))
    want_r = np.asarray(coef_update_ref(buf_j, jnp.asarray(src)))
    np.testing.assert_array_equal(want_k[:n_out], want_r)
    got = coef_update_plain(torch.as_tensor(buf).to(getattr(torch, dtype))
                            [None], torch.as_tensor(src))
    assert got.shape == (1, n_out) and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got[0].numpy(), want_r)


def _grouped_buffers(plan, n_parts, seed):
    """Random per-fine-part buffers (n_coarse, alpha, L) as numpy."""
    rng = np.random.default_rng(seed)
    buffers = rng.standard_normal((n_parts, plan.buffer_len))
    return buffers.reshape(n_parts // plan.alpha, plan.alpha, -1)


@pytest.mark.parametrize("alpha", ALPHAS)
def test_update_paths_match_jax(alpha):
    """coef_update, dia/ell_values and both schedules, per target."""
    plan = plan_for_mesh(CavityMesh.cube(8, 4), alpha)
    plan_j = jax_plan_for_mesh(JaxMesh.cube(8, 4), alpha)
    grouped = _grouped_buffers(plan, 4, seed=alpha)
    buf_cat = update.concat_group_buffers(torch.as_tensor(grouped))
    buf_cat_j = jax_update.concat_group_buffers(jnp.asarray(grouped))
    np.testing.assert_array_equal(buf_cat.numpy(), np.asarray(buf_cat_j))
    values = {"dia": update.dia_values, "ell": update.ell_values}
    values_j = {"dia": jax_update.dia_values, "ell": jax_update.ell_values}
    for target in TARGETS:
        want = np.asarray(values_j[target](plan_j, buf_cat_j))
        got = coef_update(plan, buf_cat, target)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(coef_update_pallas(plan_j, buf_cat_j,
                                                       target, block=256)))
        np.testing.assert_array_equal(values[target](plan, buf_cat).numpy(),
                                      want)
        for name in ("update_device_direct", "update_host_buffer"):
            got = getattr(update, name)(plan, torch.as_tensor(grouped),
                                        target)
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(getattr(jax_update, name)(
                    plan_j, jnp.asarray(grouped), target)))


def test_device_index_is_int32_and_copied_once():
    plan = plan_for_mesh(CavityMesh.cube(8, 4), 2)
    for target, host in (("dia", plan.dia_src), ("ell", plan.ell_src)):
        src = plan.src_on("cpu", target)
        assert src.dtype == torch.int32 and src.dim() == 1
        np.testing.assert_array_equal(src.numpy(), host.reshape(-1))
        assert plan.src_on(torch.device("cpu"), target) is src
    cols = plan.ell_cols_on("cpu")
    np.testing.assert_array_equal(cols.numpy(), plan.ell_cols.reshape(-1))
    assert plan.ell_cols_on("cpu") is cols


def test_int32_index_bound_is_enforced():
    """A buffer of 2^31 entries or more cannot take int32 indices."""
    big = RepartitionPlan(
        alpha=2 ** 16, m_fine=1, m_coarse=2 ** 16, plane=1,
        buffer_len=2 ** 15, dia_offsets=np.zeros(1, np.int32),
        dia_src=np.zeros((1, 1), np.int64), nnz_local=0, nnz_localized=0,
        nnz_halo=0)
    with pytest.raises(ValueError, match="int32"):
        big.src_on("cpu")
    fits = plan_for_mesh(CavityMesh.cube(4, 2), 2)
    with pytest.raises(ValueError, match="staged buffers"):
        coef_update(fits, torch.zeros((1, fits.sentinel)))
    with pytest.raises(ValueError, match="target"):
        coef_update(fits, torch.zeros((1, fits.sentinel + 1)), "csr")


@pytest.mark.parametrize("alpha", ALPHAS)
def test_spmv_ell_matches_dia_and_jax(alpha):
    plan = plan_for_mesh(CavityMesh.cube(8, 4), alpha)
    plan_j = jax_plan_for_mesh(JaxMesh.cube(8, 4), alpha)
    grouped = _grouped_buffers(plan, 4, seed=10 + alpha)
    n_c = grouped.shape[0]
    x = np.random.default_rng(20 + alpha).standard_normal(
        (n_c, plan.m_coarse))
    buf_cat = update.concat_group_buffers(torch.as_tensor(grouped))
    x_t = torch.as_tensor(x)
    y_ell = spmv_ell(update.ell_values(plan, buf_cat),
                     plan.ell_cols_on("cpu"), x_t, plane=plan.plane)
    y_dia = spmv_dia(update.dia_values(plan, buf_cat), x_t,
                     offsets=tuple(int(o) for o in plan.dia_offsets),
                     plane=plan.plane)
    buf_cat_j = jax_update.concat_group_buffers(jnp.asarray(grouped))
    y_j = np.asarray(jax_spmv_ell(jax_update.ell_values(plan_j, buf_cat_j),
                                  jnp.asarray(plan_j.ell_cols),
                                  jnp.asarray(x), plane=plan_j.plane))
    scale = float(np.abs(y_j).max())
    assert float(np.abs(y_ell.numpy() - y_dia.numpy()).max()) <= 1e-12 * scale
    assert float(np.abs(y_ell.numpy() - y_j).max()) <= 1e-12 * scale


def test_plan_from_numpy_carries_the_ell_target():
    plan_j = jax_plan_for_mesh(JaxMesh.cube(8, 4), 2)
    fields = ("alpha", "m_fine", "m_coarse", "plane", "buffer_len",
              "nnz_local", "nnz_localized", "nnz_halo", "K", "dia_offsets",
              "dia_src", "ell_cols", "ell_src")
    rebuilt = plan_from_numpy({f: getattr(plan_j, f) for f in fields})
    assert rebuilt.layout is None and rebuilt.K == plan_j.K
    np.testing.assert_array_equal(rebuilt.ell_cols, plan_j.ell_cols)
    np.testing.assert_array_equal(rebuilt.ell_src, plan_j.ell_src)
    grouped = _grouped_buffers(rebuilt, 4, seed=3)
    np.testing.assert_array_equal(
        update.update_device_direct(rebuilt, torch.as_tensor(grouped),
                                    "ell").numpy(),
        np.asarray(jax_update.update_device_direct(
            plan_j, jnp.asarray(grouped), "ell")))
    dia_only = plan_from_numpy({f: getattr(plan_j, f) for f in fields[:-2]})
    with pytest.raises(ValueError, match="no layout"):
        dia_only.ell_src


def test_updater_pool_hits_and_misses_as_jax():
    """The sequence of tests/test_controller.py's pool test."""
    pool = update.UpdaterPool()
    mesh = CavityMesh.cube(4, 4)
    plan_a = plan_for_mesh(mesh, 2)
    plan_b = plan_for_mesh(CavityMesh.cube(4, 4), 2)  # equal-shape plan
    assert update.plan_shape_signature(plan_a) == \
        update.plan_shape_signature(plan_b)
    pool.updater(plan_a)
    assert (pool.hits, pool.misses) == (0, 1)
    pool.updater(plan_b)
    assert (pool.hits, pool.misses) == (1, 1), \
        "equal-shape plans must share one pool entry"
    pool.updater(plan_for_mesh(mesh, 4))  # different shape → new entry
    assert pool.misses == 2
    # the JAX pool keys the same way
    pool_j = jax_update.UpdaterPool()
    mesh_j = JaxMesh.cube(4, 4)
    for a in (2, 2, 4):
        pool_j.updater(jax_plan_for_mesh(mesh_j, a))
    assert (pool_j.hits, pool_j.misses) == (pool.hits, pool.misses)


@pytest.mark.parametrize("schedule", ["device_direct", "host_buffer"])
@pytest.mark.parametrize("target", TARGETS)
def test_pooled_updater_matches_direct_update(schedule, target):
    """Pooled updates equal the plain ones; a hit reuses the output."""
    pool = update.UpdaterPool()
    plan_a = plan_for_mesh(CavityMesh.cube(4, 4), 2)
    plan_b = plan_for_mesh(CavityMesh.cube(4, 4), 2)
    direct = {"device_direct": update.update_device_direct,
              "host_buffer": update.update_host_buffer}[schedule]
    outs = []
    for seed, plan in enumerate((plan_a, plan_b)):
        grouped = torch.as_tensor(_grouped_buffers(plan, 4, seed=seed))
        got = pool.updater(plan, target, schedule)(grouped)
        assert torch.equal(got, direct(plan, grouped, target))
        outs.append(got.data_ptr())
    assert outs[0] == outs[1], "a pool hit must reuse the output buffer"
    with pytest.raises(ValueError, match="schedule"):
        pool.updater(plan_a, target, "broadcast")


def test_update_on_cpu_launches_nothing():
    plan = plan_for_mesh(CavityMesh.cube(4, 2), 2)
    grouped = torch.as_tensor(_grouped_buffers(plan, 2, seed=0))
    reset_launch_counts()
    update.update_device_direct(plan, grouped)
    coef_update_stacked(update.concat_group_buffers(grouped[:, 0]),
                        torch.zeros(3, dtype=torch.int32))
    assert set(launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# rebind_alpha
# ---------------------------------------------------------------------------

def _assert_step_matches(state, stats, state_j, stats_j):
    for f in PisoState._fields:
        a, b = getattr(state, f).numpy(), np.asarray(getattr(state_j, f))
        scale = max(float(np.abs(b).max()), 1e-300)
        assert float(np.abs(a - b).max()) <= PARITY * scale, f
    for f in ("mom_iters", "p_iters", "converged", "diverged", "hit_cap"):
        np.testing.assert_array_equal(getattr(stats, f).numpy(),
                                      np.asarray(getattr(stats_j, f)),
                                      err_msg=f)


def test_rebind_alpha_steps_match_jax():
    """alpha 4 → 2 → 4 between steps, each step held against JAX doing the
    same; revisiting alpha 4 reuses its plan, index and program."""
    solver_j = JaxPisoSolver(JaxMesh.cube(8, 4), alpha=4,
                             solver_backend="reference", pipeline="off")
    solver = PisoSolver(CavityMesh.cube(8, 4), alpha=4, device="cpu")
    plan4, prog4 = solver.plan_p, solver.program
    state_j = solver_j.initial_state()
    state = solver.initial_state()
    seconds = []
    for alpha in (4, 2, 4):
        solver_j.rebind_alpha(alpha)
        solver.rebind_alpha(alpha)
        assert solver.alpha == alpha and solver.plan_p.alpha == alpha
        assert solver.n_coarse == 4 // alpha
        seconds.append(solver.plan_seconds)
        state_j, stats_j = solver_j.step(state_j, DT)
        state, stats = solver.step(state, DT)
        _assert_step_matches(state, stats, state_j, stats_j)
        # the next step starts from the same (JAX's) state on both sides
        state = state_from_numpy({f: np.asarray(getattr(state_j, f))
                                  for f in PisoState._fields}, device="cpu")
    assert solver.plan_p is plan4 and solver.program is prog4
    # alpha 2 built its plan; revisiting alpha 4 built none
    assert 0 < seconds[0] < seconds[1] == seconds[2]
    with pytest.raises(ValueError, match="divide"):
        solver.rebind_alpha(3)
