"""The device-resident Krylov loop (``repro_torch.solvers.device_loop``) on
the CPU, against the JAX package and against the port's former host loop.

On the CPU the block runner runs the same body eagerly, ``K`` iterations a
block with the guard evaluated in each, and one block ahead of every flag
read, as the CUDA graph replays on the card; the plain versions of the
guarded kernels write through a select.  So iterations past convergence,
past the cap or past a breakdown run here too and must change nothing.
The bar: the solvers at ``K`` in {1, 3, 8, 64} give JAX's reference
backend's counts and flags with solutions within 1e-10, and the host loop's
(``_cg_sweep_host``, ``_bicgstab_sweep_host``) bit for bit.
"""
import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fvm.step_program import roll_schedule as jax_roll_schedule
from repro.solvers.bicgstab import bicgstab as jax_bicgstab
from repro.solvers.cg import cg as jax_cg

from repro_torch.fvm.step_program import roll_schedule
from repro_torch.kernels.krylov_loop.krylov_loop import (cg_advance,
                                                         cg_direction,
                                                         cg_direction_plain)
from repro_torch.solvers import bicgstab as bicgstab_mod
from repro_torch.solvers import cg as cg_mod
from repro_torch.solvers import device_loop
from repro_torch.solvers.bicgstab import bicgstab
from repro_torch.solvers.cg import cg

from test_torch_precision import INNER_SLACK, REFINED, _port_ops, spd_system  # noqa: F401
from test_torch_solvers import PARITY, _systems

KS = (1, 3, 8, 64)
SOLVERS = {"cg": (cg, jax_cg, False), "bicgstab": (bicgstab, jax_bicgstab,
                                                   True)}
BACKENDS = ("reference", "fused")


@pytest.fixture
def host_loops(monkeypatch):
    """A function that runs a solve on the former host loops."""
    def run(fn, *args, **kwargs):
        with monkeypatch.context() as m:
            m.setattr(cg_mod, "_cg_sweep", cg_mod._cg_sweep_host)
            m.setattr(bicgstab_mod, "_bicgstab_sweep",
                      bicgstab_mod._bicgstab_sweep_host)
            return fn(*args, **kwargs)
    return run


def _assert_bitwise(res, host):
    assert torch.equal(res.x, host.x)
    assert torch.equal(res.residual, host.residual)
    for f in ("iters", "outer_iters", "converged", "hit_cap"):
        assert int(getattr(res, f)) == int(getattr(host, f)), f


def _assert_jax(res, res_j, slack=0):
    assert abs(int(res.iters) - int(res_j.iters)) <= slack
    assert int(res.outer_iters) == int(res_j.outer_iters)
    assert bool(res.converged) == bool(res_j.converged)
    assert bool(res.hit_cap) == bool(res_j.hit_cap)


def _assert_records(n_sweeps, solver):
    """Every sweep that iterates: the start's flag read, one read per block
    until the flag drops with one block in flight past it, and the read of
    ``k`` — within ``ceil(iterations / K) + 4`` host reads, at the
    solver's own block length; on the CPU no launch is counted on a
    device."""
    recs = device_loop.loop_records()
    assert len(recs) == n_sweeps
    for rec in recs:
        assert (rec.solver, rec.K, rec.launches) == (
            solver, device_loop.K[solver], {})
        flag_reads = rec.host_reads - 2
        assert rec.iters > 0
        assert flag_reads == math.ceil(rec.iters / rec.K)
        assert rec.blocks == flag_reads + 1
        assert rec.host_reads <= math.ceil(rec.iters / rec.K) + 4


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", SOLVERS)
def test_block_runner_matches_jax_and_the_host_loop(name, backend, K,
                                                    monkeypatch, host_loops):
    """A solve that converges inside a block: a later one (K 1, 3, 8) or
    the first (K 64)."""
    solver, jax_solver, skew = SOLVERS[name]
    ops_j, ops_t, b = _systems(2, skew)
    monkeypatch.setattr(device_loop, "K", {"cg": K, "bicgstab": K})
    res_j = jax_solver(ops_j, jnp.asarray(b), jnp.zeros_like(jnp.asarray(b)),
                       tol=1e-10, maxiter=500)
    b_t = torch.as_tensor(b)
    device_loop.reset_loop_records()
    res = solver(ops_t[backend], b_t, torch.zeros_like(b_t), tol=1e-10,
                 maxiter=500)
    _assert_records(1, name)
    assert bool(res.converged)
    _assert_jax(res, res_j)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(res_j.x), rtol=0,
                               atol=PARITY)
    _assert_bitwise(res, host_loops(solver, ops_t[backend], b_t,
                                    torch.zeros_like(b_t), tol=1e-10,
                                    maxiter=500))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", SOLVERS)
def test_cap_reached_inside_a_block(name, backend, monkeypatch, host_loops):
    """maxiter 5 with K = 4: the cap falls in the second block, and the
    third (in flight) changes nothing."""
    solver, jax_solver, skew = SOLVERS[name]
    ops_j, ops_t, b = _systems(2, skew)
    monkeypatch.setattr(device_loop, "K", {"cg": 4, "bicgstab": 4})
    res_j = jax_solver(ops_j, jnp.asarray(b), jnp.zeros_like(jnp.asarray(b)),
                       tol=1e-12, maxiter=5)
    b_t = torch.as_tensor(b)
    device_loop.reset_loop_records()
    res = solver(ops_t[backend], b_t, torch.zeros_like(b_t), tol=1e-12,
                 maxiter=5)
    (rec,) = device_loop.loop_records()
    assert (rec.iters, rec.blocks, rec.host_reads) == (5, 3, 4)
    assert int(res.iters) == 5 and bool(res.hit_cap)
    assert not bool(res.converged)
    _assert_jax(res, res_j)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(res_j.x), rtol=0,
                               atol=PARITY)
    _assert_bitwise(res, host_loops(solver, ops_t[backend], b_t,
                                    torch.zeros_like(b_t), tol=1e-12,
                                    maxiter=5))


@pytest.mark.parametrize("K", (1, 8))
@pytest.mark.parametrize("start", ("nan_rhs", "converged"))
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", SOLVERS)
def test_starts_that_run_no_iteration(name, backend, start, K, monkeypatch,
                                      host_loops):
    """A NaN rhs (0 iterations, converged and hit_cap both False) and an
    already converged start (b = 0 from x = 0: 0 iterations, converged):
    the start's flag read stops the loop before any block."""
    solver, jax_solver, skew = SOLVERS[name]
    ops_j, ops_t, b = _systems(2, skew)
    b = np.full_like(b, np.nan) if start == "nan_rhs" else np.zeros_like(b)
    monkeypatch.setattr(device_loop, "K", {"cg": K, "bicgstab": K})
    res_j = jax_solver(ops_j, jnp.asarray(b), jnp.zeros_like(jnp.asarray(b)),
                       tol=1e-10, maxiter=50)
    b_t = torch.as_tensor(b)
    device_loop.reset_loop_records()
    res = solver(ops_t[backend], b_t, torch.zeros_like(b_t), tol=1e-10,
                 maxiter=50)
    (rec,) = device_loop.loop_records()
    assert (rec.iters, rec.blocks, rec.host_reads) == (0, 0, 1)
    assert int(res.iters) == 0 and not bool(res.hit_cap)
    assert bool(res.converged) == (start == "converged")
    _assert_jax(res, res_j)
    host = host_loops(solver, ops_t[backend], b_t, torch.zeros_like(b_t),
                      tol=1e-10, maxiter=50)
    assert torch.equal(res.x.isnan(), host.x.isnan())
    assert torch.equal(res.x.nan_to_num(), host.x.nan_to_num())
    for f in ("iters", "converged", "hit_cap"):
        assert int(getattr(res, f)) == int(getattr(host, f))


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("case", ("identity", "rotation"))
def test_bicgstab_breakdown_inside_a_block(case, K, monkeypatch, host_loops):
    """A Lanczos breakdown (a rotation: <rhat, v> = 0 at once) and an exact
    first half-step (A = I): the breaking iteration counts, the previous
    iterate stays, and the rest of the block changes nothing."""
    rng = np.random.default_rng(7)
    if case == "identity":
        b, R = rng.standard_normal((1, 16)), np.eye(16)
    else:
        b, R = np.array([[1.0, 0.0]]), np.array([[0.0, 1.0], [-1.0, 0.0]])
    R_j, R_t = jnp.asarray(R), torch.as_tensor(R)
    monkeypatch.setattr(device_loop, "K", {"cg": K, "bicgstab": K})
    res_j = jax_bicgstab(lambda v: v @ R_j.T, jnp.asarray(b),
                         jnp.zeros_like(jnp.asarray(b)), tol=1e-12,
                         maxiter=50)
    b_t = torch.as_tensor(b)
    res = bicgstab(lambda v: v @ R_t.T, b_t, torch.zeros_like(b_t),
                   tol=1e-12, maxiter=50)
    assert np.isfinite(res.x.numpy()).all()
    _assert_jax(res, res_j)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(res_j.x), rtol=0,
                               atol=PARITY)
    _assert_bitwise(res, host_loops(bicgstab, lambda v: v @ R_t.T, b_t,
                                    torch.zeros_like(b_t), tol=1e-12,
                                    maxiter=50))


@pytest.mark.parametrize("K", (1, 3, 64))
@pytest.mark.parametrize("policy", REFINED)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", SOLVERS)
def test_refined_sweeps_on_the_block_runner(name, backend, policy, K,
                                            spd_system, monkeypatch,
                                            host_loops):
    """f32_ir and bf16_ir: every inner sweep on the block runner; the whole
    refinement bit for bit the host loops', and JAX's flags and outer
    count with the inner slack of tests/test_torch_precision.py."""
    solver = SOLVERS[name][0]
    sys_ = spd_system
    ops = _port_ops(policy, backend, sys_["bands"], sys_["diag"],
                    sys_["offsets"], sys_["plane"])
    b = sys_["b"]
    monkeypatch.setattr(device_loop, "K", {"cg": K, "bicgstab": K})
    device_loop.reset_loop_records()
    res = solver(ops, b, torch.zeros_like(b), tol=1e-12, maxiter=500)
    assert len(device_loop.loop_records()) == int(res.outer_iters) >= 1
    _assert_records(int(res.outer_iters), name)
    _assert_bitwise(res, host_loops(solver, ops, b, torch.zeros_like(b),
                                    tol=1e-12, maxiter=500))
    res_j = sys_["jax"][name, policy]
    assert bool(res.converged) == bool(res_j.converged)
    assert bool(res.hit_cap) == bool(res_j.hit_cap)
    # the outer slack of tests/test_torch_precision.py: the fused backend's
    # float32 row sums under bfloat16 storage may end one pass apart
    slack = 1 if (backend, policy) == ("fused", "bf16_ir") else 0
    assert abs(int(res.outer_iters) - int(res_j.outer_iters)) <= slack
    assert abs(int(res.iters) - int(res_j.iters)) <= INNER_SLACK


@pytest.mark.parametrize("storage,accum", [
    (torch.float64, torch.float64), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32)])
def test_cg_direction_is_the_eager_pair_bitwise(storage, accum):
    """The plain ``cg_direction`` (and the wrapper on CPU tensors) is
    ``z + (gamma_new / gamma).to(z.dtype) * p`` bit for bit; under a False
    guard it leaves ``p`` as it is."""
    rng = np.random.default_rng(5)
    p0 = torch.as_tensor(rng.standard_normal((3, 257))).to(storage)
    z = torch.as_tensor(rng.standard_normal((3, 257))).to(storage)
    g_new = torch.tensor(0.3719, dtype=accum)
    g = torch.tensor(0.9107, dtype=accum)
    want = z + (g_new / g).to(storage) * p0
    assert torch.equal(cg_direction_plain(p0.clone(), z, g_new, g), want)
    for flag, expect in ((None, want), (torch.tensor(True), want),
                         (torch.tensor(False), p0)):
        p = p0.clone()
        cg_direction(p, z, g_new, g, flag)
        assert torch.equal(p, expect)


def test_cg_advance_updates_only_while_active():
    """The guard: the carry moves and the flag is re-formed while active;
    a NaN residual or the cap drops the flag; nothing moves once down."""
    def run(rr_new, k0, flag0, maxiter=4):
        sc = [torch.tensor(v, dtype=torch.float64)
              for v in (1.0, 2.0, 3.0, rr_new)]
        k = torch.tensor(k0, dtype=torch.int32)
        flag = torch.tensor(flag0)
        cg_advance(*sc, k, flag, torch.tensor(1.0, dtype=torch.float64),
                   maxiter)
        return [float(sc[0]), float(sc[2]), int(k), bool(flag)]

    assert run(5.0, 0, True) == [2.0, 5.0, 1, True]
    assert run(0.5, 0, True) == [2.0, 0.5, 1, False]   # converged
    assert run(5.0, 3, True) == [2.0, 5.0, 4, False]   # the cap
    out = run(float("nan"), 0, True)
    assert out[:1] == [2.0] and math.isnan(out[1]) and out[2:] == [1, False]
    assert run(5.0, 2, False) == [1.0, 3.0, 2, False]  # idle: no change


def test_roll_schedule_matches_jax():
    for start, n, every, cap in itertools.product(
            (0, 1, 3, 7), (1, 2, 5, 12), (None, 1, 2, 4), (None, 1, 3)):
        assert (list(roll_schedule(start, n, every, cap))
                == list(jax_roll_schedule(start, n, every, cap)))
    with pytest.raises(ValueError, match="every"):
        list(roll_schedule(0, 3, 0))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", SOLVERS)
def test_body_under_a_false_flag_changes_nothing(name, backend):
    """The invariant the block replay and the card's warm-up before each
    capture rest on: one iteration under a False flag leaves every carry
    buffer as it was, bit for bit, and the flag False."""
    _, ops_t, b = _systems(2, SOLVERS[name][2])
    ops = ops_t[backend]
    b_t = torch.as_tensor(b)
    sweep = (cg_mod._cg_sweep if name == "cg"
             else bicgstab_mod._bicgstab_sweep)
    thr = torch.tensor(1e-20, dtype=torch.float64)
    sweep(ops, b_t, torch.zeros_like(b_t), thr, 3)  # 3 iterations: mid-solve
    (st,) = ops.loops.values()
    body = (cg_mod._cg_body(ops, st, 3) if name == "cg"
            else bicgstab_mod._bicgstab_body(ops, st, 3))
    carry = {k: v.clone() for k, v in vars(st).items()
             if isinstance(v, torch.Tensor)}
    off = torch.tensor(False)
    for _ in range(2):
        body(off)
    assert not bool(off)
    for k in ("x", "r", "p", "gamma", "rr", "k", "rho", "alpha", "omega",
              "v", "rhat", "thr", "active"):
        if k in carry:
            assert torch.equal(getattr(st, k), carry[k]), k
