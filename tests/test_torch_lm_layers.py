"""The port's MLP, MoE, Mamba and RWKV-6 blocks against the JAX package's
on the CPU, with and without a decode state.

Weights come from the port's init functions (a seeded ``torch.Generator``)
and go to JAX as numpy arrays (``lm_params_to_numpy``); inputs from numpy
seeds.  float32
blocks are held within 2e-6 of the largest |value| (MLP, MoE) and 2e-5
(Mamba and RWKV: time recurrences in f32 over up to 24 steps).  The
sorted MoE's combine adds each token's ``top_k`` outputs in rank order,
where JAX's scatter-add adds them in expert order: for ``top_k = 2`` the
two sums are the same bits, which ``index_add_`` in sorted order shows.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlay
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro_torch.interop import lm_params_to_numpy
from repro_torch.models import layers as tlay
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm

F32 = 2e-6
SCAN = 2e-5


def as64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(np.asarray(a, np.float32), np.float64)


def rel_err(got, want) -> float:
    got, want = as64(got), as64(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def gen(seed):
    return torch.Generator().manual_seed(seed)


def to_jax(tp):
    return jax.tree.map(jnp.asarray, lm_params_to_numpy(tp))


def x_of(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False),
                                       ("geglu", True)])
def test_mlp_matches_jax(act, gated):
    tp = tlay.mlp_init(gen(0), 24, 40, gated, torch.float32)
    x = x_of(0, (2, 5, 24))
    want = jlay.mlp_apply(to_jax(tp), jnp.asarray(x), act)
    got = tlay.mlp_apply(tp, torch.as_tensor(x), act)
    assert rel_err(got, want) <= F32


@pytest.mark.parametrize("E,k,gated", [(4, 2, True), (8, 2, False),
                                       (4, 1, True)])
def test_moe_apply_matches_jax(E, k, gated):
    tp = tlay.moe_init(gen(1), 16, 24, E, gated, torch.float32)
    x = x_of(1, (2, 9, 16))
    want = jax.jit(functools.partial(jlay.moe_apply, top_k=k, act="silu"))(
        to_jax(tp), jnp.asarray(x))
    got = tlay.moe_apply(tp, torch.as_tensor(x), top_k=k, act="silu")
    assert rel_err(got, want) <= F32


@pytest.mark.parametrize("E,k,cf,seq", [(4, 2, 1.25, 9), (8, 2, 0.5, 12),
                                        (4, 1, 1.0, 7)])
def test_moe_apply_sorted_matches_jax(E, k, cf, seq):
    """Including capacity factors that drop assignments (cf < 1)."""
    tp = tlay.moe_init(gen(2), 16, 24, E, True, torch.float32)
    x = x_of(2, (2, seq, 16))
    want = jax.jit(functools.partial(
        jlay.moe_apply_sorted, top_k=k, act="silu", capacity_factor=cf))(
        to_jax(tp), jnp.asarray(x))
    got = tlay.moe_apply_sorted(tp, torch.as_tensor(x), top_k=k,
                                act="silu", capacity_factor=cf)
    assert rel_err(got, want) <= F32


def test_moe_sorted_combine_is_order_free_at_top2():
    """For top_k = 2 the rank-order combine equals a scatter-add in the
    sorted (expert) order bit for bit: 0 + a + b = 0 + b + a."""
    torch.manual_seed(0)
    N, k, d = 37, 2, 16
    contrib = torch.randn(N * k, d)
    order = torch.randperm(N * k)
    token_of = order // k
    scatter = torch.zeros(N, d).index_add_(0, token_of, contrib)
    per_token = torch.empty_like(contrib)
    per_token[order] = contrib
    per_token = per_token.reshape(N, k, d)
    ranked = torch.zeros(N, d) + per_token[:, 0] + per_token[:, 1]
    assert torch.equal(scatter, ranked)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_sorted_equals_dense_without_drops(dtype):
    """With capacity for every assignment the two dispatches compute the
    same function (the same experts, weights and sums up to rounding)."""
    tdt = getattr(torch, dtype)
    p = tlay.moe_init(torch.Generator().manual_seed(3), 16, 24, 4, True, tdt)
    x = torch.as_tensor(x_of(3, (2, 6, 16))).to(tdt)
    dense = tlay.moe_apply(p, x, top_k=2, act="silu")
    sparse = tlay.moe_apply_sorted(p, x, top_k=2, act="silu",
                                   capacity_factor=4.0)
    assert rel_err(sparse, dense) <= (F32 if dtype == "float32" else 2 ** -6)


def mamba_params(seed, d=16, di=32, ds=4):
    tp = tssm.mamba_init(gen(seed), d, di, ds, 4, torch.float32)
    return to_jax(tp), tp


@pytest.mark.parametrize("S", [1, 6, 24])
def test_mamba_apply_matches_jax(S):
    jp, tp = mamba_params(4)
    x = x_of(4, (2, S, 16))
    (wy, wst) = jax.jit(jssm.mamba_apply)(jp, jnp.asarray(x))
    gy, gst = tssm.mamba_apply(tp, torch.as_tensor(x))
    assert rel_err(gy, wy) <= SCAN
    for key in ("conv", "ssm"):
        assert rel_err(gst[key], wst[key]) <= SCAN, key


def test_mamba_apply_with_state_matches_jax():
    """A prompt, then tokens one at a time through the carried state."""
    jp, tp = mamba_params(5)
    x = x_of(5, (2, 10, 16))
    jstep = jax.jit(jssm.mamba_apply)
    _, wst = jstep(jp, jnp.asarray(x[:, :6]))
    _, gst = tssm.mamba_apply(tp, torch.as_tensor(x[:, :6]))
    for t in range(6, 10):
        wy, wst = jstep(jp, jnp.asarray(x[:, t:t + 1]), wst)
        gy, gst = tssm.mamba_apply(tp, torch.as_tensor(x[:, t:t + 1]), gst)
        assert rel_err(gy, wy) <= SCAN, t
        assert rel_err(gst["ssm"], wst["ssm"]) <= SCAN, t
        assert rel_err(gst["conv"], wst["conv"]) <= SCAN, t


def test_mamba_dt_softplus_is_logaddexp():
    """dt = softplus(. + dt_bias) is logaddexp(x, 0) past F.softplus's
    threshold of 20, as jax.nn.softplus is."""
    x = torch.tensor([-30.0, 0.0, 19.5, 20.5, 40.0])
    want = jax.nn.softplus(jnp.asarray(x.numpy()))
    assert rel_err(tssm._softplus(x), want) <= F32


def rwkv_params(seed, d=32, hd=8):
    tp = trwkv.rwkv_init(gen(seed), d, hd, torch.float32, lora_rank=8)
    return to_jax(tp), tp


@pytest.mark.parametrize("S", [1, 5, 17])
def test_rwkv_apply_matches_jax(S):
    jp, tp = rwkv_params(6)
    x = x_of(6, (2, S, 32))
    wy, wst = jax.jit(jrwkv.rwkv_apply)(jp, jnp.asarray(x))
    gy, gst = trwkv.rwkv_apply(tp, torch.as_tensor(x))
    assert rel_err(gy, wy) <= SCAN
    assert rel_err(gst["S"], wst["S"]) <= SCAN
    assert rel_err(gst["last"], wst["last"]) <= F32


def test_rwkv_apply_with_state_matches_jax():
    jp, tp = rwkv_params(7)
    x = x_of(7, (2, 9, 32))
    jstep = jax.jit(jrwkv.rwkv_apply)
    _, wst = jstep(jp, jnp.asarray(x[:, :5]))
    _, gst = trwkv.rwkv_apply(tp, torch.as_tensor(x[:, :5]))
    for t in range(5, 9):
        wy, wst = jstep(jp, jnp.asarray(x[:, t:t + 1]), wst)
        gy, gst = trwkv.rwkv_apply(tp, torch.as_tensor(x[:, t:t + 1]), gst)
        assert rel_err(gy, wy) <= SCAN, t
        assert rel_err(gst["S"], wst["S"]) <= SCAN, t


@pytest.mark.parametrize("stateful", [False, True])
def test_rwkv_ffn_matches_jax(stateful):
    tp = trwkv.rwkv_ffn_init(gen(9), 32, 48, torch.float32)
    x = x_of(9, (2, 5, 32))
    last = x_of(10, (2, 32))
    jst = {"last": jnp.asarray(last)} if stateful else None
    tst = {"last": torch.as_tensor(last)} if stateful else None
    wy, wst = jax.jit(jrwkv.rwkv_ffn_apply)(to_jax(tp), jnp.asarray(x), jst)
    gy, gst = trwkv.rwkv_ffn_apply(tp, torch.as_tensor(x), tst)
    assert rel_err(gy, wy) <= F32
    assert rel_err(gst["last"], wst["last"]) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixed_dtype_leaves_keep_f32(dtype):
    """Mamba's dt_bias/A_log/D, RWKV's w0/u and the MoE router are f32 in
    any model, in JAX and in the port."""
    gen = torch.Generator().manual_seed(0)
    tdt = getattr(torch, dtype)
    m = tssm.mamba_init(gen, 16, 32, 4, 4, tdt)
    r = trwkv.rwkv_init(gen, 32, 8, tdt, lora_rank=8)
    e = tlay.moe_init(gen, 16, 24, 4, True, tdt)
    jdt, key = jnp.dtype(dtype), jax.random.key(0)
    jm = jax.eval_shape(lambda k: jssm.mamba_init(k, 16, 32, 4, 4, jdt), key)
    jr = jax.eval_shape(
        lambda k: jrwkv.rwkv_init(k, 32, 8, jdt, lora_rank=8), key)
    je = jax.eval_shape(lambda k: jlay.moe_init(k, 16, 24, 4, True, jdt), key)
    for got, want in ((m, jm), (r, jr), (e, je)):
        assert got.keys() == want.keys()
        for key in want:
            assert str(got[key].dtype) == f"torch.{want[key].dtype}", key
            assert tuple(got[key].shape) == want[key].shape, key
