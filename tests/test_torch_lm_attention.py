"""The port's attention and elementwise pieces against the JAX package's
on the CPU: ``flash_attention`` over ``tests/test_attention.py``'s grid
(windows, cross shapes, decode-like and ragged shapes, small chunks,
padding) and with ``swa_chunk_skip``; ``attn_decode`` with and without a
ring buffer; ``rope``, ``rms_norm`` and the activations in float32 and
bfloat16; the time scan.

Inputs come from numpy seeds and go to both packages as the same arrays.
float32 results are held within 2e-6 of the largest |value| (the two
libraries' exp, tanh and sum orders differ in the last bits); bfloat16
within one bf16 ulp of it (2 ** -7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jatt
from repro.models import layers as jlay
from repro.models.scan_utils import chunked_scan as jax_scan
from repro_torch.models import attention as tatt
from repro_torch.models import layers as tlay
from repro_torch.models.scan_utils import chunked_scan

F32 = 2e-6
BF16 = 2.0 ** -7

# JAX's side jitted (the spec static): one compile per shape, not one per op
jax_flash = jax.jit(jatt.flash_attention, static_argnums=5)
jax_decode = jax.jit(jatt.attn_decode, static_argnums=4)
jax_train = jax.jit(jatt.attn_train, static_argnums=3)


def rel_err(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).float() if isinstance(
        got, torch.Tensor) else got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def specs(**kw):
    base = dict(n_heads=4, n_kv_heads=2, head_dim=8, causal=True,
                use_rope=False, qk_norm=False, sliding_window=None,
                chunk_q=4, chunk_kv=4)
    base.update(kw)
    return jatt.AttnSpec(**base), tatt.AttnSpec(**base)


def qkv(rng, B, Sq, Skv, H, Hk, hd):
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, Hk, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, Hk, hd)).astype(np.float32))


def run_flash(js, ts, q, k, v, q_pos, kv_pos):
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v)),
                     jnp.asarray(q_pos, jnp.int32),
                     jnp.asarray(kv_pos, jnp.int32), js)
    got = tatt.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                               torch.as_tensor(q_pos),
                               torch.as_tensor(kv_pos), ts)
    return got, want


@pytest.mark.parametrize("Sq,Skv,causal,window,cq,ckv", [
    (16, 16, True, None, 4, 4),
    (16, 16, True, 5, 4, 8),
    (8, 24, False, None, 8, 8),   # cross-attention shape
    (1, 16, True, None, 1, 4),    # decode-like
    (13, 13, True, None, 4, 8),   # ragged: padding path
    (13, 21, False, 6, 5, 6),     # ragged q and kv, window, no causality
])
def test_flash_attention_matches_jax(Sq, Skv, causal, window, cq, ckv):
    js, ts = specs(causal=causal, sliding_window=window, chunk_q=cq,
                   chunk_kv=ckv)
    rng = np.random.default_rng(0)
    q, k, v = qkv(rng, 2, Sq, Skv, 4, 2, 8)
    q_pos = np.arange(Skv - Sq, Skv) if causal else np.arange(Sq)
    got, want = run_flash(js, ts, q, k, v, q_pos, np.arange(Skv))
    assert rel_err(got, want) <= F32


@pytest.mark.parametrize("Sq,Hk,G,window,cq,ckv,seed", [
    (1, 1, 1, None, 5, 6, 0), (7, 2, 3, 3, 5, 6, 1),
    (24, 4, 1, 7, 5, 6, 2), (17, 1, 2, None, 3, 2, 3),
])
def test_flash_attention_gqa_grid(Sq, Hk, G, window, cq, ckv, seed):
    js, ts = specs(n_heads=Hk * G, n_kv_heads=Hk, sliding_window=window,
                   chunk_q=cq, chunk_kv=ckv)
    rng = np.random.default_rng(seed)
    q, k, v = qkv(rng, 1, Sq, Sq, Hk * G, Hk, 8)
    pos = np.arange(Sq)
    got, want = run_flash(js, ts, q, k, v, pos, pos)
    assert rel_err(got, want) <= F32


@pytest.mark.parametrize("S,W,cq,ckv", [(32, 5, 4, 4), (30, 7, 8, 4),
                                        (64, 16, 8, 8)])
def test_flash_attention_swa_chunk_skip(S, W, cq, ckv):
    """The chunk skip visits only the KV chunks inside each window: the
    result equals JAX's skip and the port's own full sweep."""
    js, ts = specs(sliding_window=W, chunk_q=cq, chunk_kv=ckv,
                   swa_chunk_skip=True)
    rng = np.random.default_rng(S)
    q, k, v = qkv(rng, 2, S, S, 4, 2, 8)
    pos = np.arange(S)
    got, want = run_flash(js, ts, q, k, v, pos, pos)
    assert rel_err(got, want) <= F32
    _, ts_full = specs(sliding_window=W, chunk_q=cq, chunk_kv=ckv)
    full = tatt.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                                torch.as_tensor(pos), torch.as_tensor(pos),
                                ts_full)
    assert torch.equal(got, full)


def test_flash_attention_padded_positions_and_bf16():
    """-1 positions are padding (masked both ways); bfloat16 inputs come
    back in bfloat16."""
    js, ts = specs(chunk_q=3, chunk_kv=5)
    rng = np.random.default_rng(7)
    q, k, v = qkv(rng, 2, 11, 11, 4, 2, 8)
    pos = np.arange(11)
    pos[8:] = -1
    got, want = run_flash(js, ts, q, k, v, pos, pos)
    assert rel_err(got[:, :8], np.asarray(want)[:, :8]) <= F32
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    tb = [torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v)]
    want = jax_flash(*jb, jnp.asarray(pos), jnp.asarray(pos), js)
    got = tatt.flash_attention(*tb, torch.as_tensor(pos),
                               torch.as_tensor(pos), ts)
    assert got.dtype == torch.bfloat16
    assert rel_err(got[:, :8], np.asarray(want, np.float32)[:, :8]) <= BF16


def attn_params(rng, d, H, Hk, hd, qk_norm):
    p = {"wq": rng.standard_normal((d, H * hd)) * d ** -0.5,
         "wk": rng.standard_normal((d, Hk * hd)) * d ** -0.5,
         "wv": rng.standard_normal((d, Hk * hd)) * d ** -0.5,
         "wo": rng.standard_normal((H * hd, d)) * (H * hd) ** -0.5}
    if qk_norm:
        p["q_gamma"] = 1 + 0.1 * rng.standard_normal(hd)
        p["k_gamma"] = 1 + 0.1 * rng.standard_normal(hd)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.as_tensor(v) for k, v in p.items()})


@pytest.mark.parametrize("window,S_max,n_steps", [(None, 12, 12), (4, 4, 11),
                                                  (6, 6, 6)])
def test_attn_decode_matches_jax(window, S_max, n_steps):
    """Token by token from an empty cache: the full cache, and ring
    buffers of W slots decoded past W (floor modulo of the positions)."""
    d, H, Hk, hd = 16, 4, 2, 8
    kw = dict(n_heads=H, n_kv_heads=Hk, head_dim=hd, sliding_window=window,
              qk_norm=True, rope_theta=1e4)
    js, ts = jatt.AttnSpec(**kw), tatt.AttnSpec(**kw)
    rng = np.random.default_rng(11)
    jp, tp = attn_params(rng, d, H, Hk, hd, qk_norm=True)
    x = rng.standard_normal((2, n_steps, d)).astype(np.float32)
    jc = {"k": jnp.zeros((2, S_max, Hk, hd), jnp.float32),
          "v": jnp.zeros((2, S_max, Hk, hd), jnp.float32)}
    tc = {"k": torch.zeros((2, S_max, Hk, hd)),
          "v": torch.zeros((2, S_max, Hk, hd))}
    for pos in range(n_steps):
        jy, jc = jax_decode(jp, jnp.asarray(x[:, pos:pos + 1]),
                            jnp.asarray(pos, jnp.int32), jc, js)
        ty, tc = tatt.attn_decode(tp, torch.as_tensor(x[:, pos:pos + 1]),
                                  pos, tc, ts)
        assert rel_err(ty, jy) <= F32, pos
        assert rel_err(tc["k"], jc["k"]) <= F32, pos
        assert rel_err(tc["v"], jc["v"]) <= F32, pos


def test_attn_train_matches_jax():
    d, H, Hk, hd = 16, 4, 2, 8
    kw = dict(n_heads=H, n_kv_heads=Hk, head_dim=hd, qk_norm=True,
              rope_theta=1e6, chunk_q=4, chunk_kv=8)
    js, ts = jatt.AttnSpec(**kw), tatt.AttnSpec(**kw)
    rng = np.random.default_rng(12)
    jp, tp = attn_params(rng, d, H, Hk, hd, qk_norm=True)
    x = rng.standard_normal((2, 10, d)).astype(np.float32)
    pos = np.arange(10)
    jy, (jk, jv) = jax_train(jp, jnp.asarray(x), jnp.asarray(pos), js)
    ty, (tk, tv) = tatt.attn_train(tp, torch.as_tensor(x),
                                   torch.as_tensor(pos), ts)
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        assert rel_err(got, want) <= F32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(dtype, theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(3, 12)
    want = jlay.rope(jnp.asarray(x, dtype), jnp.asarray(pos, jnp.int32),
                     theta)
    got = tlay.rope(torch.as_tensor(x).to(getattr(torch, dtype)),
                    torch.as_tensor(pos), theta)
    assert str(got.dtype) == f"torch.{dtype}"
    assert rel_err(got, want) <= (F32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    """Normalised in f32, cast to the input dtype before gamma."""
    rng = np.random.default_rng(2)
    x = (3 * rng.standard_normal((2, 5, 24))).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(24)).astype(np.float32)
    want = jlay.rms_norm(jnp.asarray(x, dtype), jnp.asarray(g, dtype), 1e-5)
    tdt = getattr(torch, dtype)
    got = tlay.rms_norm(torch.as_tensor(x).to(tdt),
                        torch.as_tensor(g).to(tdt), 1e-5)
    assert got.dtype == tdt
    assert rel_err(got, want) <= (F32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["silu", "gelu", "geglu"])
def test_activations_match_jax(name, dtype):
    """gelu is the tanh approximation in both (jax.nn.gelu's default)."""
    x = np.linspace(-8, 8, 401, dtype=np.float32)
    want = jlay.act_fn(name)(jnp.asarray(x, dtype))
    got = tlay.act_fn(name)(torch.as_tensor(x).to(getattr(torch, dtype)))
    assert rel_err(got, want) <= (F32 if dtype == "float32" else BF16)
    if name != "silu":
        exact = torch.nn.functional.gelu(torch.as_tensor(x))
        assert rel_err(exact, want) > 10 * F32  # the exact gelu differs


@pytest.mark.parametrize("T", [1, 7, 40])
def test_chunked_scan_matches_jax(T):
    """A plain loop over the real steps is JAX's padded, guarded scan at
    every chunk size."""
    rng = np.random.default_rng(T)
    a = rng.uniform(0.5, 0.99, (T, 4)).astype(np.float32)
    b = rng.standard_normal((T, 4)).astype(np.float32)

    def step(h, inp):
        ai, bi = inp
        h = ai * h + bi
        return h, h * 2.0

    got_c, got_y = chunked_scan(step, torch.zeros(4),
                                (torch.as_tensor(a), torch.as_tensor(b)))
    for chunk in (3, 8, 256):
        want_c, want_y = jax_scan(step, jnp.zeros(4, jnp.float32),
                                  (jnp.asarray(a), jnp.asarray(b)),
                                  chunk=chunk)
        assert rel_err(got_c, want_c) <= F32
        assert rel_err(got_y, want_y) <= F32
