"""Attention: GQA/MQA/MHA with RoPE, qk-norm, sliding window; flash-chunked.

The port of the JAX package's ``models/attention.py``.  The score matrix
is never materialized at (S, S): a loop over KV chunks keeps an
online-softmax carry (m, l, acc) per Q chunk, in f32, the same algorithm
and the same mask arithmetic (an additive -1e30) as the JAX module, so
the CPU path that the tests hold against JAX is the path that runs on the
card.

Decode (single query) attends over the whole cache with a positional
validity mask.  The cache's K/V are written in place.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.layers import dense_init, rms_norm, rope, torch_dtype

__all__ = ["NEG_INF", "AttnSpec", "attention_init", "flash_attention",
           "attn_train", "cross_attn", "attn_decode"]

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    causal: bool = True
    use_rope: bool = True
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    sliding_window: int | None = None
    norm_eps: float = 1e-5
    chunk_q: int = 128
    chunk_kv: int = 1024
    # with a sliding window, each Q chunk only visits the KV chunks inside
    # its window instead of all of them (bit-exact)
    swa_chunk_skip: bool = False


def attention_init(gen, d_model: int, spec: AttnSpec, dtype):
    H, Hk, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    p = {
        "wq": dense_init(gen, (d_model, H * hd), dtype),
        "wk": dense_init(gen, (d_model, Hk * hd), dtype),
        "wv": dense_init(gen, (d_model, Hk * hd), dtype),
        "wo": dense_init(gen, (H * hd, d_model), dtype),
    }
    if spec.qk_norm:
        p["q_gamma"] = torch.ones((hd,), dtype=torch_dtype(dtype),
                                  device=gen.device)
        p["k_gamma"] = torch.ones((hd,), dtype=torch_dtype(dtype),
                                  device=gen.device)
    return p


def _project_qkv(p, x, spec: AttnSpec, positions):
    B, S, _ = x.shape
    H, Hk, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, Hk, hd)
    v = (x @ p["wv"]).reshape(B, S, Hk, hd)
    if spec.qk_norm:
        q = rms_norm(q, p["q_gamma"], spec.norm_eps)
        k = rms_norm(k, p["k_gamma"], spec.norm_eps)
    if spec.use_rope:
        q = rope(q, positions, spec.rope_theta)
        k = rope(k, positions, spec.rope_theta)
    return q, k, v


def _mask(q_pos, kv_pos, spec: AttnSpec) -> torch.Tensor:
    """(q, kv) additive f32 mask from positions (-1 marks padding)."""
    valid = (kv_pos[None, :] >= 0) & (q_pos[:, None] >= 0)
    if spec.causal:
        valid &= kv_pos[None, :] <= q_pos[:, None]
    if spec.sliding_window is not None:
        valid &= q_pos[:, None] - kv_pos[None, :] < spec.sliding_window
    return torch.where(valid, 0.0, NEG_INF)


def flash_attention(q, k, v, q_pos, kv_pos, spec: AttnSpec) -> torch.Tensor:
    """Chunked online-softmax attention.

    q: (B, Sq, H, hd); k/v: (B, Skv, Hk, hd); positions: (Sq,), (Skv,).
    Returns (B, Sq, H, hd) in ``q``'s dtype.
    """
    B, Sq, H, hd = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    cq = min(spec.chunk_q, Sq)
    ckv = min(spec.chunk_kv, Skv)
    pad_q = (-Sq) % cq
    pad_kv = (-Skv) % ckv
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_pos = torch.nn.functional.pad(q_pos, (0, pad_q), value=-1)
    if pad_kv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_kv))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad_kv), value=-1)
    nq, nkv = q.shape[1] // cq, k.shape[1] // ckv
    scale = hd ** -0.5

    # qc: (nq, B, Hk, G, cq, hd); kc, vc: (nkv, B, Hk, ckv, hd)
    qc = q.reshape(B, nq, cq, Hk, G, hd).permute(1, 0, 3, 4, 2, 5)
    kc = k.reshape(B, nkv, ckv, Hk, hd).permute(1, 0, 3, 2, 4)
    vc = v.reshape(B, nkv, ckv, Hk, hd).permute(1, 0, 3, 2, 4)
    qpc = q_pos.reshape(nq, cq)
    kpc = kv_pos.reshape(nkv, ckv)

    # SWA chunk skip: a Q chunk at positions [i·cq, i·cq+cq) only needs KV
    # chunks covering [i·cq − W + 1, i·cq + cq) — a fixed count nw per chunk
    swa_skip = (spec.swa_chunk_skip and spec.sliding_window is not None
                and spec.causal and Sq == Skv)
    if swa_skip:
        W = spec.sliding_window
        nw = min(nkv, (W + cq - 2) // ckv + 2)
        swa_skip = nw < nkv

    outs = []
    for qi in range(nq):
        qb = qc[qi].float()
        if swa_skip:
            lo = (qi * cq - spec.sliding_window + 1) // ckv
            start = min(max(lo, 0), nkv - nw)
            chunks = range(start, start + nw)
        else:
            chunks = range(nkv)
        m = torch.full((B, Hk, G, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Hk, G, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Hk, G, cq, hd), dtype=torch.float32,
                          device=q.device)
        for j in chunks:
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kc[j].float()) * scale
            s = s + _mask(qpc[qi], kpc[j], spec)[None, None, None]
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vc[j].float())
            m = m_new
        outs.append(acc / torch.clamp_min(l[..., None], 1e-30))
    # (nq, B, Hk, G, cq, hd) -> (B, Sq, H, hd)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(
        B, nq * cq, H, hd)
    return out[:, :Sq].to(q.dtype)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def attn_train(p, x, positions, spec: AttnSpec, memory=None, memory_pos=None):
    """Self- (or cross-) attention over a full sequence (train/prefill).

    Returns (y, (k, v)) so prefill can seed the decode cache.
    """
    q, k, v = _project_qkv(p, x, spec, positions)
    if memory is not None:  # cross-attention: keys/values from the memory
        km, vm = memory
        out = flash_attention(q, km, vm, positions, memory_pos, spec)
        kv = (km, vm)
    else:
        out = flash_attention(q, k, v, positions, positions, spec)
        kv = (k, v)
    B, S = x.shape[:2]
    y = out.reshape(B, S, spec.n_heads * spec.head_dim) @ p["wo"]
    return y, kv


def cross_attn(p, x, positions, spec: AttnSpec, memory, memory_pos):
    """Cross-attention: queries from ``x``, keys and values from the
    encoder ``memory`` (B, M, d).  Returns (y, (k, v))."""
    B, M, _ = memory.shape
    Hk, hd = spec.n_kv_heads, spec.head_dim
    k = (memory @ p["wk"]).reshape(B, M, Hk, hd)
    v = (memory @ p["wv"]).reshape(B, M, Hk, hd)
    H = spec.n_heads
    q = (x @ p["wq"]).reshape(B, x.shape[1], H, hd)
    out = flash_attention(q, k, v, positions, memory_pos, spec)
    y = out.reshape(B, x.shape[1], H * hd) @ p["wo"]
    return y, (k, v)


def attn_decode(p, x, pos: int, cache, spec: AttnSpec):
    """Single-token decode.  x: (B, 1, d); cache: dict(k, v) of
    (B, S_cache, Hk, hd); pos: the current position (a Python int).

    Writes the new K/V into the cache in place and returns (y, cache).
    The validity mask kv_pos <= pos confines attention to written slots.
    Sliding-window caches of exactly W slots are ring buffers (slot =
    position mod W).  A slot past the cache is clamped to its last one,
    as ``lax.dynamic_update_slice`` clamps in JAX.
    """
    B = x.shape[0]
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, spec, positions)
    k, v = cache["k"], cache["v"]
    S_max = k.shape[1]
    ring = spec.sliding_window is not None and S_max == spec.sliding_window
    slot = min(max(pos % S_max if ring else pos, 0), S_max - 1)
    k[:, slot] = k_new[:, 0]
    v[:, slot] = v_new[:, 0]
    j = torch.arange(S_max, dtype=torch.int64, device=x.device)
    if ring:
        # slot j holds the most recent position ≡ j (mod W) (floor modulo);
        # never-written slots resolve to negative positions, masked out
        kv_pos = pos - torch.remainder(pos - j, S_max)
        kv_pos = torch.where(kv_pos >= 0, kv_pos, -1)
    else:
        kv_pos = torch.where(j <= pos, j, -1)  # only written slots

    Hk, G, hd = spec.n_kv_heads, spec.n_heads // spec.n_kv_heads, spec.head_dim
    qh = q.reshape(B, Hk, G, hd)
    s = torch.einsum("bhgd,bshd->bhgs", qh.float(), k.float()) * hd ** -0.5
    s = s + _mask(positions, kv_pos, spec)[0][None, None, None, :]
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", w, v.float())
    y = out.reshape(B, spec.n_heads * hd).to(x.dtype) @ p["wo"]
    return y[:, None, :], {"k": k, "v": v}
