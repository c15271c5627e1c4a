"""Analytical FLOP/byte models per (arch x shape) cell.

The port of the JAX package's ``launch/analysis.py``, formula for formula:
pure Python over :mod:`repro_torch.configs.shapes` and
:mod:`repro_torch.models.config`, no tensor.  The docstring below is the
JAX package's reason for it; in the port it is the implementation-FLOP
yardstick beside ``6 * N * tokens``.

Why this exists: XLA's ``cost_analysis`` counts a ``while``-loop body ONCE,
so every scanned structure (layers, flash-attention KV chunks, SSM time
steps) is undercounted.  The dry-run applies a two-point correction for the
*layer* scan (lower with 1 and 2 periods, extrapolate); inner sequence scans
are covered by this analytical model, which is exact for the implementation
as written (e.g. the flash path computes the full masked S x S score matrix:
we count S, not S/2, and report the causal ideal separately).

Conventions: FLOPs are global (whole step, all devices); matmul = 2mnk.
``train`` counts fwd + remat-fwd + bwd = 4x block flops (remat policy saves
nothing inside blocks), 3x for the unremat'd head.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.shapes import SHAPES
from repro_torch.models.config import LayerKind, ModelConfig

__all__ = ["FlopReport", "analytical_flops", "analytical_bytes"]


@dataclasses.dataclass
class FlopReport:
    total: float            # implementation flops for the step
    ideal: float            # with causal-skip + top-k-only MoE dispatch
    model_flops_6nd: float  # 6 * N_active * tokens (the MFU yardstick)
    breakdown: dict


def _attn_flops(cfg: ModelConfig, n_tok: float, s_att: float) -> float:
    """One attention layer, forward, for n_tok query tokens attending s_att."""
    d, hd, H, Hk = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    proj = 2 * n_tok * d * hd * (H + 2 * Hk) + 2 * n_tok * H * hd * d
    scores = 2 * n_tok * s_att * H * hd * 2   # QK^T and PV
    return proj + scores


def _mlp_flops(cfg: ModelConfig, n_tok: float, moe: bool,
               moe_mult: float) -> float:
    mats = 3 if cfg.act_gated else 2
    base = 2 * n_tok * cfg.d_model * cfg.d_ff * mats
    if not moe:
        return base
    return base * moe_mult + 2 * n_tok * cfg.d_model * cfg.n_experts  # router


def _mamba_flops(cfg: ModelConfig, n_tok: float) -> float:
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_d_state
    dt_rank = max(1, -(-d // 16))
    proj = 2 * n_tok * d * 2 * di + 2 * n_tok * di * (dt_rank + 2 * ds) \
        + 2 * n_tok * dt_rank * di + 2 * n_tok * di * d
    conv = 2 * n_tok * 4 * di
    scan = n_tok * di * ds * 7  # exp + 2 fma updates + C contraction
    return proj + conv + scan


def _rwkv_flops(cfg: ModelConfig, n_tok: float) -> float:
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    lora = 64
    proj = 2 * n_tok * d * d * 5 + 2 * n_tok * (d * lora * 2)
    wkv = n_tok * d * hd * 5     # outer product + state update + readout
    ffn = 2 * n_tok * d * cfg.d_ff * 2 + 2 * n_tok * d * d
    return proj + wkv + ffn


def _layer_flops(cfg: ModelConfig, spec, n_tok: float, s_att: float,
                 moe_mult: float) -> float:
    if spec.kind == LayerKind.ATTN:
        f = _attn_flops(cfg, n_tok, s_att)
    elif spec.kind == LayerKind.MAMBA:
        f = _mamba_flops(cfg, n_tok)
    else:
        return _rwkv_flops(cfg, n_tok)  # includes its channel-mix ffn
    f += _mlp_flops(cfg, n_tok, spec.moe, moe_mult)
    if cfg.cross_attention:
        f += _attn_flops(cfg, n_tok, cfg.frontend_len)
    return f


def analytical_flops(cfg: ModelConfig, shape_name: str) -> FlopReport:
    sp = SHAPES[shape_name]
    B, S = sp.global_batch, sp.seq_len
    kind = sp.kind

    if kind == "decode":
        n_tok = float(B)         # one new token per sequence
        # ring-buffered SWA caches only hold W slots
        s_att = float(min(S, cfg.sliding_window or S))
        s_att_ideal = s_att
        fwd_mult, head_mult = 1.0, 1.0
    elif kind == "prefill":
        n_tok = float(B * S)
        s_att = float(S)         # implementation: full masked matrix
        s_att_ideal = S / 2.0
        fwd_mult, head_mult = 1.0, 1.0
    else:  # train
        n_tok = float(B * S)
        s_att = float(S)
        s_att_ideal = S / 2.0
        fwd_mult, head_mult = 4.0, 3.0  # fwd + remat + bwd / no-remat head

    if cfg.sliding_window:
        s_att_ideal = min(s_att_ideal, float(cfg.sliding_window))
        if cfg.swa_chunk_skip and kind != "decode":
            # windowed chunk selection visits ~W + 2 chunks per Q chunk
            cq, ckv = 128, 1024
            s_att = min(s_att, float(
                (min(S, (cfg.sliding_window + cq - 2) // ckv * ckv + 2 * ckv))))

    # sorted MoE dispatch cuts the dense-loop E/topk redundancy to cf
    moe_mult_impl = (cfg.n_experts if cfg.moe_dispatch == "dense"
                     else cfg.experts_per_token * 1.25)

    per_period = sum(_layer_flops(cfg, s, n_tok, s_att, moe_mult_impl)
                     for s in cfg.period())
    per_period_ideal = sum(
        _layer_flops(cfg, s, n_tok, min(s_att, s_att_ideal)
                     if s.kind == LayerKind.ATTN else s_att,
                     float(cfg.experts_per_token))
        for s in cfg.period())
    blocks = per_period * cfg.n_periods
    blocks_ideal = per_period_ideal * cfg.n_periods

    enc = 0.0
    if cfg.encoder_layers:
        M = cfg.frontend_len
        n_enc_tok = float(B * M)
        enc = cfg.encoder_layers * (_attn_flops(cfg, n_enc_tok, M)
                                    + _mlp_flops(cfg, n_enc_tok, False, False))
        if kind == "decode":
            enc = 0.0  # encoder ran at prefill; decode reuses the cache

    head = 2 * n_tok * cfg.d_model * cfg.vocab_size
    total = fwd_mult * (blocks + enc) + head_mult * head
    ideal = fwd_mult * (blocks_ideal + enc) + head_mult * head

    n_active = cfg.active_params()
    model = 6.0 * n_active * n_tok if kind == "train" else \
        2.0 * n_active * n_tok
    return FlopReport(
        total=total, ideal=ideal, model_flops_6nd=model,
        breakdown={"blocks": fwd_mult * blocks, "encoder": fwd_mult * enc,
                   "head": head_mult * head, "tokens": n_tok})


def analytical_bytes(cfg: ModelConfig, shape_name: str) -> dict:
    """Coarse global HBM-traffic model (documents the memory roofline term)."""
    sp = SHAPES[shape_name]
    B, S = sp.global_batch, sp.seq_len
    bpe = 2  # bf16
    p_total = cfg.total_params()
    if sp.kind == "train":
        # fwd + remat reads, grad write+read, AdamW m/v read+write (f32)
        traffic = p_total * bpe * 3 + p_total * bpe * 2 + p_total * 4 * 4
        act = B * S * cfg.d_model * cfg.n_layers * 4 * bpe
        return {"total": traffic + act, "params": p_total * bpe}
    if sp.kind == "prefill":
        cache = 2 * B * S * cfg.n_kv_heads * cfg.hd * bpe * \
            max(1, cfg.attn_layers_per_period()) * cfg.n_periods
        return {"total": p_total * bpe + cache, "params": p_total * bpe}
    # decode: weights + full cache read per token
    cache = 2 * B * S * cfg.n_kv_heads * cfg.hd * bpe * \
        max(1, cfg.attn_layers_per_period()) * cfg.n_periods
    return {"total": p_total * bpe + cache, "params": p_total * bpe,
            "cache": cache}
