"""Unified model configuration covering all assigned architecture families.

One ``ModelConfig`` describes dense/GQA transformers, MoE, SSM (Mamba/RWKV6),
hybrids (Jamba), encoder-decoder (Whisper) and stub-frontend VLMs
(PaliGemma).  The layer stack is expressed as a repeating *period* of layer
descriptors so heterogeneous stacks (Jamba's 1:7 attention:mamba interleave
with alternating MoE) still scan over uniform parameter pytrees.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence


class LayerKind(enum.Enum):
    ATTN = "attn"
    MAMBA = "mamba"
    RWKV = "rwkv"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: LayerKind
    moe: bool  # MoE MLP (else dense MLP)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_period: int = 1            # every `moe_period`-th layer is MoE
    # attention
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    sliding_window: int | None = None
    attn_period: int = 1           # hybrid: one attn layer per period
    causal: bool = True
    # ssm
    ssm_kind: str | None = None    # 'mamba' | 'rwkv6'
    ssm_d_state: int = 16
    ssm_expand: int = 2
    rwkv_head_dim: int = 64
    # encoder-decoder / modality frontends (stubs)
    encoder_layers: int = 0
    cross_attention: bool = False
    frontend: str | None = None    # 'audio_stub' | 'vision_stub'
    frontend_len: int = 0
    # misc
    norm_eps: float = 1e-5
    act: str = "silu"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # training: gradient-accumulation microbatches (activation-memory lever)
    train_accum: int = 1
    # perf levers: MoE dispatch strategy and
    # sliding-window KV-chunk skipping in flash attention
    moe_dispatch: str = "dense"   # "dense" (baseline) | "sorted"
    moe_capacity_factor: float = 1.25
    swa_chunk_skip: bool = False
    sp_reduce_scatter: bool = False  # sublayer outputs → seq-sharded domain
    sp_residual: bool = True  # seq-shard the saved period carry (SP);
    # False trades checkpoint memory for fewer gathers (SSM-heavy stacks
    # re-gather the full sequence at every recurrence anyway)

    # ---- derived ---------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def period(self) -> tuple[LayerSpec, ...]:
        """Layer descriptors for one repeating period of the stack."""
        if self.ssm_kind == "rwkv6":
            return (LayerSpec(LayerKind.RWKV, moe=False),)
        plen = max(self.attn_period, self.moe_period)
        specs = []
        for i in range(plen):
            if self.ssm_kind == "mamba":
                # hybrid (Jamba): attention once per attn_period, mid-period
                kind = (LayerKind.ATTN
                        if self.attn_period > 1 and i == self.attn_period // 2
                        else LayerKind.MAMBA)
            else:
                kind = LayerKind.ATTN
            moe = self.n_experts > 0 and (i % self.moe_period
                                          == self.moe_period - 1)
            specs.append(LayerSpec(kind, moe))
        return tuple(specs)

    @property
    def n_periods(self) -> int:
        plen = len(self.period())
        assert self.n_layers % plen == 0, (self.n_layers, plen)
        return self.n_layers // plen

    def attn_layers_per_period(self) -> int:
        return sum(1 for s in self.period() if s.kind == LayerKind.ATTN)

    def active_params(self) -> float:
        """Active parameter count (for MODEL_FLOPS = 6*N_active*D).

        MoE layers count only the ``experts_per_token`` activated experts;
        ``total_params`` counts them all.
        """
        return self._param_count(active_only=True)

    def total_params(self) -> float:
        return self._param_count(active_only=False)

    def _param_count(self, active_only: bool) -> float:
        d, ff, hd = self.d_model, self.d_ff, self.hd
        n_q, n_kv = self.n_heads, self.n_kv_heads
        mlp_mats = 3 if self.act_gated else 2
        per_params = 0.0
        for spec in self.period():
            if spec.kind == LayerKind.ATTN:
                per_params += d * hd * (n_q + 2 * n_kv) + n_q * hd * d
            elif spec.kind == LayerKind.MAMBA:
                di, ds = self.d_inner, self.ssm_d_state
                per_params += d * 2 * di + di * (2 * ds + 2) + di * d
            else:  # rwkv6: r,k,v,g,o projections + decay/mix LoRAs (~d*d)
                per_params += 6 * d * d
            if spec.moe:
                ne = self.experts_per_token if active_only else self.n_experts
                per_params += ne * mlp_mats * d * ff + d * self.n_experts
            else:
                per_params += mlp_mats * d * ff
        enc = 0.0
        if self.encoder_layers:
            enc = self.encoder_layers * (
                d * hd * (n_q + 2 * n_kv) + n_q * hd * d + 2 * d * ff)
        cross = 0.0
        if self.cross_attention:  # one cross-attn block per decoder layer
            cross = self.n_layers * (d * hd * (n_q + 2 * n_kv) + n_q * hd * d)
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return emb + enc + cross + per_params * self.n_periods

    @property
    def act_gated(self) -> bool:
        return self.act in ("silu", "geglu")


def validate(cfg: ModelConfig) -> ModelConfig:
    assert cfg.n_heads % cfg.n_kv_heads == 0 or cfg.n_kv_heads > cfg.n_heads
    cfg.period()
    _ = cfg.n_periods
    return cfg
