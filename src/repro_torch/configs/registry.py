"""Architecture registry: the ten assigned configs, their smoke cuts, and
allocation-free input specs for every cell.

The port's copy of the JAX package's ``configs/registry.py``.
``input_specs(arch, shape)`` returns ``meta`` tensors standing in for
every input of a cell's step (tokens/labels for train, token+cache for
decode), so the sharding policy can lay out every full ``CONFIG`` without
allocating it.  ``cell_is_skipped`` encodes the long_500k policy (skip
pure full-attention archs).
"""
from __future__ import annotations

from repro_torch.configs import shapes as _shapes
from repro_torch.configs.glm4_9b import CONFIG as _glm4, SMOKE as _glm4_s
from repro_torch.configs.granite_3_8b import (CONFIG as _granite,
                                              SMOKE as _granite_s)
from repro_torch.configs.jamba_v01 import CONFIG as _jamba, SMOKE as _jamba_s
from repro_torch.configs.mixtral_8x22b import (CONFIG as _mixtral,
                                               SMOKE as _mixtral_s)
from repro_torch.configs.paligemma_3b import CONFIG as _pali, SMOKE as _pali_s
from repro_torch.configs.phi35_moe import CONFIG as _phi, SMOKE as _phi_s
from repro_torch.configs.qwen3_0_6b import CONFIG as _qwen3, SMOKE as _qwen3_s
from repro_torch.configs.rwkv6_1b6 import CONFIG as _rwkv, SMOKE as _rwkv_s
from repro_torch.configs.starcoder2_7b import CONFIG as _sc2, SMOKE as _sc2_s
from repro_torch.configs.whisper_medium import (CONFIG as _whisper,
                                                SMOKE as _whisper_s)
import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype

SHAPES = _shapes.SHAPES

ARCHS: dict[str, ModelConfig] = {
    "mixtral-8x22b": _mixtral,
    "phi3.5-moe-42b-a6.6b": _phi,
    "rwkv6-1.6b": _rwkv,
    "jamba-v0.1-52b": _jamba,
    "granite-3-8b": _granite,
    "glm4-9b": _glm4,
    "qwen3-0.6b": _qwen3,
    "starcoder2-7b": _sc2,
    "paligemma-3b": _pali,
    "whisper-medium": _whisper,
}

SMOKES: dict[str, ModelConfig] = {
    "mixtral-8x22b": _mixtral_s,
    "phi3.5-moe-42b-a6.6b": _phi_s,
    "rwkv6-1.6b": _rwkv_s,
    "jamba-v0.1-52b": _jamba_s,
    "granite-3-8b": _granite_s,
    "glm4-9b": _glm4_s,
    "qwen3-0.6b": _qwen3_s,
    "starcoder2-7b": _sc2_s,
    "paligemma-3b": _pali_s,
    "whisper-medium": _whisper_s,
}

# archs whose every attention layer is full (unwindowed) softmax attention —
# long_500k is skipped for these (needs sub-quadratic attention)
FULL_ATTENTION = {"granite-3-8b", "glm4-9b", "qwen3-0.6b", "starcoder2-7b",
                  "paligemma-3b", "whisper-medium", "phi3.5-moe-42b-a6.6b"}


def get_config(arch: str) -> ModelConfig:
    return ARCHS[arch]


def get_smoke_config(arch: str) -> ModelConfig:
    return SMOKES[arch]


def cell_is_skipped(arch: str, shape: str) -> str | None:
    """Return a reason string if (arch, shape) is skipped, else None."""
    if shape == "long_500k" and arch in FULL_ATTENTION:
        return "long_500k needs sub-quadratic attention; pure full-attention arch"
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _frontend_spec(cfg: ModelConfig, batch: int):
    if cfg.frontend is None:
        return None
    return _meta((batch, cfg.frontend_len, cfg.d_model),
                 torch_dtype(cfg.dtype))


def input_specs(arch: str, shape: str, cfg: ModelConfig | None = None) -> dict:
    """``meta`` tensors standing in for the step inputs of one cell."""
    cfg = cfg or get_config(arch)
    spec = SHAPES[shape]
    B, S = spec.global_batch, spec.seq_len
    i32 = torch.int32
    out: dict = {}
    if spec.kind == "train":
        out["tokens"] = _meta((B, S), i32)
        out["labels"] = _meta((B, S), i32)
        fe = _frontend_spec(cfg, B)
        if fe is not None:
            out["frontend"] = fe
    elif spec.kind == "prefill":
        out["tokens"] = _meta((B, S), i32)
        fe = _frontend_spec(cfg, B)
        if fe is not None:
            out["frontend"] = fe
    else:  # decode: one new token against a cache of seq_len
        out["tokens_last"] = _meta((B, 1), i32)
        out["pos"] = _meta((), i32)
        mem_len = cfg.frontend_len if cfg.cross_attention else 0
        out["cache"] = lm.cache_specs(cfg, B, S, memory_len=mem_len)
    return out
