"""rwkv6-1.6b [ssm] — Finch, data-dependent decay [arXiv:2404.05892].

24L d_model=2048 (attn-free) d_ff=7168 vocab=65536.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=7168,
    vocab_size=65536,
    ssm_kind="rwkv6", rwkv_head_dim=64, act="silu",
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256,
    ssm_kind="rwkv6", rwkv_head_dim=16, dtype="float32",
)
