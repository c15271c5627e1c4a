"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.
Period of 8 layers: attention at mid-period (1:7 ratio), MoE every 2nd layer.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    train_accum=16,
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=65536, head_dim=128,
    n_experts=16, experts_per_token=2, moe_period=2,
    ssm_kind="mamba", ssm_d_state=16, ssm_expand=2,
    attn_period=8, act="silu",
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=256, head_dim=16,
    n_experts=4, experts_per_token=2, moe_period=2,
    ssm_kind="mamba", ssm_d_state=4, ssm_expand=2,
    attn_period=8, dtype="float32",
)
