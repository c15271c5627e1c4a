"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16e top-2.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    train_accum=8,
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab_size=32064, head_dim=128,
    n_experts=16, experts_per_token=2, moe_period=1,
    rope_theta=1e4, act="silu",
)

SMOKE = ModelConfig(
    name="phi3.5-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=256, head_dim=16,
    n_experts=4, experts_per_token=2, moe_period=1,
    act="silu", dtype="float32",
)
