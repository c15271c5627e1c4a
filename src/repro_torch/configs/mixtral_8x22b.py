"""mixtral-8x22b [moe] — 8 experts top-2, SWA [arXiv:2401.04088; hf].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    train_accum=16,
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=32768, head_dim=128,
    n_experts=8, experts_per_token=2, moe_period=1,
    rope_theta=1e6, sliding_window=4096, act="silu",
    # bit-exact perf lever (the JAX package's tests/test_perf_levers.py):
    # each Q chunk visits only the KV chunks inside its window
    swa_chunk_skip=True,
)

SMOKE = ModelConfig(
    name="mixtral-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16,
    n_experts=4, experts_per_token=2, moe_period=1,
    sliding_window=8, act="silu", dtype="float32",
)
