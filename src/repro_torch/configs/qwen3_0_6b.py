"""qwen3-0.6b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=3072,
    vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6, act="silu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16,
    qk_norm=True, tie_embeddings=True, dtype="float32",
)
