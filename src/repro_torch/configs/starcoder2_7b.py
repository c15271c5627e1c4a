"""starcoder2-7b [dense] — GQA, RoPE [arXiv:2402.19173; hf].

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
Note: 36 heads do not divide the 16-way model axis — the sharding policy
falls back per-dim in the JAX package's ``models/sharding.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    train_accum=8,
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_ff=18432,
    vocab_size=49152, head_dim=128,
    rope_theta=1e5, act="gelu",
)

SMOKE = ModelConfig(
    name="starcoder2-smoke", family="dense",
    n_layers=2, d_model=72, n_heads=6, n_kv_heads=2, d_ff=160,
    vocab_size=256, head_dim=12, act="gelu", dtype="float32",
)
