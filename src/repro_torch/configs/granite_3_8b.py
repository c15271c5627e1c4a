"""granite-3-8b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base; hf].

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    train_accum=8,
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12800,
    vocab_size=49155, head_dim=128,
    rope_theta=1e4, act="silu",
)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16, dtype="float32",
)
