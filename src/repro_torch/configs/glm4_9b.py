"""glm4-9b [dense] — RoPE, GQA kv=2 [hf:THUDM/glm-4-9b; hf].

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    train_accum=4,
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab_size=151552, head_dim=128,
    rope_theta=1e4, act="silu",
)

SMOKE = ModelConfig(
    name="glm4-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab_size=512, head_dim=16, dtype="float32",
)
