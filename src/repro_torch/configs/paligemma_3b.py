"""paligemma-3b [vlm] — SigLIP + gemma [arXiv:2407.07726; hf].

Backbone only: 18L d_model=2048 8H (GQA kv=1, MQA)
d_ff=16384 vocab=257216.  The SigLIP vision tower is a STUB —
the caller provides precomputed patch embeddings (B, 256, d_model)
prepended to the text sequence.
"""
from repro_torch.models.config import ModelConfig

N_PATCHES = 256

CONFIG = ModelConfig(
    train_accum=2,
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab_size=257216, head_dim=256,
    rope_theta=1e4, act="geglu", tie_embeddings=True,
    frontend="vision_stub", frontend_len=N_PATCHES,
)

SMOKE = ModelConfig(
    name="paligemma-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab_size=256, head_dim=16, act="geglu", tie_embeddings=True,
    frontend="vision_stub", frontend_len=8, dtype="float32",
)
