"""whisper-medium [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356].

24L (decoder; + 24L encoder) d_model=1024 16H d_ff=4096 vocab=51865.
The mel/conv frontend is a STUB — the caller
provides precomputed frame embeddings (B, 1500, d_model) to the encoder.
kv=16 (full MHA, as published).
"""
from repro_torch.models.config import ModelConfig

N_FRAMES = 1500

CONFIG = ModelConfig(
    train_accum=4,
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab_size=51865, head_dim=64,
    encoder_layers=24, cross_attention=True,
    frontend="audio_stub", frontend_len=N_FRAMES, act="gelu",
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, head_dim=16,
    encoder_layers=2, cross_attention=True,
    frontend="audio_stub", frontend_len=16, act="gelu", dtype="float32",
)
