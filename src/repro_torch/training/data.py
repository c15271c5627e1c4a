"""Deterministic synthetic data pipeline.

The port's own copy of the JAX package's ``training/data.py``: the numpy
draws are the same, so the tokens, labels and stub frontend embeddings
equal JAX's bit for bit; the tensors are made on the caller's device.
Stateless by construction: ``batch_at(cfg, step)`` is a pure function, so
a restarted job resumes mid-epoch exactly (no iterator to checkpoint).
The token stream mixes Zipf-distributed unigrams with short repeated
motifs, so the LM loss has learnable structure.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.env import resolve_device

__all__ = ["DataConfig", "batch_at"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 8
    frontend_len: int = 0   # >0: also emit stub modality embeddings
    d_model: int = 0


def batch_at(cfg: DataConfig, step: int, device="cuda") -> dict:
    """Batch for `step`: tokens/labels (B, S) int32 (+ optional frontend
    (B, frontend_len, d_model) f32), on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    # Zipf unigrams (clipped) + motif insertions
    ranks = rng.zipf(1.3, size=(B, S + 1))
    tokens = np.minimum(ranks - 1, V - 1).astype(np.int32)
    n_motifs = max(1, S // (4 * cfg.motif_len))
    for b in range(B):
        motif = rng.integers(0, V, cfg.motif_len)
        for _ in range(n_motifs):
            at = rng.integers(0, S + 1 - cfg.motif_len)
            tokens[b, at:at + cfg.motif_len] = motif
    out = {"tokens": torch.from_numpy(tokens[:, :-1].copy()).to(dev),
           "labels": torch.from_numpy(tokens[:, 1:].copy()).to(dev)}
    if cfg.frontend_len:
        fe = rng.standard_normal((B, cfg.frontend_len, cfg.d_model)) * 0.02
        out["frontend"] = torch.as_tensor(fe, dtype=torch.float32,
                                          device=dev)
    return out
