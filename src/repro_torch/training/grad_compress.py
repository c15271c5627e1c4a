"""int8 gradient compression with error feedback.

The port of the JAX package's ``training/grad_compress.py``: each leaf
plus its carried error is quantized to int8 with one f32 scale per leaf
(``max |g + err| / 127``, rounded half to even as ``jnp.round`` does), and
the quantization error is carried into the next step (EF-SGD).  On one
card nothing crosses a link; the step runs the round trip so its result
is the compressed step's.
"""
from __future__ import annotations

import torch

from repro_torch.training.tree import leaves, tree_map, unflatten

__all__ = ["compress_leaf", "compress_tree", "decompress_tree", "init_error"]


def compress_leaf(g: torch.Tensor, err: torch.Tensor):
    """Quantize g+err to int8 (symmetric), return (q, scale, new_err)."""
    gf = g.float() + err
    scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, gf - deq


def compress_tree(grads, err_tree):
    """``(q, scales, new errors)``, each a tree shaped like ``grads``."""
    out = [compress_leaf(g, e)
           for g, e in zip(leaves(grads), leaves(err_tree))]
    return tuple(unflatten(grads, [o[i] for o in out]) for i in range(3))


def decompress_tree(q, s):
    return tree_map(lambda qi, si: qi.float() * si, q, s)


def init_error(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
