"""Time scans for the SSM/RWKV recurrences.

The port of the forward semantics of the JAX package's
``models/scan_utils.py``: ``chunked_scan`` there pads the time axis to a
chunk multiple, makes the padded steps identity and takes the carry at
the true last step, so its result is that of a plain scan over the T real
steps, which is what this loop runs.  Its chunked remat (only
chunk-boundary states saved for the backward pass) belongs to training.
"""
from __future__ import annotations

import torch

__all__ = ["chunked_scan"]


def chunked_scan(step, init, xs):
    """``(carry, ys)`` of ``step(carry, x_t) -> (carry, y_t)`` over t.

    xs: a tuple of (T, ...) tensors, stepped together along axis 0; ys
    stacks the per-step outputs to (T, ...).
    """
    carry, ys = init, []
    for t in range(xs[0].shape[0]):
        carry, y = step(carry, tuple(a[t] for a in xs))
        ys.append(y)
    return carry, torch.stack(ys)
