"""Time scans for the SSM/RWKV recurrences, with remat over time chunks.

The port of the JAX package's ``models/scan_utils.py``.  A plain scan
over T timesteps saves its carry (the recurrent state) at every step for
the backward pass — for RWKV6 at train_4k that is 4096 x (B, H, hd, hd)
f32 per layer.  When autograd records, ``chunked_scan`` steps the loop in
chunks of ``DEFAULT_CHUNK`` steps and wraps each chunk in
``torch.utils.checkpoint`` (non-reentrant, so the parameters the step
reads from its closure get their gradients): only chunk-boundary carries
are saved, and the backward recomputes inside each chunk.  JAX pads the
time axis to a chunk multiple and makes the padded steps identity; the
loop here stops at the T real steps, which is the same result.  Outside
autograd (prefill, decode) the loop runs unchunked.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["DEFAULT_CHUNK", "chunked_scan"]

DEFAULT_CHUNK = 256


def _scan(step, carry, xs):
    ys = []
    for t in range(xs[0].shape[0]):
        carry, y = step(carry, tuple(a[t] for a in xs))
        ys.append(y)
    return carry, torch.stack(ys)


def _records(step, init, xs) -> bool:
    """Whether autograd records the scan: grad mode on and a tensor the
    step reads (its carry, its inputs or its closure) requires grad."""
    if not torch.is_grad_enabled():
        return False
    captured = [c.cell_contents for c in step.__closure__ or ()]
    return any(isinstance(t, torch.Tensor) and t.requires_grad
               for t in (init, *xs, *captured))


def chunked_scan(step, init, xs):
    """``(carry, ys)`` of ``step(carry, x_t) -> (carry, y_t)`` over t.

    xs: a tuple of (T, ...) tensors, stepped together along axis 0; ys
    stacks the per-step outputs to (T, ...).  When autograd records, each
    ``DEFAULT_CHUNK`` steps are recomputed in the backward pass instead
    of saved.
    """
    if not _records(step, init, xs):
        return _scan(step, init, xs)
    carry, ys = init, []
    for lo in range(0, xs[0].shape[0], DEFAULT_CHUNK):
        carry, y = checkpoint(_scan, step, carry,
                              tuple(a[lo:lo + DEFAULT_CHUNK] for a in xs),
                              use_reentrant=False, preserve_rng_state=False)
        ys.append(y)
    return carry, torch.cat(ys)
