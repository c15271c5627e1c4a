"""The train step: loss → grads (accumulated over microbatches) →
(optional int8 compression) → AdamW.

The port of the JAX package's ``training/train_step.py`` on one device.
Each microbatch's gradients come from ``torch.autograd.grad`` on detached
copies of the parameters that require grad, never through ``.grad``
(which would accumulate bf16 gradients in bf16).  With ``accum > 1`` they
are added as ``g.float() / accum`` into f32 buffers and the loss as
``l / accum``, as JAX's scan does; with ``accum == 1`` they stay in the
parameters' dtype.  The mesh's gradient shardings and the dry-run's
``state_specs`` belong to the multi-device work and have no counterpart.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.training.grad_compress import (compress_tree,
                                                decompress_tree, init_error)
from repro_torch.training.optimizer import AdamW, AdamWState
from repro_torch.training.tree import leaves, unflatten

__all__ = ["TrainState", "make_train_step", "init_state"]


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    err: Any | None  # error-feedback buffers (None if compression off)


def make_train_step(cfg: ModelConfig, optimizer: AdamW,
                    compress: bool = False, accum: int | None = None):
    """Returns train_step(state, batch) → (state, metrics).

    ``accum`` microbatches (default: ``cfg.train_accum``) split the batch
    (its frontend too) along axis 0 into equal consecutive parts; live
    activation memory scales with B/accum.  ``metrics`` holds ``loss``,
    ``grad_norm`` and ``step`` as tensors on the parameters' device.
    """
    accum = cfg.train_accum if accum is None else accum

    def value_and_grad(params, batch):
        req = [p.detach().requires_grad_() for p in leaves(params)]
        with torch.enable_grad():
            loss = lm.loss_fn(cfg, unflatten(params, req), batch["tokens"],
                              batch["labels"], batch.get("frontend"))
            grads = torch.autograd.grad(loss, req, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), list(grads)

    def train_step(state: TrainState, batch: dict):
        if accum == 1:
            loss_val, grads = value_and_grad(state.params, batch)
        else:
            mb = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                  for k, v in batch.items()}
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                     for p in leaves(state.params)]
            loss_val = torch.zeros((), dtype=torch.float32,
                                   device=grads[0].device)
            for i in range(accum):
                loss_i, g = value_and_grad(state.params,
                                           {k: v[i] for k, v in mb.items()})
                for acc, gi in zip(grads, g):
                    acc += gi.float() / accum
                del g
                loss_val = loss_val + loss_i / accum
        grads = unflatten(state.params, grads)
        err = state.err
        if compress:
            q, s, err = compress_tree(grads, state.err)
            grads = decompress_tree(q, s)
        params, opt, gnorm = optimizer.update(grads, state.opt, state.params)
        metrics = {"loss": loss_val, "grad_norm": gnorm, "step": opt.step}
        return TrainState(params, opt, err), metrics

    return train_step


def init_state(cfg: ModelConfig, optimizer: AdamW, gen: torch.Generator,
               compress: bool = False) -> TrainState:
    """Parameters from ``gen`` (on its device), zero moments and, with
    ``compress``, zero error buffers."""
    params = lm.init_params(cfg, gen)
    return TrainState(params, optimizer.init(params),
                      init_error(params) if compress else None)
