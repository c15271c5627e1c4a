"""AdamW with f32 moments over (possibly bf16) parameters.

The port of the JAX package's ``training/optimizer.py``, written out by
hand: the update math runs in f32 and the new value is cast back to the
parameter's dtype (no f32 master copy), every leaf is decayed (norms and
the f32 router included), and the gradients are clipped by their global
norm, summed over the leaves in JAX's order.  ``torch.optim.AdamW`` keeps
its moments in the parameter's dtype and has no global-norm clip.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.training.tree import leaves, tree_map, unflatten

__all__ = ["AdamWState", "AdamW"]


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        """Zero moments (f32) on each parameter's device."""
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        step = torch.zeros((), dtype=torch.int32,
                           device=leaves(params)[0].device)
        return AdamWState(step=step, m=tree_map(zeros, params),
                          v=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """``(new params, new state, global gradient norm)``; the inputs
        are not modified."""
        step = state.step + 1
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in leaves(grads)))
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-12), max=1.0)
        sf = step.float()
        bc1 = 1 - self.b1 ** sf
        bc2 = 1 - self.b2 ** sf

        def upd(p, g, m, v):
            gf = g.float() * scale
            m = self.b1 * m + (1 - self.b1) * gf
            v = self.b2 * v + (1 - self.b2) * gf * gf
            mh = m / bc1
            vh = v / bc2
            delta = mh / (torch.sqrt(vh) + self.eps)
            delta = delta + self.weight_decay * p.float()
            return (p.float() - self.lr * delta).to(p.dtype), m, v

        out = [upd(p, g, m, v) for p, g, m, v in
               zip(leaves(params), leaves(grads), leaves(state.m),
                   leaves(state.v))]
        new_p = unflatten(params, [o[0] for o in out])
        new_m = unflatten(params, [o[1] for o in out])
        new_v = unflatten(params, [o[2] for o in out])
        return new_p, AdamWState(step=step, m=new_m, v=new_v), gnorm
