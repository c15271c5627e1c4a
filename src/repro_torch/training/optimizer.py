"""AdamW with f32 moments over (possibly bf16) parameters.

The port of the JAX package's ``training/optimizer.py``, written out by
hand: the update math runs in f32 and the new value is cast back to the
parameter's dtype (no f32 master copy), every leaf is decayed (norms and
the f32 router included), and the gradients are clipped by their global
norm, summed over the leaves in JAX's order.  ``torch.optim.AdamW`` keeps
its moments in the parameter's dtype and has no global-norm clip.

On a mesh (:mod:`repro_torch.models.sharding`) the moments inherit each
parameter's sharding, as in JAX (ZeRO: FSDP-sharded parameters give
sharded optimizer state).  :meth:`AdamW.apply` updates a
:class:`~repro_torch.models.sharding.Sharded` leaf shard by shard, each on
its own device; the update is elementwise, so a shard's new values are
bitwise the whole leaf's slice.  The global norm is taken over whole
leaves (:func:`global_norm`): per-shard partial sums would change its bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models.sharding import Sharded
from repro_torch.training.tree import leaves, tree_map, unflatten

__all__ = ["AdamWState", "AdamW", "global_norm"]


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

    def init_specs(self, param_specs) -> AdamWState:
        """Allocation-free state for ``param_specs`` (``meta`` tensors)."""
        return self.init(param_specs)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """``(new params, new state, global gradient norm)``; the inputs
        are not modified."""
        gnorm = global_norm(grads)
        new_p, new_state = self.apply(grads, state, params, gnorm)
        return new_p, new_state, gnorm

    @torch.no_grad()
    def apply(self, grads, state: AdamWState, params, gnorm):
        """The update with the global norm ``gnorm`` given: ``(new params,
        new state)``.  A :class:`Sharded` leaf (its gradient and moments
        laid out alike) is updated shard by shard on each shard's
        device."""
        step = state.step + 1
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-12), max=1.0)
        sf = step.float()
        bc1 = 1 - self.b1 ** sf
        bc2 = 1 - self.b2 ** sf
        on = {}

        def consts(dev):
            if dev not in on:
                on[dev] = tuple(t.to(dev) for t in (scale, bc1, bc2))
            return on[dev]

        def upd(p, g, m, v):
            scale, bc1, bc2 = consts(p.device)
            gf = g.float() * scale
            m = self.b1 * m + (1 - self.b1) * gf
            v = self.b2 * v + (1 - self.b2) * gf * gf
            mh = m / bc1
            vh = v / bc2
            delta = mh / (torch.sqrt(vh) + self.eps)
            delta = delta + self.weight_decay * p.float()
            return (p.float() - self.lr * delta).to(p.dtype), m, v

        def leaf(p, g, m, v):
            if not isinstance(p, Sharded):
                return upd(p, g, m, v)
            outs = [upd(*x) for x in zip(p.shards, g.shards, m.shards,
                                         v.shards)]
            return tuple(Sharded(x.sharding, x.shape,
                                 tuple(o[i] for o in outs))
                         for i, x in enumerate((p, m, v)))

        out = [leaf(p, g, m, v) for p, g, m, v in
               zip(leaves(params), leaves(grads), leaves(state.m),
                   leaves(state.v))]
        new_p = unflatten(params, [o[0] for o in out])
        new_m = unflatten(params, [o[1] for o in out])
        new_v = unflatten(params, [o[2] for o in out])
        return new_p, AdamWState(step=step, m=new_m, v=new_v)


def global_norm(grads) -> torch.Tensor:
    """``sqrt`` of the sum over the leaves (JAX's order) of each whole
    leaf's ``sum(g.float() ** 2)``."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(grads)))
