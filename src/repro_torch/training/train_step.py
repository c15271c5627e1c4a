"""The train step: loss → grads (accumulated over microbatches) →
(optional int8 compression) → AdamW, on one device or over a mesh.

The port of the JAX package's ``training/train_step.py``.  Each
microbatch's gradients come from ``torch.autograd.grad`` on detached
copies of the parameters that require grad, never through ``.grad``
(which would accumulate bf16 gradients in bf16).  With ``accum > 1`` they
are added as ``g.float() / accum`` into f32 buffers and the loss as
``l / accum``, as JAX's scan does; with ``accum == 1`` they stay in the
parameters' dtype.

**On a mesh.**  A state placed by :func:`shard_state` holds, at every
position of a :class:`~repro_torch.launch.mesh.DeviceMesh`, only its
shard (``param_shardings``) of every parameter, of AdamW's ``m`` and
``v`` and, with compression, of the error buffers.  The step is
data-parallel over ``dp_axes(mesh)``: with ``D`` data rows, microbatch
``i`` of ``accum`` spans the rows, as JAX's reshape of the globally
sharded batch does, and row ``r`` takes its contiguous slice of it (the
``batch_shardings`` layout) on its first device, where the parameters are
gathered from the shards once a step.  The rows' gradients are summed on
the mesh's first device in a fixed order, microbatch outer and row inner,
``g.float() / (accum * D)`` each (no atomics), so a mesh step performs
the arithmetic of the one-device step at ``accum * D`` bitwise.  The sum
(compressed there, against the gathered error buffers, when ``compress``)
gives the global norm over whole leaves, is scattered to
``grad_shardings`` (default: the parameters' shardings; JAX's meaning:
where the reduced gradient lives before the update), and AdamW updates
each shard on its own device.  The ``model`` axis splits storage only:
tensor-parallel products over ``model`` (Megatron-style column/row
splits with their reductions) are the next item of the LM mesh work
(ROADMAP), so every row computes with whole parameters.
:func:`mesh_step_moves` composes the bytes a mesh step moves from the
specs alone, without running it (the dry-run's ``moves``).
"""
from __future__ import annotations

import itertools
import math
from typing import Any, NamedTuple

import torch

from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MetaGenerator
from repro_torch.models.sharding import (MoveStats, Sharded, dp_axes,
                                         move_plan, param_shardings, reshard,
                                         shard, sharded_leaves, unshard,
                                         unshard_moves)
from repro_torch.training.grad_compress import (compress_tree,
                                                decompress_tree, init_error)
from repro_torch.training.optimizer import AdamW, AdamWState, global_norm
from repro_torch.training.tree import leaves, tree_map, unflatten

__all__ = ["TrainState", "MeshStepStats", "make_train_step", "init_state",
           "state_specs", "shard_state", "unshard_state", "data_rows",
           "mesh_step_moves"]


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    err: Any | None  # error-feedback buffers (None if compression off)


class MeshStepStats(NamedTuple):
    """Bytes one mesh step copied between positions (``MoveStats``):
    ``gather`` the parameters onto the data rows' devices, ``reduce`` the
    rows' gradients to the mesh's first device (and, with compression,
    the error buffers gathered there), ``scatter`` the reduced gradient
    (and new error buffers) to their shards, ``relayout`` the gradient
    from ``grad_shardings`` to the parameters' shardings."""

    gather: MoveStats
    reduce: MoveStats
    scatter: MoveStats
    relayout: MoveStats


def data_rows(mesh: DeviceMesh) -> list[tuple[int, ...]]:
    """The first position of each data row, in row order: the ``dp_axes``
    coordinates in mixed radix (``pod`` major), every other axis at 0."""
    dp = dp_axes(mesh)
    return list(itertools.product(*(
        range(mesh.shape[a]) if a in dp else range(1)
        for a in mesh.axis_names)))


def _microbatch_rows(B: int, accum: int, D: int) -> int:
    """The rows of one data row's microbatch slice; raises when a global
    batch of ``B`` does not split into ``accum`` microbatches over ``D``
    data rows."""
    if B % (accum * D):
        raise ValueError(f"a global batch of {B} does not split into "
                         f"{accum} microbatches over {D} data rows")
    return B // (accum * D)


def make_train_step(cfg: ModelConfig, optimizer: AdamW,
                    compress: bool = False, accum: int | None = None,
                    grad_shardings=None):
    """Returns train_step(state, batch) → (state, metrics).

    ``accum`` microbatches (default: ``cfg.train_accum``) split the batch
    (its frontend too) along axis 0 into equal consecutive parts; live
    activation memory scales with B/accum.  ``metrics`` holds ``loss``,
    ``grad_norm`` and ``step`` as tensors on the parameters' device (the
    mesh's first device), and, on a mesh, ``moved`` (:class:`MeshStepStats`).
    A state of :class:`Sharded` leaves (:func:`shard_state`) steps on its
    mesh; ``grad_shardings`` (a params-shaped ``NamedSharding`` tree) needs
    one.
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

    def accumulate(slices, n, dev, like):
        """``(loss, grads)`` of ``n`` consecutive microbatch slices, each
        ``(params, batch)``, summed on ``dev`` in order: as they are for
        ``n == 1``, else ``g.float() / n`` into f32 buffers shaped as the
        leaves of ``like``, allocated before the first slice runs."""
        if n == 1:
            params, b = next(slices)
            loss, g = value_and_grad(params, b)
            return loss.to(dev), [x.to(dev) for x in g]
        grads = [torch.zeros(tuple(p.shape), dtype=torch.float32, device=dev)
                 for p in like]
        loss_val = torch.zeros((), dtype=torch.float32, device=dev)
        for params, b in slices:
            loss_i, g = value_and_grad(params, b)
            for acc, gi in zip(grads, g):
                acc += gi.to(dev).float() / n
            del g
            loss_val = loss_val + loss_i.to(dev) / n
        return loss_val, grads

    def one_device(state: TrainState, batch: dict):
        if grad_shardings is not None:
            raise ValueError("grad_shardings need a state placed on a mesh "
                             "(shard_state)")
        dev = leaves(state.params)[0].device
        mb = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
              for k, v in batch.items()}
        loss_val, grads = accumulate(
            ((state.params, {k: v[i] for k, v in mb.items()})
             for i in range(accum)), accum, dev, leaves(state.params))
        grads = unflatten(state.params, grads)
        err = state.err
        if compress:
            q, s, err = compress_tree(grads, state.err)
            grads = decompress_tree(q, s)
        params, opt, gnorm = optimizer.update(grads, state.opt, state.params)
        metrics = {"loss": loss_val, "grad_norm": gnorm, "step": opt.step}
        return TrainState(params, opt, err), metrics

    def on_mesh(state: TrainState, batch: dict):
        p_leaves = leaves(state.params)
        mesh = p_leaves[0].mesh
        pos = mesh.positions()
        devs = mesh.device_list()
        home = devs[0]
        rows = data_rows(mesh)
        D = len(rows)
        b = _microbatch_rows(next(iter(batch.values())).shape[0], accum, D)
        # the whole parameters, once per distinct row device
        gather, full = MoveStats(), {}
        for c in rows:
            dev = mesh.device(c)
            if dev in full:
                continue
            home_k = pos.index(c)
            full[dev] = unflatten(state.params,
                                  [unshard(s, dev) for s in p_leaves])
            for s in p_leaves:
                gather += unshard_moves(s, dev, home_k)

        def slices():
            for i in range(accum):
                for r, c in enumerate(rows):
                    dev = mesh.device(c)
                    j = i * D + r
                    yield full[dev], {k: v[j * b:(j + 1) * b].to(dev)
                                      for k, v in batch.items()}

        n = accum * D
        loss_val, grads = accumulate(slices(), n, home, p_leaves)
        del full
        # each row's microbatch gradients (the parameters' dtype) go to
        # the first position; those of rows on other devices cross
        g_bytes = sum(math.prod(p.shape) * p.shards[0].element_size()
                      for p in p_leaves)
        off_home = sum(1 for c in rows if mesh.device(c) != home)
        reduce = MoveStats(accum * (D - 1) * g_bytes,
                           accum * off_home * g_bytes)
        grads = unflatten(state.params, grads)
        scatter = MoveStats()
        err = state.err
        if compress:
            e_leaves = leaves(state.err)
            for e in e_leaves:
                reduce += unshard_moves(e, home, 0)
            q, s, new_err = compress_tree(grads, unflatten(
                state.err, [unshard(e, home) for e in e_leaves]))
            grads = decompress_tree(q, s)
            err = unflatten(state.err, [
                shard(t, e.sharding) for t, e in zip(leaves(new_err),
                                                     e_leaves)])
            scatter += _scatter_bytes(leaves(err))
        gnorm = global_norm(grads)
        g_sh = (leaves(grad_shardings) if grad_shardings is not None
                else [p.sharding for p in p_leaves])
        g_sharded = [shard(g, sh) for g, sh in zip(leaves(grads), g_sh)]
        scatter += _scatter_bytes(g_sharded)
        del grads
        relayout = MoveStats()
        for k, (g, p) in enumerate(zip(g_sharded, p_leaves)):
            if g.sharding.spec != p.sharding.spec:
                g_sharded[k], moved = reshard(g, p.sharding)
                relayout += moved
        params, opt = optimizer.apply(unflatten(state.params, g_sharded),
                                      state.opt, state.params, gnorm)
        metrics = {"loss": loss_val, "grad_norm": gnorm, "step": opt.step,
                   "moved": MeshStepStats(gather, reduce, scatter, relayout)}
        return TrainState(params, opt, err), metrics

    def train_step(state: TrainState, batch: dict):
        if sharded_leaves(state.params):
            return on_mesh(state, batch)
        return one_device(state, batch)

    return train_step


def _scatter_bytes(sharded: list) -> MoveStats:
    """Bytes :func:`shard` copied from the mesh's first position (where
    the whole tensor was) to the others, and across devices."""
    out = MoveStats()
    for s in sharded:
        devs = s.mesh.device_list()
        n = s.position_bytes()
        for k in range(1, len(devs)):
            out += MoveStats(n, n if devs[k] != devs[0] else 0)
    return out


def mesh_step_moves(params, mesh: DeviceMesh, accum: int,
                    global_batch: int | None = None, grad_shardings=None,
                    compress: bool = False) -> MeshStepStats:
    """The :class:`MeshStepStats` one step of ``make_train_step(...,
    accum=accum, compress=compress, grad_shardings=grad_shardings)`` counts
    on a state of ``params`` placed on ``mesh`` by :func:`shard_state`,
    composed from the leaves' shapes and dtypes (``meta`` tensors will do)
    and the shardings alone, without running the step.

    An abstract mesh (no devices) counts each position as a device of its
    own, as the production meshes' chips are.  With ``global_batch``, raises
    as the step does when it does not split over the data rows.
    """
    pos = mesh.positions()
    devs = (list(range(len(pos))) if mesh.abstract
            else mesh.device_list())
    home = devs[0]
    rows = data_rows(mesh)
    D = len(rows)
    if global_batch is not None:
        _microbatch_rows(global_batch, accum, D)
    p_leaves = leaves(params)
    p_sh = leaves(param_shardings(mesh, params))
    shapes = [tuple(p.shape) for p in p_leaves]

    def gathers(shapes_items, shardings, targets):
        """:func:`unshard_moves` of each ``(shape, itemsize)`` leaf laid
        out by ``shardings`` onto each ``(device, home index)`` of
        ``targets``."""
        blocks = crossing = 0
        for (shape, item), sh in zip(shapes_items, shardings):
            n = math.prod(sh.shard_shape(shape)) * item
            held: dict = {}
            for k, c in enumerate(pos):
                held.setdefault(sh.block(c, len(shape)), set()).add(devs[k])
            for dev, k in targets:
                # every block but the home's own, from another device
                # where no holder is on ``dev``
                blocks += (len(held) - 1) * n
                crossing += n * sum(1 for on in held.values()
                                    if dev not in on)
        return MoveStats(blocks, crossing)

    def scatters(shapes_items, shardings):
        """:func:`_scatter_bytes` of ``(shape, itemsize)`` leaves laid out
        by ``shardings``."""
        off = sum(1 for d in devs[1:] if d != home)
        out = MoveStats()
        for (shape, item), sh in zip(shapes_items, shardings):
            n = math.prod(sh.shard_shape(shape)) * item
            out += MoveStats((len(pos) - 1) * n, off * n)
        return out

    targets, seen = [], set()
    for c in rows:
        k = pos.index(c)
        if devs[k] not in seen:
            seen.add(devs[k])
            targets.append((devs[k], k))
    gather = gathers([(s, p.element_size()) for s, p in zip(shapes, p_leaves)],
                     p_sh, targets)
    g_bytes = sum(math.prod(p.shape) * p.element_size() for p in p_leaves)
    off_home = sum(1 for c in rows if devs[pos.index(c)] != home)
    reduce = MoveStats(accum * (D - 1) * g_bytes, accum * off_home * g_bytes)
    scatter = MoveStats()
    f32 = torch.float32.itemsize
    if compress:   # the f32 error buffers, gathered home and scattered
        reduce += gathers([(s, f32) for s in shapes], p_sh, [(home, 0)])
        scatter += scatters([(s, f32) for s in shapes], p_sh)
    # the reduced gradient: f32 once summed over microbatches or rows, or
    # decompressed; else the parameters' dtype
    g_item = [f32 if compress or accum * D > 1 else p.element_size()
              for p in p_leaves]
    g_sh = leaves(grad_shardings) if grad_shardings is not None else p_sh
    scatter += scatters(list(zip(shapes, g_item)), g_sh)
    relayout = MoveStats()
    for shape, item, g, s in zip(shapes, g_item, g_sh, p_sh):
        if g.spec == s.spec:
            continue
        for kd, ks, piece in move_plan(g, s, shape):
            if ks != kd:
                n = math.prod(hi - lo for lo, hi in piece) * item
                relayout += MoveStats(n, n if devs[ks] != devs[kd] else 0)
    return MeshStepStats(gather, reduce, scatter, relayout)


def init_state(cfg: ModelConfig, optimizer: AdamW, gen: torch.Generator,
               compress: bool = False) -> TrainState:
    """Parameters from ``gen`` (on its device), zero moments and, with
    ``compress``, zero error buffers."""
    params = lm.init_params(cfg, gen)
    return TrainState(params, optimizer.init(params),
                      init_error(params) if compress else None)


def state_specs(cfg: ModelConfig, optimizer: AdamW,
                compress: bool = False) -> TrainState:
    """Allocation-free :class:`TrainState` (``meta`` tensors; JAX's
    ``eval_shape`` of ``init_state``)."""
    return init_state(cfg, optimizer, MetaGenerator(), compress=compress)


def shard_state(state: TrainState, mesh: DeviceMesh) -> TrainState:
    """``state`` placed on ``mesh``: the parameters, ``m``, ``v`` and the
    error buffers by ``param_shardings`` (a copy at every position of a
    replicated leaf), the step counter on the mesh's first device."""
    sh = leaves(param_shardings(mesh, state.params))

    def place(tree):
        if tree is None:
            return None
        return unflatten(tree, [shard(t, s) for t, s in zip(leaves(tree),
                                                             sh)])

    opt = AdamWState(step=state.opt.step.to(mesh.device_list()[0]),
                     m=place(state.opt.m), v=place(state.opt.v))
    return TrainState(place(state.params), opt, place(state.err))


def unshard_state(state: TrainState, device) -> TrainState:
    """A sharded state gathered whole onto ``device`` (bitwise)."""
    def whole(x):
        return unshard(x, device) if isinstance(x, Sharded) else x.to(device)

    return TrainState(
        tree_map(whole, state.params),
        AdamWState(step=state.opt.step.to(device),
                   m=tree_map(whole, state.opt.m),
                   v=tree_map(whole, state.opt.v)),
        tree_map(whole, state.err))
