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
data-parallel over ``dp_axes(mesh)``, as JAX's reshape of the globally
sharded batch into ``accum`` microbatches is: microbatch ``i``'s ``B /
accum`` rows go to the ``D'`` data rows :func:`microbatch_rows` gives
(JAX's ``_fit`` of that dim over the data axes, the leading ``pod`` axis
dropped first, 1 where none divides), row ``r`` taking its contiguous
slice (the ``batch_shardings`` layout) on its first device.  The rows
along a dropped axis would hold the same slice, as JAX's replicated batch
dim does: each distinct slice runs once, on the row of the lowest index,
and the other rows compute nothing (their shards are fetched as any
shard is).  Each (microbatch, row) slice runs on the row's view of the
state (:mod:`repro_torch.models.tensor_parallel`) through
``lm.row_losses``, one row after another (launch for launch as the row
alone) or, where the microbatch's rows couple (a sorted-dispatch MoE
layer: ``tp.couples``), all of the microbatch's rows together a period
at a time, the sorted dispatch's capacity and drops the microbatch's:
no row holds the
parameters gathered at once; each period gathers its leaves inside the
period (and again in the backward pass), the encoder's once, the
embedding and head where they are used, and every family's attention,
MLP, MoE, Mamba mixer, RWKV time and channel mix, cross-attention and
vocabulary compute on each ``model`` position's slice where ``model``
divides them, their partial outputs summed over ``model`` in f32 in a
fixed order.  Where nothing splits (a ``model`` axis that divides none
of a config's products), the mesh step performs the arithmetic of the
one-device step at ``accum * D'`` bitwise.  The step's loss is JAX's:
each microbatch's summed token losses over its valid labels (those not
``MASK_LABEL``) ``N_mb``, over ``accum``; a row's loss, its own mean over
its ``n_r`` valid labels, and its gradients weigh ``n_r / (accum
N_mb)``, ``1 / (accum * D')`` where the rows' counts are equal.  Each
piece's gradient (a (row, position) slice) is added at its box into f32
buffers on the mesh's first device in a fixed order, microbatch outer
and row inner, ``g.float() / (accum N_mb / n_r)`` each (no atomics).
The sum (compressed there, against the gathered error buffers, when
``compress``) gives the global norm over whole leaves, is
scattered to ``grad_shardings`` (default: the parameters' shardings;
JAX's meaning: where the reduced gradient lives before the update), and
AdamW updates each shard on its own device.  Only a batch that ``accum``
does not divide raises.  :func:`mesh_step_moves` composes the bytes a
mesh step moves from the specs alone, without running it (the dry-run's
``moves``).
"""
from __future__ import annotations

import itertools
import math
from typing import Any, NamedTuple

import torch

from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models import lm
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MetaGenerator, moe_sorted_chunks
from repro_torch.models.sharding import (MoveStats, Sharded, _axsize, _fit,
                                         dp_axes, move_plan, param_shardings,
                                         reshard, shard, sharded_leaves,
                                         unshard, unshard_moves)
from repro_torch.training.grad_compress import (compress_tree,
                                                decompress_tree, init_error)
from repro_torch.training.optimizer import AdamW, AdamWState, global_norm
from repro_torch.training.tree import leaves, tree_map, unflatten

__all__ = ["TrainState", "MeshStepStats", "make_train_step", "init_state",
           "state_specs", "shard_state", "unshard_state", "data_rows",
           "microbatch_rows", "mesh_step_moves"]


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    err: Any | None  # error-feedback buffers (None if compression off)


class MeshStepStats(NamedTuple):
    """Bytes one mesh step copied between positions (``MoveStats``):
    ``gather`` the parameters each position computes with, where it uses
    them (each period's forward and recomputation), ``reduce`` the pieces'
    gradients to the mesh's first device (and, with compression, the
    error buffers gathered there), ``scatter`` the reduced gradient (and
    new error buffers) to their shards, ``relayout`` the gradient from
    ``grad_shardings`` to the parameters' shardings, ``model`` the
    activations, partial outputs and their gradients between a data row's
    positions along ``model`` (the split products' sums), ``routes`` the
    sorted MoE dispatch's per-expert counts each data row hands the next
    row of its microbatch (the only bytes the microbatch's forward pass
    sends between data rows)."""

    gather: MoveStats
    reduce: MoveStats
    scatter: MoveStats
    relayout: MoveStats
    model: MoveStats
    routes: MoveStats = MoveStats()


def data_rows(mesh: DeviceMesh) -> list[tuple[int, ...]]:
    """The first position of each data row, in row order: the ``dp_axes``
    coordinates in mixed radix (``pod`` major), every other axis at 0."""
    dp = dp_axes(mesh)
    return list(itertools.product(*(
        range(mesh.shape[a]) if a in dp else range(1)
        for a in mesh.axis_names)))


def microbatch_rows(mesh: DeviceMesh, B: int, accum: int) -> tuple:
    """``(D', b)``: the data rows that compute a microbatch of a global
    batch of ``B`` in ``accum`` microbatches, and the rows of each one's
    slice.  A microbatch's ``m = B / accum`` rows go to ``D'`` data rows,
    ``D'`` the size of the data axes JAX's ``_fit`` keeps for a dim of
    ``m`` (dropping the leading ``pod`` axis first; 1 where none
    divides).  The rows along a dropped axis hold the same slice, as
    JAX's replicated batch dim does: each distinct slice runs once, on
    the row of the lowest index, so the first ``D'`` of
    :func:`data_rows` compute.  Raises where ``accum`` does not divide
    ``B``, as JAX's reshape would."""
    if B % accum:
        raise ValueError(f"a global batch of {B} does not split into "
                         f"{accum} microbatches")
    m = B // accum
    D = _axsize(mesh, _fit(mesh, m, dp_axes(mesh)))
    return D, m // D


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

    def slice_grads(trees, rows, slices):
        """Each data row's ``(loss, [(leaf index, index, position,
        gradient)])`` on its view (``trees``, ``rows``) of its slice of one
        microbatch: each piece it computed with, its gradient on its
        position's device.  The rows run through the stack together
        (``lm.row_losses``; a group of one row runs alone), one backward
        pass over their losses (no gradient crosses rows: a row's loss
        depends on another's only through the sorted dispatch's discrete
        keep decision)."""
        with torch.enable_grad():
            losses = lm.row_losses(cfg, trees, slices)
            pieces = [row.pieces() for row in rows]
            grads = iter(torch.autograd.grad(
                losses, [p[3] for ps in pieces for p in ps],
                allow_unused=True, materialize_grads=True))
        return [(loss.detach(), [(k, idx, q, next(grads))
                                 for k, idx, q, _ in ps])
                for loss, ps in zip(losses, pieces)]

    def on_mesh(state: TrainState, batch: dict):
        p_leaves = leaves(state.params)
        mesh = p_leaves[0].mesh
        devs = mesh.device_list()
        home = devs[0]
        D, b = microbatch_rows(mesh, next(iter(batch.values())).shape[0],
                               accum)
        rows = data_rows(mesh)[:D]
        n = accum * D
        # each slice's valid labels: a row's mean over its own n_r labels
        # weighs S_r / n_r * n_r / (accum N_mb), JAX's S_r / N_mb / accum
        # (N_mb the microbatch's count); 1 / n where the counts are equal
        valid = (batch["labels"] != lm.MASK_LABEL).reshape(n, -1).sum(-1)
        valid = valid.tolist()
        # f32 buffers for a sum, allocated before the first slice runs; a
        # single slice's pieces in the parameters' dtype
        grads = [torch.zeros(tuple(p.shape), dtype=torch.float32 if n > 1
                             else p.dtype, device=home) for p in p_leaves]
        loss_val = torch.zeros((), dtype=torch.float32, device=home)
        booked = {"gather": MoveStats(), "model": MoveStats(),
                  "routes": MoveStats()}
        reduce = MoveStats()
        groups = [[c] for c in rows] if not tp.couples(cfg) else [rows]
        for i in range(accum):
            n_mb = max(sum(valid[i * D:(i + 1) * D]), 1)
            r0 = 0
            for group in groups:
                trees, micro = tp.micro_view(cfg, state.params, group,
                                             booked)
                slices = [{k: v[(i * D + r) * b:(i * D + r + 1) * b].to(
                    row.home) for k, v in batch.items()}
                    for r, row in enumerate(micro.rows, r0)]
                results = slice_grads(trees, micro.rows, slices)
                del trees, micro, slices
                for r, (loss_i, pieces) in enumerate(results, r0):
                    nr = valid[i * D + r]
                    w = accum * n_mb / nr if nr else math.inf
                    for k, idx, q, g in pieces:
                        # a piece computed away from the first position
                        # goes there
                        if q:
                            nb = g.numel() * g.element_size()
                            reduce += MoveStats(nb, nb if devs[q] != home
                                                else 0)
                        g = g.to(home)
                        grads[k][idx] += g.float() / w if n > 1 else g
                    loss_val = (loss_val + loss_i.to(home) / w if n > 1
                                else loss_i.to(home))
                del results
                r0 += len(group)
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
                   "moved": MeshStepStats(booked["gather"], reduce, scatter,
                                          relayout, booked["model"],
                                          booked["routes"])}
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


def mesh_step_moves(cfg: ModelConfig, mesh: DeviceMesh, accum: int,
                    global_batch: int, seq_len: int, grad_shardings=None,
                    compress: bool = False) -> MeshStepStats:
    """The :class:`MeshStepStats` one step of ``make_train_step(cfg, ...,
    accum=accum, compress=compress, grad_shardings=grad_shardings)``
    counts on a state placed on ``mesh`` by :func:`shard_state`, for a
    batch of ``global_batch`` sequences of ``seq_len`` tokens, composed
    from ``cfg``'s parameter shapes and dtypes and the shardings alone
    (:func:`~repro_torch.models.tensor_parallel.row_moves` for each data
    row), without running the step.

    An abstract mesh (no devices) counts each position as a device of its
    own, as the production meshes' chips are.  Raises as the step does
    when ``accum`` does not divide the batch.
    """
    pos = mesh.positions()
    devs = (list(range(len(pos))) if mesh.abstract
            else mesh.device_list())
    home = devs[0]
    D, b = microbatch_rows(mesh, global_batch, accum)
    rows = data_rows(mesh)[:D]
    params = lm.param_specs(cfg)
    p_leaves = leaves(params)
    shardings = param_shardings(mesh, params)
    p_sh = leaves(shardings)
    shapes = [tuple(p.shape) for p in p_leaves]

    def times(m: MoveStats, n: int) -> MoveStats:
        return MoveStats(m.positions * n, m.devices * n)

    def scatters(shapes_items, shardings):
        """:func:`_scatter_bytes` of ``(shape, itemsize)`` leaves laid out
        by ``shardings``."""
        off = sum(1 for d in devs[1:] if d != home)
        out = MoveStats()
        for (shape, item), sh in zip(shapes_items, shardings):
            n = math.prod(sh.shard_shape(shape)) * item
            out += MoveStats((len(pos) - 1) * n, off * n)
        return out

    gather = model = reduce = routes = MoveStats()
    if tp.couples(cfg):
        # each sorted MoE layer's chunk, in each microbatch's forward pass:
        # a data row's per-expert counts (int64) to the next row
        S = seq_len + (cfg.frontend_len if cfg.frontend == "vision_stub"
                       else 0)
        n = (accum * cfg.n_periods * sum(s.moe for s in cfg.period())
             * len(moe_sorted_chunks(S)))
        nb = cfg.n_experts * torch.int64.itemsize
        homes = [devs[pos.index(c)] for c in rows]
        for a, h in zip(homes, homes[1:]):
            routes += times(MoveStats(nb, nb if a != h else 0), n)
    for c in rows:
        g, mo, pieces = tp.row_moves(cfg, params, shardings, c, devs, b,
                                     seq_len)
        gather += times(g, accum)
        model += times(mo, accum)
        # a piece computed away from the first position goes there
        for nb, q in pieces:
            if q:
                reduce += times(MoveStats(nb, nb if devs[q] != home else 0),
                                accum)
    scatter = MoveStats()
    f32 = torch.float32.itemsize
    if compress:   # the f32 error buffers, gathered home and scattered
        for s, sh in zip(shapes, p_sh):
            reduce += tp.fetch_moves(sh, s, f32, 0, False, devs)
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
    return MeshStepStats(gather, reduce, scatter, relayout, model, routes)


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
