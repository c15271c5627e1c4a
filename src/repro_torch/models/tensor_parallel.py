"""A data row's view of a sharded parameter tree: the parameters gathered
where they are used, and every family's products split over ``model``.

The mesh train step (:mod:`repro_torch.training.train_step`) runs
:func:`~repro_torch.models.lm.row_losses` on :func:`micro_view`'s trees,
one for each data row, whose leaves are :class:`RowLeaf`\\s of the
state's :class:`~repro_torch.core.layout.Sharded` leaves.  Where the rows
of a microbatch do not couple, each row is a :class:`Micro` of its own
and runs alone.  Where they do (:func:`couples`: a sorted-dispatch MoE
layer, whose capacity and drops are the whole microbatch's, as in JAX's
one function of the microbatch), the microbatch's rows share one
:class:`Micro` and run through the stack together, a period at a time:
every sublayer runs each row's slice on its own positions with the calls
it makes alone, and :func:`moe_apply_sorted` runs once over the rows.
Nothing is gathered up front.  A leaf is fetched where the model uses
it: a period's leaves inside the period (which runs under
``checkpoint``, so the
backward pass fetches them again and no fetched leaf is saved for it),
the embedding for the lookup, the head for the loss; an encoder layer
inside the encoder, which runs outside the periods' checkpoints (as JAX's
plain ``lax.scan``), so each is fetched once.  Each use is either

* **whole**: every block, on the position that computes (the row's first
  position, or a position that computes a replicated piece);
* **part**: the position's ``model`` slice, every block along the other
  axes (the FSDP gather over the data axes): a leaf's dim whose spec is
  ``"model"`` stays at the position's own block; or
* **span**: a range along one dim, every block along the others (the
  Mamba mixer's ``in_proj`` columns along ``model``, RWKV's channel-mix
  ``wv`` rows along ``d_ff``), each block cut to its overlap.

A fetch takes a block the position holds from itself, and any other block
from the first position holding it on the same device, else from the
first holding it (the :func:`~repro_torch.core.layout.unshard` rule); its
bytes are booked as ``gather`` (``MoveStats``: between positions, and
between devices).  Every use of one (leaf, period, position, box) feeds
one *sink*: a zero-stride leaf that requires grad, through which the
piece's gradient comes back from ``torch.autograd.grad`` on the
position's device; the step adds it at its box (:meth:`Row.pieces`).

**Split products** (:func:`splits`: every family, ``model`` > 1).  As
``param_shardings`` lays the leaves out (the JAX package's column/row
rules), position ``(r, m)`` computes with its slices:

* attention: ``wq`` (and ``wk``/``wv``) give its heads, ``wo`` its rows;
  q/k norms, RoPE and the chunked attention (a sliding window, its chunk
  skip) run on whole heads locally.  Where ``n_heads`` does not split
  over ``model`` the sublayer runs whole on the row's first position;
  where only ``n_kv_heads`` does not, each position fetches ``wk``/``wv``
  whole and takes the one kv head its query heads share (when they share
  one), else the sublayer runs whole.  No head is ever cut;
* the dense MLP: ``w_up``/``w_gate`` give its ``d_ff`` slice, ``w_down``
  its rows;
* the MoE (dense dispatch; :func:`moe_apply`): each expert's ``d_ff``
  slice, the experts over the data axes (EP) or ``d`` over them (FSDP)
  gathered; the routing once on the row's first position, ``combine``
  sent out;
* the sorted MoE dispatch (``moe_dispatch="sorted"``, which no registry
  config sets; :func:`moe_apply_sorted`): each row routes its tokens on
  its first position, the keep decision is the microbatch's stable sort
  (each row hands the next its per-expert counts, booked as ``routes``),
  made by the forward pass and taken again by the recomputation; each
  position runs the ``(E, C, ff)`` products of its row's kept
  assignments on its ``d_ff`` slice (fetched as the dense dispatch's),
  each assignment's partial output summed on the row's first position,
  the combine there (whole on the row's first position where ``d_ff``
  does not split);
* the Mamba mixer (:func:`mamba_apply`): ``d_inner`` (where ``model``
  divides it): each position's channels through the conv and the scan;
  ``x_proj``'s partial products summed and sent back;
* RWKV's time mix (:func:`rwkv_apply`): its heads (where ``model``
  divides them), each position's through the WKV scan, the group norm
  and the gate, ``wo``'s rows giving partial outputs; the channel mix
  (:func:`rwkv_ffn_apply`): ``d_ff``, ``wv``'s matching rows fetched as a
  span, ``wr``'s columns collected;
* the cross-attention (:func:`cross_attn`) as attention, ``k``/``v`` from
  the encoder memory, which goes to each position; the encoder's layers
  (:func:`materialize_encoder`) as a period's attention and MLP;
* the vocabulary: the embedding lookup sums each slice's masked rows; the
  loss takes each slice's ``logsumexp``, combines them (the max over the
  slices, then the sum of exponentials against it), and the gold logit
  from the slice owning the label's row (the JAX package's row
  formulation); the ``(B, S, V)`` logits are never whole.

The sublayer input goes to each position and the positions' partial
outputs come back to the row's first position, where they are summed in
f32 in position order (no atomics) and cast once to the model dtype (the
MoE's partials come back in f32); the backward pass sends the output's
gradient out and sums the input's gradients back the same way.  These
copies, with the tokens, labels, positions, the MoE's ``combine``, the
sorted dispatch's slots and per-assignment partials, the mixer's
``x_proj`` partials and their sum, the channel mix's ``rr`` slices, the
encoder memory and its gradient, and the loss's per-slice ``logsumexp``
and gold logits, are booked as ``model``.  A VLM's stack
runs on its patch rows and its text, so its sublayers' copies count both.
A position on the row's first device copies nothing (a view) and is still
booked between positions.  The split forms run in train mode only: a
decode state raises.  :func:`row_moves` composes what one row books from
the specs alone.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import threading

import torch

from repro_torch.core.layout import MoveStats, Sharded
from repro_torch.models.attention import attn_train as _attn_train
from repro_torch.models.attention import cross_attn as _cross_attn
from repro_torch.models.config import LayerKind, LayerSpec
from repro_torch.models.layers import mlp_apply as _mlp_apply
from repro_torch.models.layers import (act_fn, moe_capacity, moe_chunks,
                                       moe_expert, moe_route,
                                       moe_sorted_chunks, torch_dtype)
from repro_torch.models.rwkv import channel_mix, shift, time_mix
from repro_torch.models.ssm import mamba_conv, mamba_scan

__all__ = ["SPLIT_FAMILIES", "RowLeaf", "Row", "Micro", "row_view",
           "micro_view", "couples", "first_leaf", "whole", "splits",
           "materialize", "materialize_encoder", "splits_vocab", "is_split",
           "attn_train", "cross_attn", "mlp_apply", "moe_apply",
           "moe_apply_sorted", "mamba_apply", "rwkv_apply",
           "rwkv_ffn_apply", "vocab_lookup", "vocab_head_loss",
           "fetch_moves", "row_moves"]

_ATTN_PARTS = ("wq", "wk", "wv", "wo")
SPLIT_FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "audio")


# ---------------------------------------------------------------------------
# what a use fetches
# ---------------------------------------------------------------------------

def _spec(sharding, ndim: int) -> list:
    return list(sharding.spec) + [None] * (ndim - len(sharding.spec))


def _model_dim(sharding, ndim: int, off: int) -> int | None:
    """The dim (after the ``off`` stack dims) whose spec is ``"model"``."""
    for d, e in enumerate(_spec(sharding, ndim)[off:]):
        if e == "model":
            return d
    return None


@functools.lru_cache(maxsize=4096)
def _holders(sharding, ndim: int) -> tuple:
    """``(block of each position, {block: positions holding it})``."""
    blocks = [sharding.block(c, ndim) for c in sharding.mesh.positions()]
    held: dict = {}
    for k, b in enumerate(blocks):
        held.setdefault(b, []).append(k)
    return blocks, held


def _fetch_plan(sharding, shape: tuple, q: int, part: bool, devs,
                span=None) -> tuple:
    """``(blocks, index)`` of position ``q``'s use: each needed block as
    ``(block index, source position, cut)`` in C order of the block
    indices (``None`` as the source of ``q``'s own), and the use's index
    in the leaf (slices, the stack dims whole).  ``span`` ``(dim, lo,
    hi)``: only ``[lo, hi)`` along ``dim``, every block along the others;
    ``cut`` is then each block's ``[lo, hi)`` along ``dim``, relative to
    the block (else ``None``: the whole block).  ``devs``: the device of
    each position."""
    ndim = len(shape)
    tiles = sharding.tiling(ndim)
    of, held = _holders(sharding, ndim)
    own = of[q]
    ss = sharding.shard_shape(shape)
    fixed = [part and e == "model" for e in _spec(sharding, ndim)]

    def source(b):
        ks = held[b]
        return next((k for k in ks if devs[k] == devs[q]), ks[0])

    ranges = [[own[d]] if fixed[d] else range(tiles[d]) for d in range(ndim)]
    index = [slice(own[d] * ss[d], (own[d] + 1) * ss[d]) if fixed[d]
             else slice(None) for d in range(ndim)]
    if span is not None:
        d, lo, hi = span
        ranges[d] = range(lo // ss[d], -(-hi // ss[d]))
        index[d] = slice(lo, hi)
    blocks = []
    for b in itertools.product(*ranges):
        cut = None
        if span is not None:
            cut = (max(lo - b[d] * ss[d], 0), min(hi - b[d] * ss[d], ss[d]))
        blocks.append((b, None if b == own else source(b), cut))
    return blocks, tuple(index)


@functools.lru_cache(maxsize=65536)
def _fetch_elements(sharding, shape: tuple, q: int, part: bool, devs: tuple,
                    span=None) -> tuple:
    """``(copied, across devices, used)``: the elements
    :func:`_fetch_plan`'s use copies from other positions and, of them,
    from other devices (a cut block: its share), and the elements of its
    index in the leaf."""
    blocks, index = _fetch_plan(sharding, shape, q, part, devs, span)
    ss = sharding.shard_shape(shape)
    n = math.prod(ss)
    pos = dev = 0
    for _, k, cut in blocks:
        if k is not None:
            e = n if cut is None else n // ss[span[0]] * (cut[1] - cut[0])
            pos += e
            dev += e if devs[k] != devs[q] else 0
    used = math.prod(len(range(*i.indices(d))) for i, d in zip(index, shape))
    return pos, dev, used


def fetch_moves(sharding, shape, itemsize: int, q: int, part: bool,
                devs, span=None) -> MoveStats:
    """What position ``q``'s use (``part``: its ``model`` slice, else the
    whole leaf; ``span`` as :func:`_fetch_plan` takes it) of a leaf of
    ``shape`` laid out by ``sharding`` copies (``devs``: the device of
    each position)."""
    pos, dev, _ = _fetch_elements(sharding, tuple(shape), q, part,
                                  tuple(devs), span)
    return MoveStats(pos * itemsize, dev * itemsize)


class _Fetch(torch.autograd.Function):
    """The tensor ``fetch()`` builds; its gradient goes to ``sink``."""

    @staticmethod
    def forward(ctx, sink, fetch):
        return fetch()

    @staticmethod
    def backward(ctx, g):
        return g, None


# ---------------------------------------------------------------------------
# the model axis's sums and copies
# ---------------------------------------------------------------------------

class _Broadcast(torch.autograd.Function):
    """``t`` (on ``devs[0]``) at every device of ``devs``; the backward
    sums the gradients in f32 in order and casts once."""

    @staticmethod
    def forward(ctx, row, t, devs):
        ctx.row, ctx.devs, ctx.dtype = row, devs, t.dtype
        outs = []
        for m, dev in enumerate(devs):
            if m:
                row.book_model(t, devs[0], dev)
            outs.append(t.view_as(t) if dev == devs[0] else t.to(dev))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        home, total = ctx.devs[0], None
        for m, g in enumerate(gs):
            if m:
                ctx.row.book_model(g, ctx.devs[m], home)
            g = g.to(home).float()
            total = g if total is None else total + g
        return None, total.to(ctx.dtype), None


# ---------------------------------------------------------------------------
# a data row's view
# ---------------------------------------------------------------------------

class _Collect(torch.autograd.Function):
    """Each of ``ts`` (one on each device of ``devs``) on ``devs[0]``; the
    backward sends each gradient back."""

    @staticmethod
    def forward(ctx, row, devs, *ts):
        ctx.row, ctx.devs = row, devs
        outs = []
        for m, t in enumerate(ts):
            if m:
                row.book_model(t, devs[m], devs[0])
            outs.append(t.view_as(t) if devs[m] == devs[0] else t.to(devs[0]))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        outs = []
        for m, (g, dev) in enumerate(zip(gs, ctx.devs)):
            if m:
                ctx.row.book_model(g, ctx.devs[0], dev)
            outs.append(g if dev == ctx.devs[0] else g.to(dev))
        return (None, None, *outs)


class Micro:
    """The data rows that compute one microbatch together
    (:func:`micro_view`): ``rows`` in row order, the lock their move
    counts share (the backward pass runs a thread a device), and
    ``routes``, the sorted MoE dispatch's decisions ``{(router leaf,
    period, chunk): [(idx, keep, dst) a row]}`` (:func:`moe_apply_sorted`):
    made by the forward pass, taken again by the period's recomputation.
    A view serves one forward pass and its recomputation."""

    def __init__(self):
        self.rows: list = []
        self.lock = threading.Lock()
        self.routes: dict = {}


class Row:
    """One data row of a mesh for one (microbatch, row) slice: its
    positions along ``model`` (``ks``, indices in position order, the
    row's first position first), their devices, whether its products
    split (:func:`splits`), the sinks, the :class:`Micro` it belongs to,
    and the step's move counts (``stats``: ``{"gather": MoveStats,
    "model": MoveStats, ...}``, shared by the rows; the micro's lock
    guards them against the backward pass's device threads)."""

    def __init__(self, cfg, mesh, first, stats: dict, micro=None):
        pos = mesh.positions()
        axes = mesh.axis_names
        M = mesh.shape["model"] if "model" in axes else 1
        mi = axes.index("model") if "model" in axes else None
        coords = [tuple(m if i == mi else c for i, c in enumerate(first))
                  for m in range(M)]
        self.M = M
        self.all_devs = tuple(mesh.device_list())
        self.ks = [pos.index(c) for c in coords]
        self.devs = tuple(self.all_devs[k] for k in self.ks)
        self.home = self.devs[0]
        self.split = splits(cfg, M)
        self.stats = stats
        self.micro = Micro() if micro is None else micro
        self.micro.rows.append(self)
        self.lock = self.micro.lock
        self.sinks: dict = {}

    # -- moves -----------------------------------------------------------
    def _book(self, kind: str, moved: MoveStats) -> None:
        with self.lock:
            self.stats[kind] = self.stats[kind] + moved

    def book_model(self, t, src, dst) -> None:
        n = t.numel() * t.element_size()
        self._book("model", MoveStats(n, n if src != dst else 0))

    def send(self, t, m: int):
        """``t`` (no gradient) from the row's first position to position
        ``m``, booked as ``model``."""
        if m == 0:
            return t
        self.book_model(t, self.home, self.devs[m])
        return t.to(self.devs[m])

    def broadcast(self, t) -> tuple:
        return _Broadcast.apply(self, t, self.devs)

    def reduce(self, parts, dtype=None):
        """The partials (one a position) summed on the row's first
        position in f32 in position order, cast once to ``dtype``
        (default: theirs)."""
        total = None
        for t in self.collect(parts):
            total = t.float() if total is None else total + t.float()
        return total.to(dtype or parts[0].dtype)

    def collect(self, ts) -> tuple:
        return _Collect.apply(self, self.devs, *ts)

    # -- fetches ---------------------------------------------------------
    def fetch(self, leaf: "RowLeaf", q: int, part: bool,
              span=None) -> torch.Tensor:
        """``leaf`` (a period of it) as position ``q`` uses it (``span``:
        as :func:`_fetch_plan` takes it), through the sink of that (leaf,
        period, position, box)."""
        s, period = leaf.s, leaf.period
        blocks, index = _fetch_plan(s.sharding, s.shape, q, part,
                                    self.all_devs, span)
        if period is not None:
            index = (period,) + index[1:]
        key = (leaf.k, q, tuple((i.start, i.stop) if isinstance(i, slice)
                                else i for i in index))
        dev = self.all_devs[q]
        if key not in self.sinks:
            shape = tuple(torch.empty(s.shape, device="meta")[index].shape)
            sink = torch.empty_strided(shape, (0,) * len(shape),
                                       dtype=s.dtype, device=dev)
            self.sinks[key] = (leaf.k, index, q, sink.requires_grad_())
        sink = self.sinks[key][3]
        ndim = s.ndim
        off = 0 if period is None else 1
        # a period's share of the stacked leaf's copies
        moved = fetch_moves(s.sharding, s.shape, s.dtype.itemsize, q, part,
                            self.all_devs, span)
        per = s.shape[0] if off else 1
        moved = MoveStats(moved.positions // per, moved.devices // per)

        def fetch():
            self._book("gather", moved)
            got = {}
            for b, k, cut in blocks:
                t = s.shards[q if k is None else k]
                t = t if period is None else t[period]
                if cut is not None:
                    t = t.narrow(span[0] - off, cut[0], cut[1] - cut[0])
                got[b] = t.to(dev)

            def join(prefix, d):
                if d == ndim:
                    return got[prefix]
                parts = sorted({b[d] for b in got if b[:d] == prefix})
                ts = [join(prefix + (i,), d + 1) for i in parts]
                return ts[0] if len(ts) == 1 else torch.cat(ts, d - off)

            out = join((), 0)
            return out.view_as(out)

        return _Fetch.apply(sink, fetch)

    def pieces(self) -> list:
        """``[(leaf index, index, position, sink)]``: every piece the row
        computed with, in the order of first use."""
        return list(self.sinks.values())


class RowLeaf:
    """A :class:`Sharded` leaf (``k``-th of the tree; ``period`` of a
    stacked one) as a data row uses it."""

    def __init__(self, row: Row, s: Sharded, k: int, period=None):
        self.row, self.s, self.k, self.period = row, s, k, period

    def __getitem__(self, i: int) -> "RowLeaf":
        return RowLeaf(self.row, self.s, self.k, int(i))

    @property
    def off(self) -> int:
        return 0 if self.period is None else 1

    def model_dim(self) -> int | None:
        """The dim of the (period's) leaf split over ``model``."""
        return _model_dim(self.s.sharding, self.s.ndim, self.off)

    def whole(self, m: int = 0) -> torch.Tensor:
        """Every block, on position ``m`` of the row."""
        return self.row.fetch(self, self.row.ks[m], False)

    def part(self, m: int) -> torch.Tensor:
        """Position ``m``'s ``model`` slice, on its device."""
        return self.row.fetch(self, self.row.ks[m], True)

    def span(self, m: int, lo: int, hi: int, dim=None) -> torch.Tensor:
        """``[lo, hi)`` along ``dim`` of the (period's) leaf (default:
        :meth:`model_dim`), every block along the others, on position
        ``m``'s device."""
        d = self.model_dim() if dim is None else dim
        return self.row.fetch(self, self.row.ks[m], False,
                              (self.off + d, lo, hi))

    def start(self, m: int) -> int:
        """Where position ``m``'s slice starts along :meth:`model_dim`."""
        d = self.model_dim()
        sh = self.s.sharding
        pos = sh.mesh.positions()[self.row.ks[m]]
        n = sh.shard_shape(self.s.shape)[d + self.off]
        return sh.block(pos, self.s.ndim)[d + self.off] * n


def row_view(cfg, params, first, stats: dict, micro=None) -> tuple:
    """``(tree, row)``: ``params`` (a tree of :class:`Sharded` leaves) as
    the data row whose first position is ``first`` uses it (``micro``:
    the :class:`Micro` it joins, else one of its own)."""
    from repro_torch.training.tree import leaves, unflatten

    ls = leaves(params)
    row = Row(cfg, ls[0].mesh, first, stats, micro)
    return unflatten(params, [RowLeaf(row, s, k)
                              for k, s in enumerate(ls)]), row


def micro_view(cfg, params, firsts, stats: dict) -> tuple:
    """``(trees, micro)``: :func:`row_view` of each data row whose first
    position is in ``firsts`` (in order), the rows of one
    :class:`Micro`, their counts in ``stats``."""
    micro = Micro()
    trees = [row_view(cfg, params, c, stats, micro)[0] for c in firsts]
    return trees, micro


def first_leaf(tree):
    """The first leaf of a tree of nested dicts."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def whole(tree):
    """``tree`` with every :class:`RowLeaf` fetched whole on its row's
    first position; tensors pass through."""
    if isinstance(tree, dict):
        return {k: whole(v) for k, v in tree.items()}
    return tree.whole() if isinstance(tree, RowLeaf) else tree


# ---------------------------------------------------------------------------
# which products split
# ---------------------------------------------------------------------------

def _attn_mode(n_heads: int, n_kv: int, M: int, mdim) -> str | None:
    """``"kv"`` (q and kv heads split), ``"pick"`` (q heads split, each
    position's sharing one kv head, fetched whole) or ``None`` (whole);
    ``mdim(name)`` the model dim of the sublayer's leaf ``name``."""
    if n_heads % M or mdim("wq") != 1 or mdim("wo") != 0:
        return None
    if n_kv % M == 0 and mdim("wk") == 1 and mdim("wv") == 1:
        return "kv"
    return "pick" if (n_heads // n_kv) % (n_heads // M) == 0 else None


def _mlp_splits(mdim) -> bool:
    return (mdim("w_up") == 1 and mdim("w_down") == 0
            and mdim("w_gate") in (1, "absent"))


def _moe_splits(mdim) -> bool:
    """The experts' ``d_ff`` over ``model`` (``w_up``/``w_gate`` ``(E, d,
    ff)``, ``w_down`` ``(E, ff, d)``), either dispatch."""
    return (mdim("w_up") == 2 and mdim("w_down") == 1
            and mdim("w_gate") in (2, "absent"))


# the Mamba mixer's leaves and the dim of each that holds d_inner
_MIX_DIMS = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "x_proj": 0,
             "dt_proj": 1, "dt_bias": 0, "A_log": 0, "D": 0, "out_proj": 0}


def _mix_splits(cfg, M: int, mdim) -> bool:
    return cfg.d_inner % M == 0 and all(mdim(n) == d
                                        for n, d in _MIX_DIMS.items())


# RWKV's time mix: the dim of each leaf that holds its heads' channels
# (``wA`` whole: ``(data, None)``), and the channel mix's (``wv`` ``(d_ff,
# d)`` takes the attention rule by name: ``model`` on ``d``)
_RWKV_DIMS = {"wr": 1, "wk": 1, "wv": 1, "wg": 1, "wB": 1, "wo": 0,
              "wA": None}
_RWKV_PARTS = ("wr", "wk", "wv", "wg", "wB", "wo")
_CMIX_DIMS = {"wk": 1, "wv": 1, "wr": 1}


def _rwkv_splits(cfg, M: int, mdim) -> bool:
    return cfg.rwkv_heads % M == 0 and all(mdim(n) == d
                                           for n, d in _RWKV_DIMS.items())


def _cmix_splits(mdim) -> bool:
    return all(mdim(n) == d for n, d in _CMIX_DIMS.items())


_WHOLE = {"attn": None, "ffn": False, "moe": False, "mix": False,
          "rwkv": False, "cmix": False, "cross": None, "sorted": None}
# an encoder layer: attention and a dense MLP
_ENCODER = LayerSpec(LayerKind.ATTN, moe=False)


def couples(cfg) -> bool:
    """Whether a microbatch's data rows couple: a sorted-dispatch MoE
    layer, whose capacity and drops are the whole microbatch's."""
    return cfg.moe_dispatch == "sorted" and any(s.moe for s in cfg.period())


def splits(cfg, M: int) -> bool:
    """Whether a data row of ``M`` positions along ``model`` splits
    ``cfg``'s products: every family of :data:`SPLIT_FAMILIES`, ``M`` >
    1."""
    return cfg.family in SPLIT_FAMILIES and M > 1


def _sublayer_modes(cfg, M: int, spec, layer_mdim) -> dict:
    """``{"attn": mode, "ffn", "moe", "mix", "rwkv", "cmix": bool,
    "cross": mode, "sorted": mode}`` of one layer (``spec``: its
    :class:`~repro_torch.models.config.LayerSpec`; an encoder layer's
    is :data:`_ENCODER`) (``layer_mdim(sub, name)``: the model dim,
    ``"absent"`` for a leaf the layer does not have): attention, the
    dense MLP, the MoE (dense dispatch), the Mamba mixer, RWKV's time mix
    and channel mix, the cross-attention, split where the family
    :func:`splits`; the sorted MoE dispatch (``"sorted"``) always runs as
    :func:`moe_apply_sorted` on a row (its sort is the microbatch's),
    ``"part"`` where the experts' ``d_ff`` splits, else ``"whole"``."""
    sort = spec.moe and cfg.moe_dispatch == "sorted"
    if not splits(cfg, M):
        return dict(_WHOLE, sorted="whole" if sort else None)
    ffn = functools.partial(layer_mdim, "ffn")
    mix = functools.partial(layer_mdim, "mix")
    rwkv = spec.kind == LayerKind.RWKV
    moe = spec.moe and _moe_splits(ffn)
    return {"attn": _attn_mode(cfg.n_heads, cfg.n_kv_heads, M,
                               functools.partial(layer_mdim, "attn")),
            "ffn": not spec.moe and not rwkv and _mlp_splits(ffn),
            "moe": moe and not sort,
            "mix": not rwkv and _mix_splits(cfg, M, mix),
            "rwkv": rwkv and _rwkv_splits(cfg, M, mix),
            "cmix": rwkv and _cmix_splits(ffn),
            "cross": _attn_mode(cfg.n_heads, cfg.n_kv_heads, M,
                                functools.partial(layer_mdim, "cross")),
            "sorted": ("part" if moe else "whole") if sort else None}


@dataclasses.dataclass
class _Split:
    """A sublayer whose products split over ``model``: its leaves
    (:class:`RowLeaf`), ``mode`` as :func:`_attn_mode` gives it for
    attention and cross-attention, as :func:`_sublayer_modes` gives
    ``"sorted"`` for the sorted MoE dispatch."""

    row: Row
    p: dict
    mode: str | None = None


def is_split(p) -> bool:
    return isinstance(p, _Split)


def _layer_mdim(layer):
    def mdim(sub, leaf):
        t = layer.get(sub, {}).get(leaf)
        return "absent" if t is None else t.model_dim()
    return mdim


def _materialize_layer(row: Row, layer: dict, modes: dict) -> dict:
    """One layer's sublayers: split where ``modes`` split them, every
    other leaf fetched whole."""
    split = {"attn": modes["attn"], "cross": modes["cross"],
             "ffn": (modes["ffn"] or modes["moe"] or modes["cmix"]
                     or modes["sorted"]),
             "mix": modes["mix"] or modes["rwkv"]}
    mode = {"attn": modes["attn"], "cross": modes["cross"],
            "ffn": modes["sorted"]}
    out = {}
    for sub, tree in layer.items():
        if split.get(sub):
            out[sub] = _Split(row, tree, mode.get(sub))
        else:
            out[sub] = whole(tree)
    return out


def materialize(cfg, pparams):
    """One period's leaves as ``_apply_period_rows`` runs them, fetched here
    (inside the period): a row's attention, dense MLP, MoE, Mamba mixer,
    RWKV time and channel mix and cross-attention as split sublayers
    (:func:`attn_train`, :func:`mlp_apply`, :func:`moe_apply`,
    :func:`mamba_apply`, :func:`rwkv_apply`, :func:`rwkv_ffn_apply`,
    :func:`cross_attn`) where :func:`_sublayer_modes` splits them, the
    sorted MoE dispatch as :func:`moe_apply_sorted`'s sublayer, every
    other leaf whole.  Tensors pass through."""
    sample = first_leaf(pparams)
    if not isinstance(sample, RowLeaf):
        return pparams
    row = sample.row
    specs = {f"l{i}": spec for i, spec in enumerate(cfg.period())}
    return {name: _materialize_layer(row, layer, _sublayer_modes(
        cfg, row.M, specs[name], _layer_mdim(layer)))
        for name, layer in pparams.items()}


def materialize_encoder(cfg, layer):
    """One encoder layer's leaves, as :func:`materialize` gives a
    period's: its attention (not causal) and gelu MLP split where their
    specs split them.  The encoder runs outside the periods' checkpoints
    (as JAX's plain ``lax.scan``), so each is fetched once a step.
    Tensors pass through."""
    sample = first_leaf(layer)
    if not isinstance(sample, RowLeaf):
        return layer
    row = sample.row
    return _materialize_layer(row, layer, _sublayer_modes(
        cfg, row.M, _ENCODER, _layer_mdim(layer)))


def _head_leaves(sp: _Split, m: int, spec) -> tuple:
    """``(leaves, spec)`` of position ``m``'s heads of a split attention
    or cross-attention sublayer: ``wq`` (and, mode ``"kv"``, ``wk``/``wv``)
    its columns and ``wo`` its rows; mode ``"pick"``: ``wk``/``wv``
    fetched whole, cut to the one kv head its query heads share."""
    M = sp.row.M
    Hq, hd = spec.n_heads // M, spec.head_dim
    p = {"wq": sp.p["wq"].part(m), "wo": sp.p["wo"].part(m)}
    if sp.mode == "kv":
        p["wk"], p["wv"] = sp.p["wk"].part(m), sp.p["wv"].part(m)
        sub = dataclasses.replace(spec, n_heads=Hq,
                                  n_kv_heads=spec.n_kv_heads // M)
    else:   # the one kv head position m's query heads share
        j = m * Hq // (spec.n_heads // spec.n_kv_heads)
        cols = slice(j * hd, (j + 1) * hd)
        p["wk"] = sp.p["wk"].whole(m)[:, cols]
        p["wv"] = sp.p["wv"].whole(m)[:, cols]
        sub = dataclasses.replace(spec, n_heads=Hq, n_kv_heads=1)
    for g in ("q_gamma", "k_gamma"):
        if g in sp.p:
            p[g] = sp.p[g].whole(m)
    return p, sub


def attn_train(sp: _Split, h, positions, spec):
    """``attn_train`` with the heads split over the row's positions: the
    partial outputs summed on the row's first position.  Returns ``(y,
    (None, None))`` (no cache: train mode only)."""
    row = sp.row
    hs = row.broadcast(h)
    ys = []
    for m in range(row.M):
        p, sub = _head_leaves(sp, m, spec)
        y, _ = _attn_train(p, hs[m], row.send(positions, m), sub)
        ys.append(y)
    return row.reduce(ys), (None, None)


def cross_attn(sp: _Split, x, positions, spec, memory, memory_pos):
    """``cross_attn`` with the heads split over the row's positions
    (train mode: no RoPE, not causal): position ``m`` takes ``q`` from
    its ``wq`` columns on ``x`` and ``k``/``v`` from its ``wk``/``wv``
    columns on the encoder memory.  ``x`` and the memory go to each
    position (the memory's gradient comes back summed as ``x``'s does);
    the partial outputs are summed on the row's first position.  Returns
    ``(y, (None, None))``."""
    row = sp.row
    xs, mems = row.broadcast(x), row.broadcast(memory)
    ys = []
    for m in range(row.M):
        p, sub = _head_leaves(sp, m, spec)
        y, _ = _cross_attn(p, xs[m], row.send(positions, m), sub, mems[m],
                           row.send(memory_pos, m))
        ys.append(y)
    return row.reduce(ys), (None, None)


def mlp_apply(sp: _Split, h, act: str):
    """``mlp_apply`` with ``d_ff`` split over the row's positions."""
    row = sp.row
    hs = row.broadcast(h)
    return row.reduce([_mlp_apply({k: v.part(m) for k, v in sp.p.items()},
                                  hs[m], act) for m in range(row.M)])


def moe_apply(sp: _Split, x, *, top_k: int, act: str):
    """``moe_apply`` (dense dispatch) with each expert's ``d_ff`` split
    over the row's positions.  The routing runs once, on the row's first
    position (the replicated router, in f32, as ``moe_route``); ``x`` and
    ``combine`` go to each position.  Position ``m`` fetches its ``d_ff``
    slice of every expert (the EP or FSDP gather over the data axes),
    runs each expert on it and accumulates ``combine[..., e] * y_e`` over
    the experts in f32, 4096 positions at a time as the whole form does.
    The partials are summed once for the sublayer (:meth:`Row.reduce`,
    f32 in position order, cast once to ``x``'s dtype): one sum where
    JAX's XLA may sum each expert's output over ``model``."""
    row = sp.row
    combine, _ = moe_route(sp.p["router"].whole(), x, top_k)
    xs, cs = row.broadcast(x), row.broadcast(combine)
    chunks = moe_chunks(x.shape[1])
    parts = []
    for m in range(row.M):
        p = {k: v.part(m) for k, v in sp.p.items() if k != "router"}
        outs = []
        for lo, hi in chunks:
            xb, cb = xs[m][:, lo:hi], cs[m][:, lo:hi].float()
            ob = None
            for e in range(p["w_up"].shape[0]):
                y = cb[..., e, None] * moe_expert(p, e, xb, act).float()
                ob = y if ob is None else ob + y
            outs.append(ob)
        parts.append(outs[0] if len(outs) == 1 else torch.cat(outs, 1))
    return row.reduce(parts, x.dtype)


def _sort_routes(rows: list, logits: list, top_k: int, E: int,
                 C: int) -> list:
    """Each row's ``(idx, keep, dst)`` for one chunk of the sorted
    dispatch (``logits``: each row's router logits ``(n, E)``, f32): its
    tokens' top-k experts ``(n, k)``, whether each assignment (flat ``(n,
    k)`` order) is kept, and its slot in an ``(E C + 1)``-row buffer
    (``E C``: dropped).  An assignment's rank within its expert is its
    place in the microbatch's stable sort by expert over the flat
    ``(row, b, s, k)`` order, as JAX's ``_moe_sorted_block`` sorts: the
    row's own stable sort plus the assignments of that expert in the rows
    before it; each row hands the next those counts (``E`` int64s, booked
    as ``routes``), the only bytes that cross data rows.  Kept where the
    rank is below ``C``."""
    out = []
    with torch.no_grad():
        before = torch.zeros(E, dtype=torch.int64, device=rows[0].home)
        for r, (row, lg) in enumerate(zip(rows, logits)):
            if r:
                n = before.numel() * before.element_size()
                prev = rows[r - 1].home
                row._book("routes", MoveStats(n, n if prev != row.home
                                              else 0))
                before = before.to(row.home)
            idx = torch.topk(lg, top_k, dim=-1).indices
            flat = idx.reshape(-1)
            order = torch.argsort(flat, stable=True)
            se = flat[order]
            rank = before[se] + (torch.arange(se.numel(), device=se.device)
                                 - torch.searchsorted(se, se, side="left"))
            dst = torch.empty_like(se)
            dst[order] = torch.where(rank < C, se * C + rank, E * C)
            out.append((idx, dst < E * C, dst))
            before = before + torch.bincount(flat, minlength=E)
    return out


def _sorted_experts(row: Row, experts: list, x, dst, E: int, C: int,
                    top_k: int, act: str):
    """Every assignment's expert output ``(n k, d)`` in ``x``'s dtype
    (dropped: 0) for one row's chunk ``x`` ``(n, d)``: each position of
    ``experts`` (one a position: its ``d_ff`` slice of every expert, or
    one whole set) packs the row's kept assignments into the ``(E, C,
    d)`` buffer at their slots ``dst``, runs the ``(E, C, ff)`` products
    on its slice and picks each assignment's row; the partials are summed
    on the row's first position (f32 in position order, cast once)."""
    n, d = x.shape
    split = len(experts) > 1
    xs = row.broadcast(x) if split else (x,)
    parts = []
    for m, p in enumerate(experts):
        at = row.send(dst, m)
        disp = torch.zeros((E * C + 1, d), dtype=x.dtype, device=at.device)
        disp[at] = xs[m][:, None, :].expand(n, top_k, d).reshape(-1, d)
        disp = disp[:E * C].reshape(E, C, d)
        up = torch.einsum("ecd,edf->ecf", disp, p["w_up"])
        if "w_gate" in p:
            up = up * act_fn(act)(torch.einsum("ecd,edf->ecf", disp,
                                               p["w_gate"]))
        else:
            up = act_fn(act)(up)
        y = torch.einsum("ecf,efd->ecd", up, p["w_down"]).reshape(E * C, d)
        # index_select: its backward adds each kept row's one gradient
        # (the dropped ones' zeros go to the cut row) in parallel
        parts.append(torch.cat([y, y.new_zeros((1, d))]).index_select(0, at))
    return row.reduce(parts) if split else parts[0]


def moe_apply_sorted(sps: list, xs: list, *, top_k: int, act: str,
                     capacity_factor: float = 1.25) -> list:
    """``moe_apply_sorted`` over one microbatch whose data rows hold its
    slices (``sps``: each row's sorted-dispatch sublayer, in the
    :class:`Micro`'s row order; ``xs``: each row's ``(b, S, d)`` slice),
    as JAX's ``_moe_sorted_block`` computes it over the whole microbatch.
    Per chunk (:func:`~repro_torch.models.layers.moe_sorted_chunks`):
    each row's router (whole on its first position) in f32, ``top_k``
    and the softmax of the top-k logits; the capacity ``C`` from the
    microbatch's ``N`` tokens in the chunk; the keep decision from the
    microbatch's stable sort (:func:`_sort_routes`), made once by the
    forward pass and taken again by the period's recomputation (the
    :class:`Micro`'s ``routes``), so both see one set of kept
    assignments.  Each row computes its own tokens' kept assignments
    (:func:`_sorted_experts`): where the experts' ``d_ff`` splits
    (``mode`` ``"part"``) each position its slice, as JAX pins
    ``up`` over ``model``, the experts over the data axes (EP) or ``d``
    over them (FSDP) gathered; else whole on the row's first position.
    The combine adds each token's ``top_k`` contributions in rank order
    from zero, as the whole form does.  Returns each row's output."""
    rows = [sp.row for sp in sps]
    micro = rows[0].micro
    b, S, d = xs[0].shape
    router = sps[0].p["router"]
    E = router.s.shape[-1]
    chunks = moe_sorted_chunks(S)
    C = moe_capacity(capacity_factor, len(xs) * b * (chunks[0][1]
                                                     - chunks[0][0]),
                     top_k, E)
    routers = [sp.p["router"].whole() for sp in sps]
    experts = [[{k: v.part(m) for k, v in sp.p.items() if k != "router"}
                for m in range(sp.row.M)] if sp.mode == "part"
               else [{k: v.whole() for k, v in sp.p.items()
                      if k != "router"}] for sp in sps]
    outs = [[] for _ in xs]
    for c, (lo, hi) in enumerate(chunks):
        xcs = [x[:, lo:hi].reshape(-1, d) for x in xs]
        logits = [xc.float() @ w for xc, w in zip(xcs, routers)]
        key = (router.k, router.period, c)
        if key not in micro.routes:
            micro.routes[key] = _sort_routes(rows, logits, top_k, E, C)
        for r, (xc, lg) in enumerate(zip(xcs, logits)):
            idx, keep, dst = micro.routes[key][r]
            w = torch.softmax(lg.gather(-1, idx), dim=-1).to(xc.dtype)
            y = _sorted_experts(rows[r], experts[r], xc, dst, E, C, top_k,
                                act)
            contrib = torch.where(keep[:, None], y * w.reshape(-1, 1),
                                  0.0).to(xc.dtype).reshape(-1, top_k, d)
            out = torch.zeros((xc.shape[0], d), dtype=xc.dtype,
                              device=xc.device)
            for j in range(top_k):
                out = out + contrib[:, j]
            outs[r].append(out.reshape(b, hi - lo, d))
    return [o[0] if len(o) == 1 else torch.cat(o, 1) for o in outs]


def mamba_apply(sp: _Split, x, state=None):
    """``mamba_apply`` (train mode: no state) with ``d_inner`` split over
    the row's positions, ``c = d_inner / M`` channels each.  ``in_proj``
    ``(d, 2 d_inner)`` is laid out in blocks of ``2c`` columns, which do
    not pair a position's ``xin`` channels with its ``z`` channels:
    position ``m`` fetches the two column ranges ``[m c, (m + 1) c)`` and
    ``[d_inner + m c, d_inner + (m + 1) c)`` from the positions holding
    them (booked as ``gather``).  The conv, ``dt_proj``, the scan (its
    state f32 per channel) and the gate run on its own channels;
    ``x_proj``'s rows give each position a partial ``(dt_in, B, C)``,
    summed on the row's first position (f32 in position order, cast
    once) and sent back; ``out_proj``'s rows give partial outputs, summed
    the same way.  Returns ``(y, None)``."""
    if state is not None:
        raise ValueError("a data row's split Mamba mixer runs in train "
                         "mode only (no decode state)")
    row, p = sp.row, sp.p
    B = x.shape[0]
    di = p["D"].s.shape[-1]
    c = di // row.M
    xs = row.broadcast(x)
    mine, projs = [], []
    for m in range(row.M):
        q = {k: v.part(m) for k, v in p.items() if k != "in_proj"}
        w = torch.cat([p["in_proj"].span(m, m * c, (m + 1) * c),
                       p["in_proj"].span(m, di + m * c, di + (m + 1) * c)],
                      -1)
        xin, z = torch.chunk(xs[m] @ w, 2, dim=-1)
        prev = torch.zeros((B, q["conv_w"].shape[0] - 1, c), dtype=x.dtype,
                           device=xin.device)
        xin, _ = mamba_conv(q, xin, prev)
        mine.append((q, xin, z))
        projs.append(xin @ q["x_proj"])
    ps = row.broadcast(row.reduce(projs))
    outs = []
    for (q, xin, z), proj in zip(mine, ps):
        ssm0 = torch.zeros((B, c, q["A_log"].shape[1]), dtype=torch.float32,
                           device=xin.device)
        y, _ = mamba_scan(q, xin, z, proj, ssm0)
        outs.append(y @ q["out_proj"])
    return row.reduce(outs), None


def rwkv_apply(sp: _Split, x, state=None):
    """RWKV's time mix (train mode: no state) with its heads split over
    the row's positions, ``H / M`` heads each.  ``x`` goes to each
    position; position ``m`` takes ``r``, ``k``, ``v`` and ``g`` from its
    columns of ``wr``/``wk``/``wv``/``wg``, its decay from ``tanh(mix
    @ wA) @ wB``'s columns (``wA`` fetched whole) plus its channels of
    ``w0``, its heads of ``u`` and its channels of ``ln_g``, and runs the
    WKV scan (its heads' f32 state), the group norm and the gate on its
    own heads; its rows of ``wo`` give a partial output, summed on the
    row's first position (f32 in position order, cast once).  Returns
    ``(y, None)``."""
    if state is not None:
        raise ValueError("a data row's split RWKV time mix runs in train "
                         "mode only (no decode state)")
    row, p = sp.row, sp.p
    B, _, d = x.shape
    H, hd = p["u"].s.shape[-2:]
    h = H // row.M
    xs = row.broadcast(x)
    outs = []
    for m in range(row.M):
        c0 = p["wr"].start(m)
        cols, heads = slice(c0, c0 + h * hd), slice(c0 // hd, c0 // hd + h)
        q = {k: p[k].part(m) for k in _RWKV_PARTS}
        q.update(mu=p["mu"].whole(m), wA=p["wA"].whole(m),
                 w0=p["w0"].whole(m)[cols], ln_g=p["ln_g"].whole(m)[cols],
                 u=p["u"].whole(m)[heads])
        last = torch.zeros((B, d), dtype=x.dtype, device=xs[m].device)
        S0 = torch.zeros((B, h, hd, hd), dtype=torch.float32,
                         device=xs[m].device)
        y, _ = time_mix(q, xs[m], shift(xs[m], last), S0)
        outs.append(y)
    return row.reduce(outs), None


def rwkv_ffn_apply(sp: _Split, x, state=None):
    """RWKV's channel mix (train mode: no state) with ``d_ff`` split over
    the row's positions, ``f = d_ff / M`` each.  ``wv`` ``(d_ff, d)``
    takes the attention rule by name, so ``model`` lies on its ``d``, not
    on ``d_ff``: position ``m`` fetches the rows ``[m f, (m + 1) f)`` of
    ``wv`` that pair with its ``kk = relu(xk @ wk)²`` columns, across the
    ``model`` blocks (a span, booked as ``gather``), and its partial ``kk
    @ wv`` is summed on the row's first position (f32 in position order,
    cast once).  ``rr = sigmoid(xr @ wr)`` comes from ``wr``'s column
    slices, collected there in position order.  Returns ``(rr * vv,
    None)``."""
    if state is not None:
        raise ValueError("a data row's split RWKV channel mix runs in "
                         "train mode only (no decode state)")
    row, p = sp.row, sp.p
    B, _, d = x.shape
    f = p["wk"].s.shape[-1] // row.M
    xs = row.broadcast(x)
    vvs, rrs = [], []
    for m in range(row.M):
        q = {"mu": p["mu"].whole(m), "wk": p["wk"].part(m),
             "wv": p["wv"].span(m, m * f, (m + 1) * f, dim=0),
             "wr": p["wr"].part(m)}
        last = torch.zeros((B, d), dtype=x.dtype, device=xs[m].device)
        vv, rr = channel_mix(q, xs[m], shift(xs[m], last))
        vvs.append(vv)
        rrs.append(rr)
    return torch.cat(row.collect(rrs), -1) * row.reduce(vvs), None


def splits_vocab(w) -> bool:
    """Whether ``w`` (the embedding or the head) is the leaf of a row
    that :func:`splits` whose vocabulary splits over ``model``."""
    return isinstance(w, RowLeaf) and w.row.split and w.model_dim() is not None


def vocab_lookup(e: RowLeaf, tokens):
    """``embed[tokens]`` as the sum of each position's masked rows."""
    row = e.row
    parts = []
    for m in range(row.M):
        w = e.part(m)
        local = row.send(tokens, m) - e.start(m)
        own = (local >= 0) & (local < w.shape[0])
        rows = w[torch.where(own, local, 0)]
        parts.append(torch.where(own[..., None], rows, 0))
    return row.reduce(parts)


def vocab_head_loss(w: RowLeaf, x, labels, valid, dt):
    """``lm.head_loss`` with the head's vocabulary split over the row's
    positions (``w``: the tied embedding ``(V, d)`` or ``lm_head`` ``(d,
    V)``; ``valid``: the labels not masked): each position's
    ``logsumexp`` of its f32 logits, combined on the row's first position
    (the max over the slices, then the sum of exponentials against it),
    and the gold logit from the slice that owns the label's row."""
    row, M = w.row, w.row.M
    vdim = w.model_dim()
    xs = row.broadcast(x)
    ws = [w.part(m) for m in range(M)]
    lses = []
    for m, wm in enumerate(ws):
        wm = wm.to(dt)
        logits = xs[m] @ (wm.T if vdim == 0 else wm)
        lses.append(torch.logsumexp(logits.float(), dim=-1))
        del logits
    lse = torch.logsumexp(torch.stack(row.collect(lses)), dim=0)
    golds = []
    for m, wm in enumerate(ws):
        lab = row.send(torch.where(valid, labels, -1), m)
        local = lab - w.start(m)
        own = (lab >= 0) & (local >= 0) & (local < wm.shape[vdim])
        safe = torch.where(own, local, 0)
        rows = (wm[safe] if vdim == 0
                else torch.movedim(wm[:, safe], 0, -1)).to(dt)
        gold = torch.einsum("bsd,bsd->bs", xs[m], rows).float()
        golds.append(torch.where(own, gold, 0.0))
    nll = (lse - row.reduce(golds)) * valid
    return nll.sum() / valid.sum().clamp_min(1)


# ---------------------------------------------------------------------------
# composed from the specs
# ---------------------------------------------------------------------------

def _uses(cfg, M: int, modes: dict, sub: str, name: str) -> list:
    """``[(position, part, span)]``: the uses one forward pass of a layer
    (``modes`` as :func:`_sublayer_modes` gives them) makes of its leaf
    ``name`` of sublayer ``sub`` (``span`` as :func:`_fetch_plan` takes
    it, the stack dim counted)."""
    every = range(M)
    if sub in ("attn", "cross") and modes[sub]:
        kv_whole = modes[sub] == "pick" and name in ("wk", "wv")
        part = name in _ATTN_PARTS and not kv_whole
        return [(m, part, None) for m in every]
    if sub == "ffn" and (modes["moe"] or modes["sorted"]) and (
            name == "router" or modes["sorted"] == "whole"):
        return [(0, False, None)]
    if sub == "ffn" and modes["sorted"]:
        return [(m, True, None) for m in every]
    if sub == "ffn" and modes["cmix"]:
        if name == "wv":    # the rows of d_ff that pair with kk's slice
            f = cfg.d_ff // M
            return [(m, False, (1, m * f, (m + 1) * f)) for m in every]
        return [(m, name != "mu", None) for m in every]
    if sub == "mix" and modes["rwkv"]:
        return [(m, name in _RWKV_PARTS, None) for m in every]
    if (sub == "ffn" and (modes["ffn"] or modes["moe"])
            or sub == "mix" and modes["mix"] and name != "in_proj"):
        return [(m, True, None) for m in every]
    if sub == "mix" and modes["mix"]:   # in_proj: xin's, z's
        di = cfg.d_inner
        c = di // M
        return [(m, False, (2, lo, lo + c)) for m in every
                for lo in (m * c, di + m * c)]
    return [(0, False, None)]


def row_moves(cfg, params, shardings, first, devs, batch: int,
              seq_len: int) -> tuple:
    """What one (microbatch, row) slice of ``batch`` rows of ``seq_len``
    tokens books on a mesh, from the leaves' shapes and dtypes
    (``params``, ``meta`` tensors will do), their ``shardings`` and the
    mesh's device of each position (``devs``): ``(gather, model,
    pieces)``, ``pieces`` as ``[(bytes, position)]``, a stacked leaf's
    periods (or encoder layers) as one.  A VLM's stack runs on its
    ``frontend_len`` patch rows and the text; an encoder runs on
    ``frontend_len`` frames."""
    from repro_torch.training.tree import leaves

    ls, shs = leaves(params), leaves(shardings)
    devs = tuple(devs)
    paths = _paths(params)
    mesh = shs[0].mesh
    axes = mesh.axis_names
    M = mesh.shape["model"] if "model" in axes else 1
    mi = axes.index("model") if "model" in axes else None
    pos = mesh.positions()
    ks = [pos.index(tuple(m if i == mi else c for i, c in enumerate(first)))
          for m in range(M)]
    split = splits(cfg, M)
    gather, pieces = MoveStats(), []

    def use(k, m, part, times, span=None):
        """Position ``m`` of the row uses leaf ``k`` (each of its periods)
        ``times`` times (``span`` as :func:`_fetch_plan` takes it)."""
        nonlocal gather
        t, sh = ls[k], shs[k]
        n = t.element_size()
        pos, dev, used = _fetch_elements(sh, tuple(t.shape), ks[m], part,
                                         devs, span)
        gather += MoveStats(pos * n * times, dev * n * times)
        pieces.append((used * n, ks[m]))

    by_path = {p: k for k, p in enumerate(paths)}

    def mdim_of(path):
        k = by_path[path]
        return _model_dim(shs[k], ls[k].ndim,
                          1 if path[0] in ("blocks", "encoder") else 0)

    def stack(prefix, spec, layer, times, count, n_split):
        """Book the stacked layer ``layer`` (``()`` for the encoder's)
        under ``prefix``: every leaf's uses ``times`` times a period;
        count its split sublayers ``count`` times in ``n_split``."""
        def lmdim(sub, name):
            path = (prefix, *layer, sub, name)
            return mdim_of(path) if path in by_path else "absent"

        modes = _sublayer_modes(cfg, M, spec, lmdim)
        for sub in n_split:   # the sorted dispatch's copies: "part" only
            n_split[sub] += bool(modes[sub] not in (None, False, "whole")
                                 ) * count
        n = len(layer) + 1
        for k, path in enumerate(paths):
            if path[0] == prefix and path[1:n] == layer:
                sub = path[n] if len(path) > n + 1 else None
                for m, part, span in _uses(cfg, M, modes, sub, path[-1]):
                    use(k, m, part, times, span)

    # each period: its forward and its recomputation; each encoder layer
    # once (the encoder runs outside the periods' checkpoints)
    n_split, n_enc = dict.fromkeys(_WHOLE, 0), dict.fromkeys(_WHOLE, 0)
    for i, spec in enumerate(cfg.period()):
        stack("blocks", spec, (f"l{i}",), 2, cfg.n_periods, n_split)
    if cfg.encoder_layers:
        stack("encoder", _ENCODER, (), 1, cfg.encoder_layers, n_enc)
    head = "embed" if cfg.tie_embeddings else "lm_head"
    vocab = {}
    for k, path in enumerate(paths):
        name = path[0]
        if name in ("blocks", "encoder"):
            continue
        vocab[name] = split and name in ("embed", "lm_head") and (
            mdim_of(path) is not None)
        # the tied embedding: the lookup and the head
        uses = 2 if name == "embed" and name == head else 1
        for m in (range(M) if vocab[name] else (0,)):
            use(k, m, vocab[name], uses)

    # the model axis: each position other than the row's first, and those
    # of them on another device than the first
    e = torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
    i64 = torch.int64.itemsize
    # the stack's rows (a VLM's patches and the text), the encoder's
    # frames, the text's rows (tokens and labels int32, training/data.py;
    # the loss's maxima, sums and gold logits f32)
    S = seq_len + (cfg.frontend_len if cfg.frontend == "vision_stub" else 0)
    F = cfg.frontend_len if cfg.encoder_layers else 0
    T, Tt = batch * S, batch * seq_len
    act, act_t, mem = (T * cfg.d_model * e, Tt * cfg.d_model * e,
                       batch * F * cfg.d_model * e)
    tok = Tt * torch.int32.itemsize
    f32 = Tt * torch.float32.itemsize
    # forward, recomputation and backward: the input out and the partials
    # back, then their gradients; the positions in the first two.  The
    # MoE also sends combine out and takes f32 partials back; the Mamba
    # mixer also takes x_proj's partials back and sends their sum out;
    # the channel mix also takes each slice of rr back; the
    # cross-attention also sends the memory out and takes its gradient
    # back, and sends the memory's positions; the sorted MoE dispatch
    # sends the input out and each assignment's slot (int64), and takes
    # each assignment's partial output (n k rows) back
    comb = T * cfg.n_experts * e
    assign = T * cfg.experts_per_token
    sort = 3 * act + 2 * assign * i64 + 3 * assign * cfg.d_model * e
    dt_rank = max(1, math.ceil(cfg.d_model / 16))    # ssm.mamba_init's
    proj = T * (dt_rank + 2 * cfg.ssm_d_state) * e
    per = (3 * 2 * act * (n_split["attn"] + n_split["ffn"]
                          + n_split["rwkv"])
           + 2 * S * i64 * n_split["attn"]
           + 3 * (act + comb + T * 4 * cfg.d_model) * n_split["moe"]
           + 3 * 2 * (act + proj) * n_split["mix"]
           + 3 * (2 * act + act // M) * n_split["cmix"]
           + (3 * (2 * act + mem) + 2 * (S + F) * i64) * n_split["cross"]
           + sort * n_split["sorted"])
    # the encoder's layers: forward and backward, its positions once
    act_e = batch * F * cfg.d_model * e
    per += (2 * 2 * act_e * (n_enc["attn"] + n_enc["ffn"])
            + F * i64 * n_enc["attn"])
    if vocab.get("embed"):   # the tokens; the rows and their gradient
        per += tok + 2 * act_t
    if vocab.get(head):      # x and its gradient, the labels; each
        #                      slice's logsumexp and gold logits, and their
        #                      gradients
        per += 2 * act_t + tok + 4 * f32
    model = MoveStats(per * (M - 1),
                      per * sum(1 for k in ks[1:] if devs[k] != devs[ks[0]]))
    return gather, model, pieces


def _paths(tree, path=()) -> list:
    """Each leaf's keys, in :func:`~repro_torch.training.tree.leaves`'
    order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], path + (k,))]
    return [path]
