"""Unified language model over the period-structured layer stack.

The port of the JAX package's ``models/lm.py``; one implementation serves
all 10 assigned architectures:

* ``init_params``  — random initialization from a ``torch.Generator``, on
  the generator's device (``param_specs``: the same tree on the ``meta``
  device, allocation-free);
* ``forward``      — full-sequence logits (also Whisper enc-dec and the
  stub-frontend VLM prefix);
* ``prefill``      — the prompt's last logits and the decode cache;
* ``decode_step``  — one token through the stack against the cache;
* ``loss_fn``      — the masked next-token cross-entropy (training).

Parameter and cache trees are the JAX package's: the same keys, a leading
``n_periods`` axis on ``blocks`` and on every cache leaf (``n_layers``
on ``encoder``), ``x @ W`` layouts, each leaf in its own dtype (Mamba's
``dt_bias``/``A_log``/``D``, RWKV's ``w0``/``u`` and the MoE ``router`` are
f32 in any model).  A tree carries across as a map over its leaves
(:mod:`repro_torch.interop`).  The stack is a loop over periods; prefill
and decode write each period's new cache leaves into the stacked cache in
place, and decode writes the attention K/V slot in place.  When autograd
records (training), each period runs under ``torch.utils.checkpoint``
(non-reentrant: the period reads its parameters from its arguments'
trees, which a reentrant checkpoint would give no gradient), as JAX's
``jax.checkpoint(policy=nothing_saveable)``: only the period inputs are
saved and the backward recomputes each period.

The mesh train step runs ``row_losses`` on the data rows' views of a
sharded tree (:mod:`repro_torch.models.tensor_parallel`); ``loss_fn``
takes whole trees only.  Each period gathers its leaves inside the
period (so the backward pass gathers them again, the recomputation
running to the period's end), the embedding and head where they are
used, and the attention, dense MLP, MoE (either dispatch), Mamba mixer,
RWKV time and channel mix, cross-attention, the encoder's layers
(fetched once: the encoder runs outside the periods' checkpoints) and
vocabulary run split over the row's ``model`` positions where their
specs split.  Where a microbatch's rows couple (the sorted dispatch),
``row_losses`` runs them through the stack together, a period at a time.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.env import resolve_device
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.attention import (AttnSpec, attention_init,
                                          attn_decode, attn_train,
                                          cross_attn, flash_attention)
from repro_torch.models.config import LayerKind, ModelConfig
from repro_torch.models.layers import (MetaGenerator, dense_init,
                                       mlp_apply, mlp_init, moe_apply,
                                       moe_apply_sorted, moe_init, rms_norm,
                                       torch_dtype)
from repro_torch.models.rwkv import (rwkv_apply, rwkv_ffn_apply,
                                     rwkv_ffn_init, rwkv_init)
from repro_torch.models.ssm import mamba_apply, mamba_init

__all__ = ["D_CONV", "MASK_LABEL", "attn_spec", "init_params",
           "param_specs", "init_cache", "cache_specs", "encode",
           "hidden_states", "forward", "loss_fn", "row_losses", "head_loss",
           "prefill", "decode_step"]

D_CONV = 4
MASK_LABEL = -100


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def attn_spec(cfg: ModelConfig, *, cross: bool = False,
              causal: bool | None = None) -> AttnSpec:
    if causal is None:
        causal = False if cross else cfg.causal  # cross-attn is never causal
    return AttnSpec(
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        causal=causal,
        use_rope=not cross and cfg.frontend != "audio_stub",
        rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm and not cross,
        sliding_window=None if cross else cfg.sliding_window,
        norm_eps=cfg.norm_eps, swa_chunk_skip=cfg.swa_chunk_skip)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _stack(trees: list):
    """Stack same-shaped trees along a new leading axis (one tree: a view)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if len(trees) == 1:
        return trees[0].unsqueeze(0)
    return torch.stack(trees)


def _index(tree, i: int):
    """The ``i``-th slice of every leaf (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _write_back(old: dict, new: dict) -> None:
    """Copy a period's new cache leaves into its slice of the stacked
    cache, unless a leaf was written there in place."""
    for k, o in old.items():
        if isinstance(o, dict):
            _write_back(o, new[k])
        elif new[k] is not o:
            o.copy_(new[k])


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters on ``gen.device``, drawn in a fixed order."""
    dt = _dtype(cfg)
    dev = gen.device
    d = cfg.d_model

    def ones():
        return torch.ones((d,), dtype=dt, device=dev)

    params: dict[str, Any] = {
        "embed": dense_init(gen, (cfg.vocab_size, d), dt, scale=0.02),
        "final_ln": ones(),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab_size), dt)

    def one_layer(spec):
        p = {"ln1": ones(), "ln2": ones()}
        if spec.kind == LayerKind.ATTN:
            p["attn"] = attention_init(gen, d, attn_spec(cfg), dt)
        elif spec.kind == LayerKind.MAMBA:
            p["mix"] = mamba_init(gen, d, cfg.d_inner, cfg.ssm_d_state,
                                  D_CONV, dt)
        else:
            p["mix"] = rwkv_init(gen, d, cfg.rwkv_head_dim, dt)
        if cfg.cross_attention:
            p["cross"] = attention_init(gen, d, attn_spec(cfg, cross=True),
                                        dt)
            p["ln_x"] = ones()
        if spec.kind == LayerKind.RWKV:
            p["ffn"] = rwkv_ffn_init(gen, d, cfg.d_ff, dt)
        elif spec.moe:
            p["ffn"] = moe_init(gen, d, cfg.d_ff, cfg.n_experts,
                                cfg.act_gated, dt)
        else:
            p["ffn"] = mlp_init(gen, d, cfg.d_ff, cfg.act_gated, dt)
        return p

    params["blocks"] = _stack([
        {f"l{i}": one_layer(s) for i, s in enumerate(cfg.period())}
        for _ in range(cfg.n_periods)])

    if cfg.encoder_layers:
        espec = attn_spec(cfg, causal=False)
        params["encoder"] = _stack([
            {"ln1": ones(), "ln2": ones(),
             "attn": attention_init(gen, d, espec, dt),
             "ffn": mlp_init(gen, d, cfg.d_ff, False, dt)}
            for _ in range(cfg.encoder_layers)])
        params["encoder_ln"] = ones()
    return params


def param_specs(cfg: ModelConfig) -> dict:
    """Allocation-free parameter tree: ``init_params``'s shapes and dtypes
    as ``meta`` tensors (JAX's ``eval_shape`` of ``init_params``)."""
    return init_params(cfg, MetaGenerator())


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               memory_len: int = 0, device="cuda") -> dict:
    """Decode cache tree, leaves stacked over periods (axis 0), zeros
    (``meta`` tensors for ``device="meta"``)."""
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    dt = _dtype(cfg)
    d = cfg.d_model
    P = cfg.n_periods

    def zeros(shape, dtype=dt):
        return torch.zeros((P,) + shape, dtype=dtype, device=dev)

    def one_layer(spec):
        c = {}
        if spec.kind == LayerKind.ATTN:
            # sliding-window archs keep a ring buffer of W slots
            klen = min(max_len, cfg.sliding_window or max_len)
            kv = (batch, klen, cfg.n_kv_heads, cfg.hd)
            c["k"] = zeros(kv)
            c["v"] = zeros(kv)
        elif spec.kind == LayerKind.MAMBA:
            c["conv"] = zeros((batch, D_CONV - 1, cfg.d_inner))
            c["ssm"] = zeros((batch, cfg.d_inner, cfg.ssm_d_state),
                             torch.float32)
        else:  # rwkv
            hd = cfg.rwkv_head_dim
            c["S"] = zeros((batch, d // hd, hd, hd), torch.float32)
            c["last"] = zeros((batch, d))
            c["ffn_last"] = zeros((batch, d))
        if cfg.cross_attention:
            mkv = (batch, memory_len, cfg.n_kv_heads, cfg.hd)
            c["ck"] = zeros(mkv)
            c["cv"] = zeros(mkv)
        return c

    return {f"l{i}": one_layer(s) for i, s in enumerate(cfg.period())}


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                memory_len: int = 0) -> dict:
    """Allocation-free decode cache tree (``meta`` tensors)."""
    return init_cache(cfg, batch, max_len, memory_len, device="meta")


# ---------------------------------------------------------------------------
# block application (one period)
# ---------------------------------------------------------------------------

def _apply_period(cfg: ModelConfig, pparams, x, positions, cache, mode,
                  memory=None, memory_pos=None, pos=None):
    """Run one period of layers of a whole tree.  mode: train | prefill |
    decode."""
    new_cache = {}
    for i, spec in enumerate(cfg.period()):
        p = pparams[f"l{i}"]
        c = cache[f"l{i}"] if cache is not None else None
        x, nc = _mixers(cfg, spec, p, x, positions, c, mode, memory,
                        memory_pos, pos)
        x = x + _ffn(cfg, spec, p, rms_norm(x, p["ln2"], cfg.norm_eps), c,
                     mode, nc)
        new_cache[f"l{i}"] = nc if nc else (c if c is not None else {})
    return x, new_cache


def _apply_period_rows(cfg: ModelConfig, pparams: list, xs: list,
                       positions: list, memories: list) -> list:
    """One period (train mode) over the data rows of one microbatch
    (``pparams``: each row's view of the period; ``xs``, ``positions``
    and ``memories`` (``(memory, memory_pos)``) each row's): each
    sublayer runs each row's slice on its own positions, layer by layer,
    and the sorted MoE dispatch runs once over every row
    (:func:`~repro_torch.models.tensor_parallel.moe_apply_sorted`)."""
    ps = [tp.materialize(cfg, pp) for pp in pparams]
    for i, spec in enumerate(cfg.period()):
        name = f"l{i}"
        xs = [_mixers(cfg, spec, p[name], x, pos, None, "train", *mem)[0]
              for p, x, pos, mem in zip(ps, xs, positions, memories)]
        h2s = [rms_norm(x, p[name]["ln2"], cfg.norm_eps)
               for p, x in zip(ps, xs)]
        if spec.moe and cfg.moe_dispatch == "sorted":
            ys = tp.moe_apply_sorted([p[name]["ffn"] for p in ps], h2s,
                                     **_sorted_kw(cfg))
        else:
            ys = [_ffn(cfg, spec, p[name], h2, None, "train", {})
                  for p, h2 in zip(ps, h2s)]
        xs = [x + y for x, y in zip(xs, ys)]
    return xs


def _sorted_kw(cfg: ModelConfig) -> dict:
    return dict(top_k=cfg.experts_per_token, act=cfg.act,
                capacity_factor=cfg.moe_capacity_factor)


def _mixers(cfg: ModelConfig, spec, p, x, positions, c, mode, memory=None,
            memory_pos=None, pos=None):
    """A layer's attention, Mamba or RWKV sublayer and its
    cross-attention, each with its residual add: ``(x, new cache
    leaves)``."""
    nc = {}
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.kind == LayerKind.ATTN:
        if mode == "decode":
            y, kv = attn_decode(p["attn"], h, pos,
                                {"k": c["k"], "v": c["v"]},
                                attn_spec(cfg))
            nc.update(kv)
        else:
            y, (k, v) = (tp.attn_train if tp.is_split(p["attn"])
                         else attn_train)(p["attn"], h, positions,
                                          attn_spec(cfg))
            if mode == "prefill":
                nc["k"] = _prefill_write(c["k"], k)
                nc["v"] = _prefill_write(c["v"], v)
    elif spec.kind == LayerKind.MAMBA:
        y, st = (tp.mamba_apply if tp.is_split(p["mix"])
                 else mamba_apply)(p["mix"], h,
                                   state=c if mode == "decode" else None)
        if mode in ("prefill", "decode"):
            nc.update({"conv": st["conv"].to(c["conv"].dtype),
                       "ssm": st["ssm"]})
    else:  # RWKV
        y, st = (tp.rwkv_apply if tp.is_split(p["mix"])
                 else rwkv_apply)(p["mix"], h,
                                  state={"S": c["S"], "last": c["last"]}
                                  if mode == "decode" else None)
        if mode in ("prefill", "decode"):
            nc.update({"S": st["S"], "last": st["last"].to(x.dtype)})
    x = x + y

    if cfg.cross_attention:
        hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
        cspec = attn_spec(cfg, cross=True)
        if mode == "decode":
            yx = _cross_decode(p["cross"], hx, c["ck"], c["cv"], cspec)
            nc["ck"], nc["cv"] = c["ck"], c["cv"]
        else:
            yx, (ck, cv) = (tp.cross_attn if tp.is_split(p["cross"])
                            else cross_attn)(p["cross"], hx, positions,
                                             cspec, memory, memory_pos)
            if mode == "prefill":
                nc["ck"], nc["cv"] = (ck.to(c["ck"].dtype),
                                      cv.to(c["cv"].dtype))
        x = x + yx
    return x, nc


def _ffn(cfg: ModelConfig, spec, p, h2, c, mode, nc):
    """A layer's MLP, MoE or RWKV channel mix on its normalised input
    ``h2`` (a decode state written into ``nc``)."""
    if spec.kind == LayerKind.RWKV:
        y2, st = (tp.rwkv_ffn_apply if tp.is_split(p["ffn"])
                  else rwkv_ffn_apply)(p["ffn"], h2,
                                       state={"last": c["ffn_last"]}
                                       if mode == "decode" else None)
        if mode in ("prefill", "decode"):
            nc["ffn_last"] = st["last"].to(h2.dtype)
        return y2
    if not spec.moe:
        return (tp.mlp_apply if tp.is_split(p["ffn"])
                else mlp_apply)(p["ffn"], h2, cfg.act)
    if cfg.moe_dispatch == "sorted":   # whole: rows sort together
        return moe_apply_sorted(p["ffn"], h2, **_sorted_kw(cfg))
    return (tp.moe_apply if tp.is_split(p["ffn"])
            else moe_apply)(p["ffn"], h2, top_k=cfg.experts_per_token,
                            act=cfg.act)


def _prefill_write(cache_leaf, new):
    """Write prefill k/v into the cache slice; ring-rolled if the cache is
    a sliding-window buffer shorter than the prompt."""
    W = cache_leaf.shape[1]
    S = new.shape[1]
    new = new.to(cache_leaf.dtype)
    if S <= W:
        cache_leaf[:, :S] = new
        return cache_leaf
    last = new[:, -W:]                   # positions S-W .. S-1
    start = (S - W) % W                  # slot of position S-W
    return torch.roll(last, start, dims=1)


def _cross_decode(p, x, ck, cv, spec):
    """Single-token cross-attention against the cached encoder memory."""
    B = x.shape[0]
    H, hd = spec.n_heads, spec.head_dim
    q = (x @ p["wq"]).reshape(B, 1, H, hd)
    q_pos = torch.zeros((1,), dtype=torch.int64, device=x.device)
    kv_pos = torch.arange(ck.shape[1], dtype=torch.int64, device=x.device)
    out = flash_attention(q, ck, cv, q_pos, kv_pos, spec)
    return out.reshape(B, 1, H * hd) @ p["wo"]


# ---------------------------------------------------------------------------
# encoder (Whisper) & frontends (stubs)
# ---------------------------------------------------------------------------

def encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """Whisper encoder over precomputed frame embeddings (the conv
    frontend is a stub: the caller provides the embeddings)."""
    x = frames + _sinusoidal(frames.shape[1], cfg.d_model, frames.dtype,
                             frames.device)
    espec = attn_spec(cfg, causal=False)
    positions = torch.arange(frames.shape[1], dtype=torch.int64,
                             device=frames.device)
    for i in range(cfg.encoder_layers):
        lp = tp.materialize_encoder(cfg, _index(params["encoder"], i))
        y, _ = (tp.attn_train if tp.is_split(lp["attn"]) else attn_train)(
            lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps), positions,
            espec)
        x = x + y
        x = x + (tp.mlp_apply if tp.is_split(lp["ffn"]) else mlp_apply)(
            lp["ffn"], rms_norm(x, lp["ln2"], cfg.norm_eps), "gelu")
    return rms_norm(x, tp.whole(params["encoder_ln"]), cfg.norm_eps)


def _sinusoidal(S: int, d: int, dtype, device) -> torch.Tensor:
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10_000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


# ---------------------------------------------------------------------------
# full model entry points
# ---------------------------------------------------------------------------

def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _records(x, params) -> bool:
    """Whether autograd records the stack: grad mode on and the input or
    a block parameter requires grad."""
    return torch.is_grad_enabled() and (
        x.requires_grad
        or any(t.requires_grad for t in _leaves(params["blocks"])))


def _run_stack(cfg, params, x, positions, cache, mode, memory=None,
               memory_pos=None, pos=None):
    """The periods in order.  In mode ``train`` with autograd recording,
    each period is recomputed in the backward pass (and so are the
    recurrences' time chunks inside it)."""
    remat = mode == "train" and _records(x, params)
    for i in range(cfg.n_periods):
        pcache = _index(cache, i) if cache is not None else None
        args = (cfg, _index(params["blocks"], i), x, positions, pcache, mode)
        kw = dict(memory=memory, memory_pos=memory_pos, pos=pos)
        if remat:
            x, nc = checkpoint(_apply_period, *args, use_reentrant=False,
                               preserve_rng_state=False, **kw)
        else:
            x, nc = _apply_period(*args, **kw)
        if pcache is not None:
            _write_back(pcache, nc)
    return x, cache


def _embed(cfg, params, tokens):
    e = params["embed"]
    if tp.splits_vocab(e):
        return tp.vocab_lookup(e, tokens).to(_dtype(cfg))
    return tp.whole(e)[tokens].to(_dtype(cfg))


def _inputs(cfg, params, tokens, frontend):
    """Embedded inputs, the encoder memory and the number of prefix rows."""
    dt = _dtype(cfg)
    x = _embed(cfg, params, tokens)
    memory = memory_pos = None
    n_prefix = 0
    if cfg.encoder_layers:
        memory = encode(cfg, params, frontend.to(dt))
        memory_pos = torch.arange(memory.shape[1], dtype=torch.int64,
                                  device=x.device)
    elif cfg.frontend == "vision_stub":
        x = torch.cat([frontend.to(dt), x], dim=1)
        n_prefix = frontend.shape[1]
    if cfg.frontend == "audio_stub" and not cfg.encoder_layers:
        x = x + _sinusoidal(x.shape[1], cfg.d_model, dt, x.device)
    return x, memory, memory_pos, n_prefix


def hidden_states(cfg: ModelConfig, params, tokens: torch.Tensor,
                  frontend: torch.Tensor | None = None) -> torch.Tensor:
    """Final-norm hidden states (B, S_text, d) for the full sequence.

    tokens: (B, S) integers.  frontend: precomputed modality embeddings —
    Whisper: (B, F, d) encoder frames; VLM: (B, Np, d) patch embeddings
    prepended to the text sequence.  When autograd records, only each
    period's input (and each recurrence's chunk-boundary states) is
    saved, and the rest is recomputed in the backward pass.
    """
    x, memory, memory_pos, n_prefix = _inputs(cfg, params, tokens, frontend)
    positions = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
    x, _ = _run_stack(cfg, params, x, positions, None, "train",
                      memory=memory, memory_pos=memory_pos)
    return _final(cfg, params, x, n_prefix)


def _final(cfg, params, x, n_prefix: int):
    """The final norm, the prefix rows cut."""
    x = rms_norm(x, tp.whole(params["final_ln"]), cfg.norm_eps)
    if n_prefix:
        x = x[:, n_prefix:, :]
    return x


def _head(cfg, params):
    return (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(_dtype(cfg))


def forward(cfg: ModelConfig, params, tokens: torch.Tensor,
            frontend: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence logits (B, S, V)."""
    return hidden_states(cfg, params, tokens, frontend) @ _head(cfg, params)


def loss_fn(cfg: ModelConfig, params, tokens: torch.Tensor,
            labels: torch.Tensor,
            frontend: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy; labels == ``MASK_LABEL`` are masked.

    JAX's ``lm.loss_fn`` term for term: the logits in the model dtype,
    ``logsumexp`` of their f32 upcast, and the gold logit from the
    label's head *row* (an (B, S, d) gather, then a dot with the hidden
    state upcast to f32), never a gather from the (B, S, V) logits.
    """
    x = hidden_states(cfg, params, tokens, frontend)
    return head_loss(cfg, params, x, labels)


def row_losses(cfg: ModelConfig, trees: list, batches: list) -> list:
    """``loss_fn`` of each data row's slice of one microbatch (``trees``:
    the rows' views, :func:`~repro_torch.models.tensor_parallel.micro_view`;
    ``batches``: their slices, ``tokens``, ``labels`` and perhaps
    ``frontend``).  Each row embeds, encodes and takes its loss alone; the
    stack runs every row a period at a time, each period under one
    ``checkpoint`` (recomputed to its end), so a sorted MoE dispatch sees
    the whole microbatch (:func:`_apply_period_rows`)."""
    ins = [_inputs(cfg, t, b["tokens"], b.get("frontend"))
           for t, b in zip(trees, batches)]
    xs = [i[0] for i in ins]
    positions = [torch.arange(x.shape[1], dtype=torch.int64,
                              device=x.device) for x in xs]
    memories = [(i[1], i[2]) for i in ins]
    for k in range(cfg.n_periods):
        with set_checkpoint_early_stop(False):
            xs = checkpoint(_apply_period_rows, cfg,
                            [_index(t["blocks"], k) for t in trees], xs,
                            positions, memories, use_reentrant=False,
                            preserve_rng_state=False)
    return [head_loss(cfg, t, _final(cfg, t, x, i[3]), b["labels"])
            for t, x, i, b in zip(trees, xs, ins, batches)]


def head_loss(cfg: ModelConfig, params, x: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """``loss_fn`` from the final hidden states ``x`` (B, S, d) on."""
    dt = _dtype(cfg)
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    valid = labels != MASK_LABEL
    if tp.splits_vocab(w):
        return tp.vocab_head_loss(w, x, labels, valid, dt)
    w = tp.whole(w)
    logits = x @ (w.T if cfg.tie_embeddings else w).to(dt)
    lse = torch.logsumexp(logits.float(), dim=-1)
    del logits
    safe = torch.where(valid, labels, 0)
    if cfg.tie_embeddings:
        rows = w[safe].to(dt)                                   # (B, S, d)
    else:
        rows = torch.movedim(w[:, safe], 0, -1).to(dt)
    gold = torch.einsum("bsd,bsd->bs", x, rows).float()
    nll = (lse - gold) * valid
    return nll.sum() / valid.sum().clamp_min(1)


def prefill(cfg: ModelConfig, params, tokens, max_len: int,
            frontend: torch.Tensor | None = None):
    """Run the prompt, build the decode cache.  Returns (logits (B, V),
    cache)."""
    B = tokens.shape[0]
    x, memory, memory_pos, _ = _inputs(cfg, params, tokens, frontend)
    mem_len = memory.shape[1] if memory is not None else 0
    cache = init_cache(cfg, B, max_len, memory_len=mem_len, device=x.device)
    positions = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
    x, cache = _run_stack(cfg, params, x, positions, cache, "prefill",
                          memory=memory, memory_pos=memory_pos)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return x[:, -1] @ _head(cfg, params), cache


def decode_step(cfg: ModelConfig, params, cache, tokens_last: torch.Tensor,
                pos):
    """One decode step.  tokens_last: (B, 1); pos: the position (an int).

    Returns (logits (B, V), cache), the cache updated in place."""
    pos = int(pos)
    dt = _dtype(cfg)
    x = _embed(cfg, params, tokens_last)
    if cfg.frontend == "audio_stub" and not cfg.encoder_layers:
        x = x + _sinusoidal(1, cfg.d_model, dt, x.device)
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    x, cache = _run_stack(cfg, params, x, positions, cache, "decode",
                          pos=pos)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return x[:, 0] @ _head(cfg, params), cache
