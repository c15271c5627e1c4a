"""A data row's view of a sharded parameter tree
(``repro_torch.models.tensor_parallel``) against the whole computation and
the JAX package's, on the CPU.

The dense, moe and hybrid families' SMOKE configs are laid out by
``param_shardings`` on meshes naming the CPU; a row's view then runs each
split sublayer on its ``model`` positions' slices:

* attention with the q and kv heads split (qwen3 on (2, 2)), with each
  position's query heads sharing one kv head fetched whole (qwen3 and
  glm4 on (2, 4)), and replicated where the heads do not split
  (starcoder2's 6 heads over 4 positions);
* the gated (glm4) and the plain (starcoder2) MLP;
* the MoE, each expert's ``d_ff`` split: the experts over the data axes
  (EP: mixtral and phi3.5 on (2, 4)) and ``d`` over them (FSDP: mixtral's
  4 experts on an (8, 2) mesh's 8 data rows); the sorted dispatch at
  capacity factor 1.0 over a microbatch of two data rows (``micro_view``)
  on both branches, also over two 2048-position chunks, its output and
  gradients against the whole sorted dispatch over the microbatch and
  JAX's;
* jamba's Mamba mixer, ``d_inner`` 128 over 4 positions, and whole where
  3 do not divide it;
* the vocabulary: the lookup (bitwise the whole one: one slice owns each
  row) and the loss, tied (qwen3) and untied (glm4), with masked labels
  and a row whose labels are all masked.

Each against the whole sublayer on one device and JAX's, the same inputs
from numpy seeds, within 2e-6 of the largest |value| (float32; the two
sums' orders differ).  Then a row's loss and every gradient (the pieces
added at their boxes) against JAX's ``loss_fn`` and ``jax.grad`` within
1e-5 (``tests/test_torch_train_loss.py``'s bar, 1e-4 for jamba's gradients
as there), the dense archs, mixtral, phi3.5 and jamba; the model axis's
sum in f32, cast once, in position order; and a period under
``checkpoint`` (qwen3, mixtral, jamba): every leaf of the period fetched
once in the forward and once more in the backward pass, no fetched leaf
saved for the backward.
"""
import collections
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jatt
from repro.models import layers as jlay
from repro.models import lm as jlm
from repro_torch.configs import registry as treg
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import lm as tlm
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.layers import mlp_apply, moe_apply, moe_apply_sorted
from repro_torch.models.sharding import MoveStats, param_shardings, shard
from repro_torch.training.tree import key_paths, leaves, unflatten

F32 = 2e-6
LOSS_TOL = GRAD_TOL = 1e-5
# tests/test_torch_train_loss.py's gradient bar for the Mamba family: its
# recurrence's gradients sit at up to 5.2e-6 of JAX's on one device and at
# 1.06e-5 with d_inner split (jamba-smoke, key 4)
MAMBA_GRAD_TOL = 1e-4
B, S = 2, 16


def rel_err(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).detach().double())
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def setup(arch, mesh_shape, seed=0):
    """JAX's SMOKE parameters (key ``seed``), the port's copy, and the
    port's laid out on a mesh naming the CPU."""
    jcfg, cfg = jreg.SMOKES[arch], treg.SMOKES[arch]
    jp = jlm.init_params(jcfg, jax.random.key(seed))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                  device="cpu")
    mesh = make_debug_mesh(*mesh_shape, ["cpu"] * math.prod(mesh_shape))
    sh = leaves(param_shardings(mesh, params))
    placed = unflatten(params, [shard(t, s) for t, s in
                                zip(leaves(params), sh)])
    return jcfg, cfg, jp, params, placed


def view(cfg, placed):
    stats = {"gather": MoveStats(), "model": MoveStats(),
             "routes": MoveStats()}
    tree, row = tp.row_view(cfg, placed, (0,) * 2, stats)
    return tree, row, stats


def period(cfg, tree, layer="l0"):
    return tp.materialize(cfg, tlm._index(tree["blocks"], 0))[layer]


def hidden(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def at0(tree):
    """Period 0 of a stacked parameter subtree."""
    return {k: v[0] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the sublayers
# ---------------------------------------------------------------------------

ATTN_CASES = [("qwen3-0.6b", (2, 2), "kv"), ("qwen3-0.6b", (2, 4), "pick"),
              ("glm4-9b", (2, 4), "pick"), ("starcoder2-7b", (2, 4), None)]


@pytest.mark.parametrize("arch,mesh_shape,mode", ATTN_CASES)
def test_split_attention_matches_whole_and_jax(arch, mesh_shape, mode):
    jcfg, cfg, jp, params, placed = setup(arch, mesh_shape)
    tree, row, stats = view(cfg, placed)
    sub = period(cfg, tree)["attn"]
    assert (sub.mode if tp.is_split(sub) else None) == mode
    h = hidden(cfg)
    th = torch.as_tensor(h)
    pos = torch.arange(S)
    spec = tlm.attn_spec(cfg)
    if mode:
        y, _ = tp.attn_train(sub, th, pos, spec)
        assert stats["model"].positions > 0
    else:   # the sublayer runs whole on the row's first position
        y, _ = tlm.attn_train(sub, th, pos, spec)
        assert stats["model"] == MoveStats()
    whole, _ = tlm.attn_train(at0(params["blocks"]["l0"]["attn"]), th, pos,
                              spec)
    want, _ = jax.jit(jatt.attn_train, static_argnums=3)(
        at0(jp["blocks"]["l0"]["attn"]), jnp.asarray(h),
        jnp.arange(S, dtype=jnp.int32), jlm.attn_spec(jcfg))
    assert rel_err(y, whole.numpy()) <= F32
    assert rel_err(y, np.asarray(want)) <= F32


@pytest.mark.parametrize("arch", ["glm4-9b", "starcoder2-7b"])
def test_split_mlp_matches_whole_and_jax(arch):
    jcfg, cfg, jp, params, placed = setup(arch, (2, 4))
    tree, row, stats = view(cfg, placed)
    sub = period(cfg, tree)["ffn"]
    assert tp.is_split(sub)
    assert ("w_gate" in sub.p) == cfg.act_gated
    h = hidden(cfg)
    y = tp.mlp_apply(sub, torch.as_tensor(h), cfg.act)
    whole = mlp_apply(at0(params["blocks"]["l0"]["ffn"]), torch.as_tensor(h),
                      cfg.act)
    want = jlay.mlp_apply(at0(jp["blocks"]["l0"]["ffn"]), jnp.asarray(h),
                          jcfg.act)
    assert rel_err(y, whole.numpy()) <= F32
    assert rel_err(y, np.asarray(want)) <= F32
    # the input out to 3 positions and the partials back
    act = B * S * cfg.d_model * 4
    assert stats["model"] == MoveStats(2 * 3 * act, 0)


# (arch, mesh, branch): the experts over the data axes where they divide
# them (EP), else FSDP on d (mixtral-smoke's 4 experts over 8 data rows)
MOE_CASES = [("mixtral-8x22b", (2, 4), "ep"),
             ("phi3.5-moe-42b-a6.6b", (2, 4), "ep"),
             ("mixtral-8x22b", (8, 2), "fsdp")]


def layer_of(cfg, kind=None, moe=None):
    """The name of the first layer of the period of that kind and MoE."""
    return next(f"l{i}" for i, s in enumerate(cfg.period())
                if (kind is None or s.kind.value == kind)
                and (moe is None or s.moe == moe))


@pytest.mark.parametrize("arch,mesh_shape,branch", MOE_CASES)
def test_split_moe_matches_whole_and_jax(arch, mesh_shape, branch):
    """Each expert's d_ff over model: the routing once on the row's first
    position, each position's experts on its slice, the partials summed
    once; x and combine out, the f32 partials back."""
    jcfg, cfg, jp, params, placed = setup(arch, mesh_shape)
    tree, row, stats = view(cfg, placed)
    name = layer_of(cfg, moe=True)
    sub = period(cfg, tree, name)["ffn"]
    assert tp.is_split(sub)
    spec = sub.p["w_up"].s.sharding.spec
    assert spec[1 if branch == "ep" else 2] == "data" and spec[3] == "model"
    h = hidden(cfg)
    kw = dict(top_k=cfg.experts_per_token, act=cfg.act)
    y = tp.moe_apply(sub, torch.as_tensor(h), **kw)
    whole = moe_apply(at0(params["blocks"][name]["ffn"]), torch.as_tensor(h),
                      **kw)
    want = jlay.moe_apply(at0(jp["blocks"][name]["ffn"]), jnp.asarray(h), **kw)
    assert rel_err(y, whole.numpy()) <= F32
    assert rel_err(y, np.asarray(want)) <= F32
    M, T = mesh_shape[1], B * S
    act, comb = T * cfg.d_model * 4, T * cfg.n_experts * 4
    assert stats["model"] == MoveStats((M - 1) * (2 * act + comb), 0)


# (arch, mesh, branch, sequence): the sorted dispatch at capacity factor
# 1.0 over a microbatch of 2 batch rows, one on each of two data rows; at
# 4096 positions its two 2048-position chunks
SORTED_CASES = [("phi3.5-moe-42b-a6.6b", (2, 4), "ep", S),
                ("mixtral-8x22b", (8, 2), "fsdp", S),
                ("phi3.5-moe-42b-a6.6b", (2, 4), "ep", 4096)]


@pytest.mark.parametrize("arch,mesh_shape,branch,seq", SORTED_CASES)
def test_split_sorted_moe_matches_whole_and_jax(arch, mesh_shape, branch,
                                                seq):
    """The sorted dispatch split over two data rows (each expert's
    ``d_ff`` over ``model``; the experts over ``data``, EP, or ``d``,
    FSDP): its output and the gradients of its input and every parameter
    (a random cotangent) against the whole ``moe_apply_sorted`` over the
    microbatch and JAX's, within 2e-6 of the largest |value|; the
    microbatch's capacity drops assignments; each chunk hands the second
    row the first row's expert counts; the input out, the slots out and
    the partials back (and their gradients) along ``model``."""
    jcfg, cfg, jp, params, placed = setup(arch, mesh_shape)
    cfg = dataclasses.replace(cfg, moe_dispatch="sorted",
                              moe_capacity_factor=1.0)
    jcfg = dataclasses.replace(jcfg, moe_dispatch="sorted",
                               moe_capacity_factor=1.0)
    assert tp.couples(cfg) and tp.splits(cfg, mesh_shape[1])
    stats = {"gather": MoveStats(), "model": MoveStats(),
             "routes": MoveStats()}
    trees, micro = tp.micro_view(cfg, placed, [(0, 0), (1, 0)], stats)
    name = layer_of(cfg, moe=True)
    subs = [period(cfg, t, name)["ffn"] for t in trees]
    # the sorted dispatch splits: no longer whole on the row's first
    # position
    assert all(tp.is_split(sp) and sp.mode == "part" for sp in subs)
    spec = subs[0].p["w_up"].s.sharding.spec
    assert spec[1 if branch == "ep" else 2] == "data" and spec[3] == "model"
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    g = rng.standard_normal(h.shape).astype(np.float32)
    kw = dict(top_k=cfg.experts_per_token, act=cfg.act,
              capacity_factor=1.0)
    xs = [torch.as_tensor(h[r:r + 1]).requires_grad_() for r in range(2)]
    ys = tp.moe_apply_sorted(subs, xs, **kw)
    pieces = [p for row in micro.rows for p in row.pieces()]
    # (the period's norms, fetched whole, feed nothing here)
    got = torch.autograd.grad((torch.cat(ys) * torch.as_tensor(g)).sum(),
                              xs + [p[3] for p in pieces],
                              allow_unused=True, materialize_grads=True)
    grads = [torch.zeros_like(t) for t in leaves(params)]
    for (k, idx, _, _), gk in zip(pieces, got[2:]):
        grads[k][idx] += gk
    # the whole sublayer over the microbatch, and JAX's
    pw = {k: v.clone().requires_grad_()
          for k, v in at0(params["blocks"][name]["ffn"]).items()}
    xw = torch.as_tensor(h).requires_grad_()
    yw = moe_apply_sorted(pw, xw, **kw)
    gw = torch.autograd.grad((yw * torch.as_tensor(g)).sum(),
                             [xw] + list(pw.values()))
    want, vjp = jax.vjp(functools.partial(jlay.moe_apply_sorted, **kw),
                        at0(jp["blocks"][name]["ffn"]), jnp.asarray(h))
    jgp, jgx = vjp(jnp.asarray(g))
    y = torch.cat(ys)
    assert rel_err(y, yw.detach().numpy()) <= F32
    assert rel_err(y, np.asarray(want)) <= F32
    gx = torch.cat(got[:2])
    assert rel_err(gx, gw[0].numpy()) <= F32
    assert rel_err(gx, np.asarray(jgx)) <= F32
    paths = [k for k, _ in key_paths(params)]
    for leaf, w in zip(pw, gw[1:]):
        k = paths.index(f"['blocks'][{name!r}]['ffn'][{leaf!r}]")
        assert rel_err(grads[k][0], w.numpy()) <= F32, leaf
        assert rel_err(grads[k][0], np.asarray(jgp[leaf])) <= F32, leaf
    # the microbatch's capacity drops; its decisions made once
    chunks = 2 if seq == 4096 else 1
    assert len(micro.routes) == chunks
    assert sum(int((~keep).sum()) for routes in micro.routes.values()
               for _, keep, _ in routes) > 0
    E, M, k = cfg.n_experts, mesh_shape[1], cfg.experts_per_token
    assert stats["routes"] == MoveStats(chunks * E * 8, 0)
    # each row: its input out and its gradient back, the slots out, the
    # partials back and their gradients out, at each other position
    act, n = seq * cfg.d_model * 4, seq * k
    assert stats["model"] == MoveStats(
        2 * (M - 1) * (2 * act + n * 8 + 2 * n * cfg.d_model * 4), 0)


@pytest.mark.parametrize("mesh_shape,splits", [((2, 4), True),
                                               ((2, 3), False)])
def test_split_mamba_matches_whole_and_jax(mesh_shape, splits):
    """jamba-smoke's mixer: d_inner 128 over 4 positions, each fetching
    its xin and z columns of in_proj; over 3, which do not divide it, the
    mixer runs whole on the row's first position."""
    from repro.models import ssm as jssm
    from repro_torch.models.ssm import mamba_apply

    jcfg, cfg, jp, params, placed = setup("jamba-v0.1-52b", mesh_shape)
    tree, row, stats = view(cfg, placed)
    name = layer_of(cfg, kind="mamba")
    sub = period(cfg, tree, name)["mix"]
    assert tp.is_split(sub) == splits
    h = hidden(cfg)
    th = torch.as_tensor(h)
    if splits:
        y, st = tp.mamba_apply(sub, th)
        assert st is None
        M, T = mesh_shape[1], B * S
        act = T * cfg.d_model * 4
        proj = T * (math.ceil(cfg.d_model / 16) + 2 * cfg.ssm_d_state) * 4
        assert stats["model"] == MoveStats((M - 1) * 2 * (act + proj), 0)
    else:
        y, _ = mamba_apply(sub, th)
        assert stats["model"] == MoveStats()
    whole, _ = mamba_apply(at0(params["blocks"][name]["mix"]), th)
    want, _ = jssm.mamba_apply(at0(jp["blocks"][name]["mix"]),
                               jnp.asarray(h))
    assert rel_err(y, whole.detach().numpy()) <= F32
    assert rel_err(y, np.asarray(want)) <= F32


def labels_of(cfg, seed=2, masked_row=False):
    """Labels, a quarter masked (and, with ``masked_row``, all of the
    second row)."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab[rng.random((B, S)) < 0.25] = tlm.MASK_LABEL
    if masked_row:
        lab[1] = tlm.MASK_LABEL
    return lab


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "glm4-9b"])
def test_vocab_lookup_and_head_loss(arch):
    """Tied (qwen3) and untied (glm4): the lookup bitwise the whole one;
    the loss and its gradients (x, the head's slices) within 2e-6 of the
    whole head's, with masked labels, and a second batch whose second row
    is all masked."""
    _, cfg, _, params, placed = setup(arch, (2, 4))
    head = "embed" if cfg.tie_embeddings else "lm_head"
    rng = np.random.default_rng(5)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)))
    tree, _, _ = view(cfg, placed)
    assert tp.splits_vocab(tree["embed"]) and tp.splits_vocab(tree[head])
    assert torch.equal(tlm._embed(cfg, tree, tokens),
                       params["embed"][tokens])
    for seed, masked_row in ((2, False), (3, True)):
        tree, row, _ = view(cfg, placed)
        labels = torch.as_tensor(labels_of(cfg, seed, masked_row))
        assert (labels == tlm.MASK_LABEL).any()
        x = torch.as_tensor(hidden(cfg, seed)).requires_grad_()
        loss = tlm.head_loss(cfg, tree, x, labels)
        pieces = row.pieces()
        got = torch.autograd.grad(loss, [x] + [p[3] for p in pieces])
        w = params[head].clone().requires_grad_()
        want = tlm.head_loss(cfg, {**params, head: w}, x, labels)
        gx, gw = torch.autograd.grad(want, [x, w])
        assert abs(float(loss.detach()) - float(want.detach())) <= F32 * abs(
            float(want.detach()))
        assert rel_err(got[0], gx.numpy()) <= F32
        k_head = [k for k, _ in key_paths(params)].index(f"[{head!r}]")
        assembled = torch.zeros_like(w)
        for (k, idx, _, _), g in zip(pieces, got[1:]):
            assert k == k_head
            assembled[idx] += g
        assert rel_err(assembled, gw.numpy()) <= F32


# ---------------------------------------------------------------------------
# a row's loss and gradients
# ---------------------------------------------------------------------------

ROW_CASES = [("glm4-9b", (2, 4)), ("qwen3-0.6b", (2, 4)),
             ("qwen3-0.6b", (2, 2)), ("starcoder2-7b", (2, 4)),
             ("granite-3-8b", (2, 4)), ("mixtral-8x22b", (2, 4)),
             ("phi3.5-moe-42b-a6.6b", (2, 4)), ("jamba-v0.1-52b", (2, 4))]


@pytest.mark.parametrize("arch,mesh_shape", ROW_CASES)
def test_row_loss_and_gradients_match_jax(arch, mesh_shape):
    jcfg, cfg, jp, params, placed = setup(arch, mesh_shape, seed=4)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = labels_of(cfg)
    tree, row, stats = view(cfg, placed)
    with torch.enable_grad():
        loss = tlm.row_losses(cfg, [tree], [
            {"tokens": torch.as_tensor(tokens),
             "labels": torch.as_tensor(labels)}])[0]
        pieces = row.pieces()
        got = torch.autograd.grad(loss, [p[3] for p in pieces])
    grads = [torch.zeros_like(t) for t in leaves(params)]
    for (k, idx, _, _), g in zip(pieces, got):
        grads[k][idx] += g
    assert stats["gather"].positions > 0 and stats["model"].positions > 0
    jloss, jgrads = jax.jit(jax.value_and_grad(
        functools.partial(jlm.loss_fn, jcfg)))(
        jp, jnp.asarray(tokens), jnp.asarray(labels))
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_TOL * abs(
        float(jloss))
    for (name, w), g in zip(key_paths(jax.tree.map(np.asarray, jgrads)),
                            grads):
        assert g.shape == w.shape, name
        assert rel_err(g, w) <= (MAMBA_GRAD_TOL if cfg.ssm_kind == "mamba"
                                 else GRAD_TOL), name


# ---------------------------------------------------------------------------
# the model axis's sum and the period's fetches
# ---------------------------------------------------------------------------

def test_model_sum_is_f32_in_position_order_cast_once():
    """bfloat16 partials: their f32 sum in position order, cast once; the
    backward sends the output's gradient to every position, and sums the
    input's gradients from them the same way."""
    _, cfg, _, _, placed = setup("qwen3-0.6b", (2, 4))
    _, row, stats = view(cfg, placed)
    rng = np.random.default_rng(7)
    parts = [torch.as_tensor(rng.standard_normal((3, 5)).astype(np.float32)
                             ).bfloat16().requires_grad_() for _ in range(4)]
    y = row.reduce(parts)
    want = parts[0].float()
    for p in parts[1:]:
        want = want + p.float()
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, want.bfloat16())
    g = torch.as_tensor(rng.standard_normal((3, 5)).astype(np.float32)
                        ).bfloat16()
    assert all(torch.equal(gi, g)
               for gi in torch.autograd.grad(y, parts, g))
    t = torch.zeros((3, 5), dtype=torch.bfloat16, requires_grad=True)
    outs = row.broadcast(t)
    gs = [torch.as_tensor(rng.standard_normal((3, 5)).astype(np.float32)
                          ).bfloat16() for _ in outs]
    (gt,) = torch.autograd.grad(outs, [t], gs)
    total = gs[0].float()
    for x in gs[1:]:
        total = total + x.float()
    assert torch.equal(gt, total.bfloat16())
    # 3 partials in, 3 gradients out, 3 copies out, 3 gradients in
    assert stats["model"] == MoveStats(12 * 15 * 2, 0)


@pytest.mark.parametrize("arch,sorted_rows", [
    pytest.param("qwen3-0.6b", False, id="qwen3-0.6b"),
    pytest.param("mixtral-8x22b", False, id="mixtral-8x22b"),
    pytest.param("jamba-v0.1-52b", False, id="jamba-v0.1-52b"),
    pytest.param("phi3.5-moe-42b-a6.6b", True,
                 id="phi3.5-moe-42b-a6.6b-sorted")])
def test_period_gathers_twice_and_saves_no_gathered_leaf(monkeypatch, arch,
                                                         sorted_rows):
    """qwen3, mixtral (the experts' slices), jamba (the mixer's, its
    in_proj columns) and phi3.5's sorted dispatch over a microbatch of
    two data rows (its periods run both rows under one checkpoint) on
    (2, 4), through ``row_losses`` as the mesh step runs them, remat on:
    each (block leaf, period, position) is fetched once by the forward
    and once more by the backward pass, and no tensor saved for the
    backward outside the periods shares storage with a tensor a period
    fetched."""
    _, cfg, _, _, placed = setup(arch, (2, 4))
    firsts = [(0, 0)]
    if sorted_rows:
        cfg = dataclasses.replace(cfg, moe_dispatch="sorted",
                                  moe_capacity_factor=1.0)
        firsts = [(0, 0), (1, 0)]
    stats = {"gather": MoveStats(), "model": MoveStats(),
             "routes": MoveStats()}
    trees, micro = tp.micro_view(cfg, placed, firsts, stats)
    fetched, count = [], collections.Counter()
    real = tp.Row.fetch

    def spy(self, leaf, q, part, span=None):
        out = real(self, leaf, q, part, span)
        if leaf.period is not None:
            count[(leaf.k, leaf.period, q, span)] += 1
            fetched.append(out)   # alive: no later tensor takes its memory
        return out

    monkeypatch.setattr(tp.Row, "fetch", spy)
    packed = []

    def pack(t):
        packed.append(t.untyped_storage().data_ptr())
        return t

    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                       (B, S))),
                "labels": torch.as_tensor(labels_of(cfg, seed=2 + r))}
               for r in range(len(firsts))]
    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
            pack, lambda t: t):
        loss = sum(tlm.row_losses(cfg, trees, batches))
    assert count and set(count.values()) == {1}
    assert not set(packed) & {t.untyped_storage().data_ptr()
                              for t in fetched}
    if sorted_rows:
        assert stats["routes"].positions > 0
    torch.autograd.grad(loss, [p[3] for row in micro.rows
                               for p in row.pieces()])
    assert set(count.values()) == {2}
    # every block leaf of every period, on every position that uses it
    per_period = collections.Counter(p for _, p, _, _ in count)
    assert sorted(per_period) == list(range(cfg.n_periods))


def test_other_families_compute_whole_products():
    """rwkv6's time mix and channel mix on a (2, 3) row, whose 3
    positions divide none of its heads, widths or vocabulary: every leaf
    whole on the row's first position; no model-axis copy.  (On (2, 4)
    they split: tests/test_torch_lm_tensor_parallel_families.py.)"""
    _, cfg, _, _, placed = setup("rwkv6-1.6b", (2, 3))
    tree, row, stats = view(cfg, placed)
    assert row.split and tp.splits(cfg, 4)
    lay = period(cfg, tree)
    assert all(not tp.is_split(v) for v in lay.values())
    assert all(isinstance(t, torch.Tensor)
               for t in leaves(lay))
    assert stats["model"] == MoveStats()
    assert {q for _, _, q, _ in row.pieces()} == {0}
