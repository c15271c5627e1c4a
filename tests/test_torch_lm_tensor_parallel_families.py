"""The ssm, vlm and audio families' split products
(``repro_torch.models.tensor_parallel``) against the whole computation
and the JAX package's, on the CPU.

The SMOKE configs of rwkv6-1.6b, paligemma-3b and whisper-medium are laid
out by ``param_shardings`` on (2, 4) meshes naming the CPU; a row's view
then runs each split sublayer on its ``model`` positions' slices:

* RWKV's time mix, its 4 heads one a position (each position's WKV scan,
  group norm and gate on its own heads, ``wo``'s rows giving partials);
* RWKV's channel mix, ``d_ff`` 128 over 4 positions, ``wv``'s matching
  rows fetched as a span across the ``model`` blocks (``model`` lies on
  ``wv``'s ``d``), ``rr``'s column slices collected;
* whisper's cross-attention, one head a position, ``k``/``v`` from the
  encoder memory sent to each position;
* whisper's encoder, each layer's attention (not causal) and gelu MLP
  split, fetched once a step (no recomputation);
* paligemma's MQA attention (each position's 2 query heads sharing the
  one kv head, fetched whole) over its 8 patch rows and the text.

Each against the whole sublayer on one device and JAX's, the same inputs
from numpy seeds, within 2e-6 of the largest |value| (float32).  Then a
row's loss and every gradient against JAX's ``loss_fn`` and ``jax.grad``
within 1e-5, the frontend (patches, frames) as a batch input; a decode
state refused by the split forms; and the moves each books.  One CPU
thread (the suite runs several workers on few cores).
"""
import collections
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jatt
from repro.models import lm as jlm
from repro.models import rwkv as jrwkv
from repro_torch.configs import registry as treg
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import lm as tlm
from repro_torch.models import rwkv as trwkv
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.attention import attn_train, cross_attn
from repro_torch.models.sharding import MoveStats, param_shardings, shard
from repro_torch.training.tree import key_paths, leaves, unflatten

F32 = 2e-6
LOSS_TOL = GRAD_TOL = 1e-5
B, S = 2, 16
RWKV, PALI, WHISPER = "rwkv6-1.6b", "paligemma-3b", "whisper-medium"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).detach().double())
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def setup(arch, mesh_shape=(2, 4), seed=0):
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
    tree, row = tp.row_view(cfg, placed, (0, 0), stats)
    return tree, row, stats


def period(cfg, tree, layer="l0"):
    return tp.materialize(cfg, tlm._index(tree["blocks"], 0))[layer]


def at0(tree):
    """Period 0 of a stacked parameter subtree."""
    return {k: v[0] for k, v in tree.items()}


def inputs(cfg, n=S, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# the sublayers
# ---------------------------------------------------------------------------

def test_split_rwkv_time_mix_matches_whole_and_jax():
    """rwkv6-smoke's 4 heads over 4 positions: the input out to 3
    positions and the partial outputs back, nothing else."""
    _, cfg, jp, params, placed = setup(RWKV)
    tree, row, stats = view(cfg, placed)
    sub = period(cfg, tree)["mix"]
    assert tp.is_split(sub)
    x = inputs(cfg)
    y, st = tp.rwkv_apply(sub, torch.as_tensor(x))
    assert st is None
    whole, _ = trwkv.rwkv_apply(at0(params["blocks"]["l0"]["mix"]),
                                torch.as_tensor(x))
    want, _ = jax.jit(jrwkv.rwkv_apply)(at0(jp["blocks"]["l0"]["mix"]),
                                        jnp.asarray(x))
    assert rel_err(y, whole.detach().numpy()) <= F32
    assert rel_err(y, np.asarray(want)) <= F32
    act = B * S * cfg.d_model * 4
    assert stats["model"] == MoveStats(3 * 2 * act, 0)
    # wr/wk/wv/wg/wB/wo: each position's slice, the other data block
    assert stats["gather"].positions > 0


def test_split_rwkv_channel_mix_matches_whole_and_jax():
    """d_ff 128 over 4 positions: each fetches the 32 rows of ``wv`` its
    ``kk`` columns pair with (``wv`` is ``(data, model)``: ``model`` on
    ``d``; the span takes those rows from the 4 positions of the data
    block holding them); the input out, the partial ``vv`` back and each
    position's quarter of ``rr`` back."""
    _, cfg, jp, params, placed = setup(RWKV)
    tree, row, stats = view(cfg, placed)
    sub = period(cfg, tree)["ffn"]
    assert tp.is_split(sub)
    assert sub.p["wv"].s.sharding.spec[1:] == ("data", "model")
    x = inputs(cfg)
    y, st = tp.rwkv_ffn_apply(sub, torch.as_tensor(x))
    assert st is None
    whole, _ = trwkv.rwkv_ffn_apply(at0(params["blocks"]["l0"]["ffn"]),
                                    torch.as_tensor(x))
    want, _ = jax.jit(jrwkv.rwkv_ffn_apply)(at0(jp["blocks"]["l0"]["ffn"]),
                                            jnp.asarray(x))
    assert rel_err(y, whole.detach().numpy()) <= F32
    assert rel_err(y, np.asarray(want)) <= F32
    act = B * S * cfg.d_model * 4
    assert stats["model"] == MoveStats(3 * (2 * act + act // 4), 0)
    # each position's 32 wv rows, from the 4 column blocks of the data
    # block holding them: positions 0 and 1 hold one of those blocks (row
    # 0's data block), 2 and 3 none (their rows lie in data block 1) ...
    ff, d = cfg.d_ff, cfg.d_model
    wv_rows = (3 + 3 + 4 + 4) * (ff // 4) * (d // 4) * 4
    # ... and the other data block of its wk and wr slices
    wk = 4 * (d // 2) * (ff // 4) * 4
    wr = 4 * (d // 2) * (d // 4) * 4
    assert stats["gather"] == MoveStats(wv_rows + wk + wr, 0)


def test_split_rwkv_refuses_a_decode_state():
    _, cfg, _, _, placed = setup(RWKV)
    tree, _, _ = view(cfg, placed)
    lay = period(cfg, tree)
    x = torch.zeros((B, 1, cfg.d_model))
    with pytest.raises(ValueError, match="train mode only"):
        tp.rwkv_apply(lay["mix"], x, {"S": None, "last": None})
    with pytest.raises(ValueError, match="train mode only"):
        tp.rwkv_ffn_apply(lay["ffn"], x, {"last": None})


def test_split_cross_attention_matches_whole_and_jax():
    """whisper-smoke's 4 heads (4 kv heads) over 4 positions: ``x`` and
    the memory out, the query and memory positions, the partials back."""
    jcfg, cfg, jp, params, placed = setup(WHISPER)
    tree, row, stats = view(cfg, placed)
    sub = period(cfg, tree)["cross"]
    assert tp.is_split(sub) and sub.mode == "kv"
    F = cfg.frontend_len
    x, mem = inputs(cfg), inputs(cfg, F, seed=3)
    pos, mpos = torch.arange(S), torch.arange(F)
    spec = tlm.attn_spec(cfg, cross=True)
    y, _ = tp.cross_attn(sub, torch.as_tensor(x), pos, spec,
                         torch.as_tensor(mem), mpos)
    whole, _ = cross_attn(at0(params["blocks"]["l0"]["cross"]),
                          torch.as_tensor(x), pos, spec, torch.as_tensor(mem),
                          mpos)
    want, _ = jax.jit(jlm._cross_attn, static_argnums=3)(
        at0(jp["blocks"]["l0"]["cross"]), jnp.asarray(x),
        jnp.arange(S, dtype=jnp.int32), jlm.attn_spec(jcfg, cross=True),
        jnp.asarray(mem), jnp.arange(F, dtype=jnp.int32))
    assert rel_err(y, whole.numpy()) <= F32
    assert rel_err(y, np.asarray(want)) <= F32
    act, m = B * S * cfg.d_model * 4, B * F * cfg.d_model * 4
    assert stats["model"] == MoveStats(3 * (2 * act + m + (S + F) * 8), 0)


def test_split_encoder_matches_whole_and_jax():
    """whisper-smoke's 2 encoder layers, each layer's attention and MLP
    split over 4 positions: the encoder's output against the whole
    encoder and JAX's; each split sublayer's input out and partial back,
    the frames' positions once a layer."""
    jcfg, cfg, jp, params, placed = setup(WHISPER)
    tree, row, stats = view(cfg, placed)
    F = cfg.frontend_len
    lay = tp.materialize_encoder(cfg, tlm._index(tree["encoder"], 0))
    assert tp.is_split(lay["attn"]) and lay["attn"].mode == "kv"
    assert tp.is_split(lay["ffn"])
    assert isinstance(lay["ln1"], torch.Tensor)
    tree, row, stats = view(cfg, placed)
    frames = inputs(cfg, F, seed=4)
    got = tlm.encode(cfg, tree, torch.as_tensor(frames))
    whole = tlm.encode(cfg, params, torch.as_tensor(frames))
    want = jax.jit(functools.partial(jlm.encode, jcfg))(jp,
                                                        jnp.asarray(frames))
    assert rel_err(got, whole.numpy()) <= F32
    assert rel_err(got, np.asarray(want)) <= F32
    # the forward pass only (no gradient taken here): each layer's two
    # sublayers' inputs out and partials back, the attention's positions
    act = B * F * cfg.d_model * 4
    assert stats["model"] == MoveStats(
        cfg.encoder_layers * 3 * (4 * act + F * 8), 0)


def test_paligemma_attention_over_its_prefix():
    """paligemma-smoke's MQA (4 query heads, 1 kv head) on (2, 4): each
    position's one query head shares the kv head, fetched whole; over
    the 8 patch rows and the text, the positions of both sent."""
    jcfg, cfg, jp, params, placed = setup(PALI)
    tree, row, stats = view(cfg, placed)
    sub = period(cfg, tree)["attn"]
    assert tp.is_split(sub) and sub.mode == "pick"
    n = cfg.frontend_len + S
    h = inputs(cfg, n)
    pos = torch.arange(n)
    spec = tlm.attn_spec(cfg)
    y, _ = tp.attn_train(sub, torch.as_tensor(h), pos, spec)
    whole, _ = attn_train(at0(params["blocks"]["l0"]["attn"]),
                          torch.as_tensor(h), pos, spec)
    want, _ = jax.jit(jatt.attn_train, static_argnums=3)(
        at0(jp["blocks"]["l0"]["attn"]), jnp.asarray(h),
        jnp.arange(n, dtype=jnp.int32), jlm.attn_spec(jcfg))
    assert rel_err(y, whole.numpy()) <= F32
    assert rel_err(y, np.asarray(want)) <= F32
    act = B * n * cfg.d_model * 4
    assert stats["model"] == MoveStats(3 * (2 * act + n * 8), 0)


# ---------------------------------------------------------------------------
# a row's loss and gradients
# ---------------------------------------------------------------------------

def labels_of(cfg, seed=2):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab[rng.random((B, S)) < 0.25] = tlm.MASK_LABEL
    return lab


@pytest.mark.parametrize("arch", [RWKV, PALI, WHISPER])
def test_row_loss_and_gradients_match_jax(arch):
    jcfg, cfg, jp, params, placed = setup(arch, seed=4)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = labels_of(cfg)
    frontend = (rng.standard_normal((B, cfg.frontend_len, cfg.d_model))
                * 0.02).astype(np.float32) if cfg.frontend else None
    tree, row, stats = view(cfg, placed)
    with torch.enable_grad():
        batch = {"tokens": torch.as_tensor(tokens),
                 "labels": torch.as_tensor(labels)}
        if frontend is not None:
            batch["frontend"] = torch.as_tensor(frontend)
        loss = tlm.row_losses(cfg, [tree], [batch])[0]
        pieces = row.pieces()
        got = torch.autograd.grad(loss, [p[3] for p in pieces])
    grads = [torch.zeros_like(t) for t in leaves(params)]
    for (k, idx, _, _), g in zip(pieces, got):
        grads[k][idx] += g
    assert stats["gather"].positions > 0 and stats["model"].positions > 0
    jloss, jgrads = jax.jit(jax.value_and_grad(
        functools.partial(jlm.loss_fn, jcfg)))(
        jp, jnp.asarray(tokens), jnp.asarray(labels),
        None if frontend is None else jnp.asarray(frontend))
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_TOL * abs(
        float(jloss))
    for (name, w), g in zip(key_paths(jax.tree.map(np.asarray, jgrads)),
                            grads):
        assert g.shape == w.shape, name
        assert rel_err(g, w) <= GRAD_TOL, name


def test_encoder_fetched_once_and_periods_twice(monkeypatch):
    """whisper on (2, 4): each (encoder leaf, layer, position, box) is
    fetched once by the forward pass and not again by the backward pass
    (the encoder runs outside the periods' checkpoints); each block leaf
    once by the forward and once more by the backward."""
    _, cfg, _, _, placed = setup(WHISPER)
    tree, row, _ = view(cfg, placed)
    enc = {id(t.s) for t in leaves(tree["encoder"])}
    count = collections.Counter()
    real = tp.Row.fetch

    def spy(self, leaf, q, part, span=None):
        if leaf.period is not None:
            count[(id(leaf.s) in enc, leaf.k, leaf.period, q, span)] += 1
        return real(self, leaf, q, part, span)

    monkeypatch.setattr(tp.Row, "fetch", spy)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)))
    frames = torch.as_tensor(inputs(cfg, cfg.frontend_len, seed=4))
    with torch.enable_grad():
        loss = tlm.row_losses(cfg, [tree], [{
            "tokens": tokens, "labels": torch.as_tensor(labels_of(cfg)),
            "frontend": frames}])[0]
        torch.autograd.grad(loss, [p[3] for p in row.pieces()])
    by_kind = collections.defaultdict(set)
    for key, n in count.items():
        by_kind[key[0]].add(n)
    assert by_kind == {True: {1}, False: {2}}
    layers = {key[2] for key in count if key[0]}
    assert layers == set(range(cfg.encoder_layers))
