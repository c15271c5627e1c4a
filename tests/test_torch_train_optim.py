"""The port's AdamW, int8 gradient compression, data stream and leaf
order against the JAX package, on identical inputs, on the CPU.

AdamW: three updates from identical numpy gradients, the parameters,
both moments, ``step`` and the global norm within 4 f32 ulps (5e-7) of
the leaf's largest magnitude (XLA may contract a multiply-add or evaluate
``pow`` differently, and ``p - lr * delta`` cancels where the two are
close; the two updates are the same f32 formula),
with the clip active and inactive and a bfloat16 leaf (cast back after
the f32 math: within one bf16 rounding).  Compression and the data
stream: exact.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.training import data as jdata
from repro.training import grad_compress as jgc
from repro.training import optimizer as jopt
from repro_torch.interop import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.training import data as tdata
from repro_torch.training import grad_compress as tgc
from repro_torch.training import optimizer as topt
from repro_torch.training.tree import key_paths, leaves, tree_map, unflatten

F32_RTOL = 5e-7


def tree_np(rng, bf16=False):
    """A parameter-like tree: nested dicts whose insertion order is not
    sorted, an f32 'router', and optionally a bfloat16 leaf."""
    t = {"z": {"w": rng.standard_normal((6, 5)).astype(np.float32),
               "b": rng.standard_normal((5,)).astype(np.float32)},
         "a": rng.standard_normal((7,)).astype(np.float32),
         "router": rng.standard_normal((3, 4)).astype(np.float32)}
    if bf16:
        t["emb"] = rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16)
    return t


def close(got, want, rtol=F32_RTOL):
    """Within ``rtol`` of the leaf's largest magnitude."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def test_leaf_order_and_paths_are_jax_s():
    rng = np.random.default_rng(0)
    tree = tree_np(rng, bf16=True)
    state = jopt.AdamWState(step=np.int32(3), m=tree, v=tree)
    jflat, _ = jax.tree_util.tree_flatten_with_path(state)
    got = key_paths(topt.AdamWState(step=np.int32(3), m=tree, v=tree))
    assert [p for p, _ in got] == [jax.tree_util.keystr(p)
                                   for p, _ in jflat]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, jflat))
    # a None leaf is no leaf; unflatten keeps the template's key order
    assert key_paths({"x": None, "y": 1}) == [("['y']", 1)]
    back = unflatten(tree, [np.zeros(1)] * len(leaves(tree)))
    assert list(back) == list(tree) and list(back["z"]) == ["w", "b"]
    assert tree_map(lambda a, b: a is b, tree, tree)["z"]["w"]


@pytest.mark.parametrize("clip", [1.0, 1e3], ids=["clipped", "unclipped"])
def test_adamw_update_matches_jax(clip):
    rng = np.random.default_rng(1)
    params = tree_np(rng, bf16=True)
    jo = jopt.AdamW(lr=1e-2, grad_clip=clip)
    to = topt.AdamW(lr=1e-2, grad_clip=clip)
    jp = jax.tree.map(jnp.asarray, params)
    tp = lm_params_from_numpy(params, device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    assert ts.step.dtype == torch.int32 and ts.step.shape == ()
    for k in range(3):
        grads = jax.tree.map(
            lambda p: (rng.standard_normal(p.shape) * 3).astype(p.dtype),
            params)
        jp, js, jn = jo.update(jax.tree.map(jnp.asarray, grads), js, jp)
        tp, ts, tn = to.update(lm_params_from_numpy(grads, "cpu"), ts, tp)
        close(float(tn), float(jn))
        # the clip is active in the first case only
        assert (float(jn) > clip) == (clip == 1.0)
        assert int(ts.step) == int(js.step) == k + 1
        for (path, w), g in zip(key_paths(jax.tree.map(np.asarray, jp)),
                                leaves(lm_params_to_numpy(tp))):
            assert g.dtype == w.dtype, path
            if w.dtype == ml_dtypes.bfloat16:
                close(g.astype(np.float32), w.astype(np.float32),
                      rtol=2 ** -8)
            else:
                close(g, w)
        for jt, tt in ((js.m, ts.m), (js.v, ts.v)):
            for w, g in zip(leaves(jax.tree.map(np.asarray, jt)),
                            leaves(tt)):
                assert g.dtype == torch.float32
                close(g.numpy(), w)


def test_adamw_leaves_inputs_untouched_and_decays_every_leaf():
    opt = topt.AdamW(lr=0.1)
    p = {"n": torch.ones(3), "r": torch.full((2,), 2.0)}
    st = opt.init(p)
    zero = {"n": torch.zeros(3), "r": torch.zeros(2)}
    new, st2, gn = opt.update(zero, st, p)
    assert float(gn) == 0.0 and int(st.step) == 0 and int(st2.step) == 1
    assert torch.equal(p["n"], torch.ones(3))
    # zero gradients: only the decay moves each leaf, p (1 - lr wd)
    assert torch.allclose(new["n"], torch.full((3,), 1 - 0.1 * 0.1))
    assert torch.allclose(new["r"], torch.full((2,), 2 * (1 - 0.1 * 0.1)))


def test_adamw_minimizes_quadratic():
    """tests/test_training.py::test_adamw_minimizes_quadratic on the port."""
    opt = topt.AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.ones(4) * 5.0}
    state = opt.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt.update(grads, state, params)
    assert float(params["w"].abs().max()) < 1e-2


def test_compress_leaf_exact_including_ties():
    """q, scale and the new error equal JAX's bit for bit; values that
    land on .5 of a step round half to even in both."""
    rng = np.random.default_rng(2)
    g = rng.standard_normal((33, 17)).astype(np.float32)
    g[0, 0] = 127.0          # scale 1 (+1e-12): the row below is ties
    g[1, :5] = [0.5, 1.5, 2.5, -0.5, -2.5]
    err = (rng.standard_normal(g.shape) * 1e-3).astype(np.float32)
    err[:2] = 0.0
    jq, js, je = jgc.compress_leaf(jnp.asarray(g), jnp.asarray(err))
    tq, ts, te = tgc.compress_leaf(torch.as_tensor(g), torch.as_tensor(err))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert tq[1, :5].tolist() == [0, 2, 2, 0, -2]


def test_compress_tree_and_error_feedback_over_three_steps():
    rng = np.random.default_rng(3)
    params = tree_np(rng, bf16=True)
    jerr = jgc.init_error(jax.tree.map(jnp.asarray, params))
    terr = tgc.init_error(lm_params_from_numpy(params, "cpu"))
    for _ in range(3):
        g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
            p.dtype), params)
        jq, js, jerr = jgc.compress_tree(jax.tree.map(jnp.asarray, g), jerr)
        prev = terr
        tq, ts, terr = tgc.compress_tree(lm_params_from_numpy(g, "cpu"),
                                         terr)
        for a, b in zip(leaves(tq), leaves(jax.tree.map(np.asarray, jq))):
            np.testing.assert_array_equal(a.numpy(), b)
        for a, b in zip(leaves(terr), leaves(jax.tree.map(np.asarray,
                                                            jerr))):
            np.testing.assert_array_equal(a.numpy(), b)
        jd = jgc.decompress_tree(jq, js)
        td = tgc.decompress_tree(tq, ts)
        for a, b in zip(leaves(td), leaves(jax.tree.map(np.asarray, jd))):
            np.testing.assert_array_equal(a.numpy(), b)
        # the dequantised value is within half a step of g + the carried
        # error, and the new error is the residual
        for d, e, e0, gg, s in zip(leaves(td), leaves(terr), leaves(prev),
                                   leaves(g), leaves(ts)):
            gf = torch.as_tensor(gg.astype(np.float32)) + e0
            assert float((d - gf).abs().max()) <= 0.51 * float(s)
            assert torch.equal(e, gf - d)


def test_grad_compression_error_feedback():
    """tests/test_training.py::test_grad_compression_error_feedback on the
    port."""
    rng = np.random.default_rng(0)
    grads = {"a": torch.as_tensor(rng.standard_normal((64, 64)),
                                  dtype=torch.float32)}
    err = tgc.init_error(grads)
    q, s, err2 = tgc.compress_tree(grads, err)
    deq = tgc.decompress_tree(q, s)
    scale = float(leaves(s)[0])
    diff = (deq["a"] - grads["a"]).abs()
    assert float(diff.max()) <= scale * 0.51 + 1e-6
    torch.testing.assert_close(err2["a"], grads["a"] - deq["a"], atol=1e-6,
                               rtol=0)
    assert leaves(q)[0].dtype == torch.int8


@pytest.mark.parametrize("seed,step,frontend",
                         [(0, 0, 0), (0, 7, 0), (7, 42, 0), (3, 1, 5),
                          (11, 1000, 3)])
def test_batch_at_bitwise_jax(seed, step, frontend):
    kw = dict(vocab_size=300, seq_len=40, global_batch=3, seed=seed,
              frontend_len=frontend, d_model=8 if frontend else 0)
    want = jdata.batch_at(jdata.DataConfig(**kw), step)
    got = tdata.batch_at(tdata.DataConfig(**kw), step, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w)
    assert torch.equal(got["labels"][:, :-1], got["tokens"][:, 1:])


def test_data_pipeline_deterministic_and_stateless():
    """tests/test_training.py::test_data_pipeline_deterministic_and_stateless
    on the port."""
    dcfg = tdata.DataConfig(vocab_size=100, seq_len=16, global_batch=2,
                            seed=7)
    a = tdata.batch_at(dcfg, 42, device="cpu")
    b = tdata.batch_at(dcfg, 42, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    c = tdata.batch_at(dcfg, 43, device="cpu")
    assert not torch.equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == a["labels"].shape == (2, 16)


def test_batch_at_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = tdata.DataConfig(vocab_size=10, seq_len=4, global_batch=1)
    with pytest.raises(RuntimeError, match="cuda"):
        tdata.batch_at(cfg, 0)
