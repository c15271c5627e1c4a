"""The port's whole train step against the JAX package's, on the CPU.

JAX's ``init_state`` (key 0) is carried across by
``train_state_from_numpy``; both packages then take 3 steps of
``make_train_step`` on ``batch_at(DataConfig(seed=1), k)`` with
``AdamW()``'s defaults (lr 3e-4).  The archs run granite and qwen3 with
``accum`` 1 and 2 and compression off and on, mixtral (MoE) and rwkv6
with (1, off) and (2, on), and jamba with (2, on) (its JAX step takes
~15 s to compile).  The rule, after step k (bounds chosen from the
float32 runs, which stay 5-20x inside them):

* loss within 1e-5 relative; grad_norm within 1e-5 relative, 1e-4 with
  compression (the dequantised gradient moves by one int8 step where a
  value near a .5 tie rounds the other way);
* every parameter within 2 lr k of JAX's.  AdamW's first update is
  ``g / (|g| + eps)``, about sign(g), so an element whose gradient is
  rounding noise can move by 2 lr the other way;
* without compression, elements whose gradient stayed above noise at
  every step so far (``sqrt(v_hat)`` at least 1e-3 of the leaf's
  largest) within 1e-2 lr of JAX's (observed up to 1.6e-3 lr);
* the moments within 2e-4 of the leaf's largest |value|, with
  compression plus k/127 for m and 2k/127 for v (one int8 step of g,
  1/127 of max |g|, moves m by 1/127 of max |m| and v by 2/127 of max |v|
  after one step); the error buffers within
  2.5x JAX's largest |error| (one step, twice the largest error).

``accum`` 1 against 2 in the port is held to JAX's own bounds
(tests/test_training.py::test_train_loop_decreases_loss_and_accum_consistent).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch.configs import registry as treg
from repro_torch.interop import train_state_from_numpy, train_state_to_numpy
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts
from repro_torch.training.tree import leaves

CASES = [("granite-3-8b", a, c) for a in (1, 2) for c in (False, True)] + [
    ("qwen3-0.6b", a, c) for a in (1, 2) for c in (False, True)] + [
    (arch, a, c) for arch in ("mixtral-8x22b", "rwkv6-1.6b")
    for a, c in ((1, False), (2, True))] + [("jamba-v0.1-52b", 2, True)]
STEPS = 3
NOISE = 1e-3        # sqrt(v_hat) below this share of the leaf's max: noise
TIGHT = 1e-2        # x lr: above-noise elements without compression


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op torch thread: the suite runs several workers on few
    cores, whose threads would otherwise oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def data_kw(cfg, seq_len=16, batch=4, seed=1):
    return dict(vocab_size=cfg.vocab_size, seq_len=seq_len,
                global_batch=batch, seed=seed,
                frontend_len=cfg.frontend_len if cfg.frontend else 0,
                d_model=cfg.d_model)


def rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def max_rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("arch,accum,compress", CASES)
def test_train_step_matches_jax(arch, accum, compress):
    jcfg, tcfg = jreg.SMOKES[arch], treg.SMOKES[arch]
    jo, to = jopt.AdamW(), topt.AdamW()
    js = jts.init_state(jcfg, jo, jax.random.key(0), compress=compress)
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    assert (ts.err is None) == (not compress)
    jstep = jax.jit(jts.make_train_step(jcfg, jo, compress=compress,
                                        accum=accum))
    tstep = tts.make_train_step(tcfg, to, compress=compress, accum=accum)
    kw = data_kw(jcfg)
    lr = to.lr
    above = None
    for k in range(1, STEPS + 1):
        js, jm = jstep(js, jdata.batch_at(jdata.DataConfig(**kw), k - 1))
        ts, tm = tstep(ts, tdata.batch_at(tdata.DataConfig(**kw), k - 1,
                                          device="cpu"))
        assert int(tm["step"]) == int(jm["step"]) == k
        assert rel(tm["loss"], jm["loss"]) <= 1e-5, k
        assert rel(tm["grad_norm"], jm["grad_norm"]) <= (
            1e-4 if compress else 1e-5), k
        want = jax.tree.map(np.asarray, js)
        got = train_state_to_numpy(ts)
        bc2 = 1 - to.b2 ** k
        pv = zip(leaves(got.params), leaves(want.params),
                 leaves(want.opt.v))
        above = above or [None] * len(leaves(want.params))
        for i, (g, w, v) in enumerate(pv):
            assert g.dtype == w.dtype
            d = np.abs(g.astype(np.float64) - w)
            assert d.max() <= 2 * lr * k + 1e-7, (k, i)
            sv = np.sqrt(v / bc2)
            a = sv >= NOISE * sv.max()
            above[i] = a if above[i] is None else above[i] & a
            if not compress and above[i].any():
                assert d[above[i]].max() <= TIGHT * lr, (k, i)
        for tree, steps in (("m", k / 127), ("v", 2 * k / 127)):
            bound = 2e-4 + (steps if compress else 0.0)
            for g, w in zip(leaves(getattr(got.opt, tree)),
                            leaves(getattr(want.opt, tree))):
                assert max_rel(g, w) <= bound, (k, tree)
        if compress:
            for g, w in zip(leaves(got.err), leaves(want.err)):
                assert np.abs(g - w).max() <= 2.5 * np.abs(w).max() + 1e-12


def test_accum_consistent_and_loss_decreases():
    """tests/test_training.py::test_train_loop_decreases_loss_and_accum_
    consistent on the port, with its bounds: accum 1 and 2 give the same
    loss (rtol 1e-4) and near-identical first leaves (atol 2e-2); 5 more
    steps on the fixed batch lower the loss."""
    cfg = treg.SMOKES["granite-3-8b"]
    opt = topt.AdamW(lr=1e-2)
    dcfg = tdata.DataConfig(**data_kw(cfg, seq_len=32, batch=4))
    batch = tdata.batch_at(dcfg, 0, device="cpu")
    s1 = tts.init_state(cfg, opt, torch.Generator().manual_seed(0))
    s2 = tts.init_state(cfg, opt, torch.Generator().manual_seed(0))
    s1b, m1 = tts.make_train_step(cfg, opt, accum=1)(s1, batch)
    s2b, m2 = tts.make_train_step(cfg, opt, accum=2)(s2, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(leaves(s1b.params)[0].numpy(),
                               leaves(s2b.params)[0].numpy(), atol=2e-2)
    step1 = tts.make_train_step(cfg, opt, accum=1)
    losses, s = [float(m1["loss"])], s1b
    for _ in range(5):
        s, m = step1(s, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_accum_gradients_are_f32_and_inputs_untouched(monkeypatch):
    """With accum 2 the optimizer sees f32 gradients (the microbatches'
    bf16 gradients added as ``g.float() / accum``); with accum 1 it sees
    the parameters' dtype; the state passed in is not modified and no
    parameter is left with a ``.grad``."""
    import dataclasses

    cfg = dataclasses.replace(treg.SMOKES["qwen3-0.6b"], dtype="bfloat16")
    opt = topt.AdamW()
    seen = []
    real = topt.AdamW.update

    def spy(self, grads, state, params):
        seen.append({g.dtype for g in leaves(grads)})
        return real(self, grads, state, params)

    monkeypatch.setattr(topt.AdamW, "update", spy)
    state = tts.init_state(cfg, opt, torch.Generator().manual_seed(0),
                           compress=True)
    before = [t.clone() for t in leaves(state)]
    batch = tdata.batch_at(tdata.DataConfig(**data_kw(cfg)), 0, device="cpu")
    new, m = tts.make_train_step(cfg, opt, accum=2)(state, batch)
    tts.make_train_step(cfg, opt, accum=1)(state, batch)
    assert seen[0] == {torch.float32}
    assert seen[1] == {torch.bfloat16}
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(state)))
    assert all(p.grad is None and not p.requires_grad
               for p in leaves(new.params))
    assert {p.dtype for p in leaves(new.params)} == {torch.bfloat16}
    assert set(m) == {"loss", "grad_norm", "step"} and int(m["step"]) == 1


def test_compressed_step_feeds_the_error_back():
    cfg = treg.SMOKES["granite-3-8b"]
    opt = topt.AdamW()
    st = tts.init_state(cfg, opt, torch.Generator().manual_seed(0),
                        compress=True)
    assert all(float(e.abs().max()) == 0 for e in leaves(st.err))
    step = tts.make_train_step(cfg, opt, compress=True, accum=1)
    batch = tdata.batch_at(tdata.DataConfig(**data_kw(cfg)), 0, device="cpu")
    st, m = step(st, batch)
    assert np.isfinite(float(m["loss"]))
    assert any(float(e.abs().max()) > 0 for e in leaves(st.err))
    assert all(e.dtype == torch.float32 for e in leaves(st.err))
