"""The port's training loss, its gradients and its remat against the JAX
package, architecture by architecture, on the CPU.

For every registry ``SMOKE`` config JAX's ``init_params`` is carried
across by ``lm_params_from_numpy``; the same numpy-drawn batch (a fifth
of the labels set to ``MASK_LABEL``; the Whisper frames and the PaliGemma
prefix from the same generator) then goes through ``jax.value_and_grad(
lm.loss_fn)`` and the port's ``loss_fn`` with ``torch.autograd.grad``.
Bounds: the loss within 1e-5 relative, each gradient leaf within 1e-5 of
that leaf's largest |g| in JAX (1e-4 for Mamba, RWKV and Whisper, whose
time recurrences and encoder-decoder the serving tests also hold to
1e-4); the float32 runs agree to a few 1e-7.  The remat tests hold the
gradients with ``remat`` on (each period, and each 256-step time chunk
of the recurrences, recomputed in the backward pass) bitwise to those
with it off.  Those bitwise checks run on one CPU thread: a
multithreaded CPU product may split its reduction differently from run
to run, so two identical runs on several threads can differ in the last
bit of the embedding and head gradients.
"""
import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro_torch.configs import registry as treg
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import lm as tlm
from repro_torch.models import rwkv, scan_utils, ssm
from repro_torch.training.tree import key_paths, leaves, unflatten

ARCHS = sorted(treg.SMOKES)
LOOSE = {"jamba-v0.1-52b", "rwkv6-1.6b", "whisper-medium"}  # 1e-4 families
B, S = 2, 16
LOSS_TOL = 1e-5


def grad_tol(arch):
    return 1e-4 if arch in LOOSE else 1e-5


def batch(cfg, seed=0, s=S, masked=True):
    """tokens, labels (a fifth masked) and the stub frontend, numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    if masked:
        labels[rng.random((B, s)) < 0.2] = tlm.MASK_LABEL
    frontend = None
    if cfg.frontend:
        frontend = (rng.standard_normal((B, cfg.frontend_len, cfg.d_model))
                    * 0.02).astype(np.float32)
    return tokens, labels, frontend


def as_torch(tokens, labels, frontend):
    return (torch.as_tensor(tokens), torch.as_tensor(labels),
            None if frontend is None else torch.as_tensor(frontend))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def saving_everything():
    """Remat off: the stack's and the scans' checkpoints call their
    function directly, so autograd saves every activation."""
    def direct(fn, *args, use_reentrant, preserve_rng_state, **kw):
        return fn(*args, **kw)

    with mock.patch.object(tlm, "checkpoint", direct), \
            mock.patch.object(scan_utils, "checkpoint", direct):
        yield


def torch_loss_and_grads(cfg, params, b, remat=True):
    req = [p.detach().requires_grad_() for p in leaves(params)]
    with contextlib.nullcontext() if remat else saving_everything():
        loss = tlm.loss_fn(cfg, unflatten(params, req), *b)
        grads = torch.autograd.grad(loss, req, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), dict(zip([k for k, _ in key_paths(params)],
                                   grads))


def test_mask_label_is_jax_s():
    assert tlm.MASK_LABEL == jlm.MASK_LABEL == -100


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    jcfg, tcfg = jreg.SMOKES[arch], treg.SMOKES[arch]
    jp = jlm.init_params(jcfg, jax.random.key(4))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tokens, labels, frontend = batch(jcfg)
    assert (labels == tlm.MASK_LABEL).any()
    jloss, jgrads = jax.jit(jax.value_and_grad(
        functools.partial(jlm.loss_fn, jcfg)))(
        jp, jnp.asarray(tokens), jnp.asarray(labels),
        None if frontend is None else jnp.asarray(frontend))
    tloss, tgrads = torch_loss_and_grads(
        tcfg, tp, as_torch(tokens, labels, frontend))
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    want = dict(key_paths(jax.tree.map(np.asarray, jgrads)))
    assert tgrads.keys() == want.keys()
    for k, w in want.items():
        g = tgrads[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.astype(np.float64) - w).max())
        assert err <= grad_tol(arch) * scale, (k, err / scale)


def test_loss_fn_masks_and_unties():
    """Every label masked gives 0 (the count floors at 1); an untied head
    takes its gold rows from ``lm_head``'s columns; JAX agrees."""
    for arch in ("granite-3-8b", "qwen3-0.6b"):
        jcfg, tcfg = jreg.SMOKES[arch], treg.SMOKES[arch]
        jp = jlm.init_params(jcfg, jax.random.key(1))
        tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        tokens, labels, _ = batch(jcfg, masked=False)
        labels[:] = tlm.MASK_LABEL
        got = tlm.loss_fn(tcfg, tp, *as_torch(tokens, labels, None))
        want = jlm.loss_fn(jcfg, jp, jnp.asarray(tokens), jnp.asarray(labels))
        assert float(got) == float(want) == 0.0
        assert ("lm_head" in tp) == (not tcfg.tie_embeddings)


@pytest.mark.parametrize("arch", ARCHS)
def test_sgd_step_decreases_loss(arch):
    """tests/test_models_smoke.py::test_train_step_decreases_loss on the
    port: from the same parameters (JAX's ``init_params`` at key 1,
    carried across), one SGD step (lr 5e-2) on a repeated batch lowers
    the loss."""
    cfg = treg.SMOKES[arch]
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jlm.init_params(
        jreg.SMOKES[arch], jax.random.key(1))), device="cpu")
    b = as_torch(*batch(cfg, masked=False))
    l0, grads = torch_loss_and_grads(cfg, params, b)
    assert np.isfinite(float(l0))
    lr = 5e-2
    names = [k for k, _ in key_paths(params)]
    params2 = unflatten(params, [p - lr * grads[k].to(p.dtype) for k, p in
                                 zip(names, leaves(params))])
    with torch.no_grad():
        l1 = tlm.loss_fn(cfg, params2, *b)
    assert float(l1) < float(l0), (float(l0), float(l1))


@pytest.mark.parametrize("arch", ARCHS)
def test_period_remat_gradients_bitwise(arch, one_thread):
    """Each period recomputed in the backward pass gives the gradients
    and loss of the run that saves everything, bit for bit."""
    cfg = treg.SMOKES[arch]
    params = tlm.init_params(cfg, torch.Generator().manual_seed(2))
    b = as_torch(*batch(cfg, seed=2))
    l_on, g_on = torch_loss_and_grads(cfg, params, b, remat=True)
    l_off, g_off = torch_loss_and_grads(cfg, params, b, remat=False)
    assert torch.equal(l_on, l_off)
    for k in g_off:
        assert torch.equal(g_on[k].view(torch.int32),
                           g_off[k].view(torch.int32)), k


def counting(monkeypatch, module):
    calls = []
    real = module.checkpoint

    def spy(fn, *a, **kw):
        calls.append(fn.__name__)
        return real(fn, *a, **kw)

    monkeypatch.setattr(module, "checkpoint", spy)
    return calls


def test_remat_runs_only_when_autograd_records(monkeypatch):
    """A period a checkpoint and a time chunk a checkpoint when autograd
    records; none under ``no_grad`` or when nothing requires grad
    (serving: launch for launch as before)."""
    cfg = treg.SMOKES["jamba-v0.1-52b"]   # Mamba and attention, 2 periods
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0))
    b = as_torch(*batch(cfg))
    periods = counting(monkeypatch, tlm)
    chunks = counting(monkeypatch, scan_utils)
    tlm.loss_fn(cfg, params, *b)
    assert periods == [] and chunks == []
    with torch.no_grad():
        tlm.loss_fn(cfg, unflatten(params, [t.requires_grad_() for t in
                                            leaves(params)]), *b)
    assert periods == [] and chunks == []
    torch_loss_and_grads(cfg, params, b)
    n_mamba = sum(s.kind.name == "MAMBA" for s in cfg.period())
    assert periods == ["_apply_period"] * cfg.n_periods
    # each Mamba layer's scan: one chunk of 16 steps
    assert len(chunks) >= n_mamba * cfg.n_periods
    assert set(chunks) == {"_scan"}


def toy_step(w):
    def step(h, inp):
        (xt,) = inp
        h = torch.tanh(h * w + xt)
        return h, h * 2.0
    return step


@pytest.mark.parametrize("T", [600, 256, 7])
def test_chunked_scan_remat_bitwise(T, monkeypatch, one_thread):
    """Chunks of 256 steps (600 = 256 + 256 + 88: a ragged last chunk),
    recomputed in the backward pass, give the carry, outputs and
    gradients of the plain loop that saves everything, including the
    gradient of a tensor the step reads from its closure."""
    g = torch.Generator().manual_seed(T)
    xs = torch.randn(T, 3, 5, generator=g, dtype=torch.float64)
    w0 = torch.randn(5, generator=g, dtype=torch.float64)
    h0 = torch.randn(3, 5, generator=g, dtype=torch.float64)
    calls = counting(monkeypatch, scan_utils)
    out = {}
    for remat in (False, True):
        x, w, h = (t.clone().requires_grad_() for t in (xs, w0, h0))
        scan = scan_utils.chunked_scan if remat else scan_utils._scan
        carry, ys = scan(toy_step(w), h, (x,))
        loss = (ys ** 2).sum() + carry.sum()
        out[remat] = (carry.detach(), ys.detach(),
                      *torch.autograd.grad(loss, (x, w, h)))
    assert len(calls) == -(-T // scan_utils.DEFAULT_CHUNK)
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a.view(torch.int64), b.view(torch.int64))
    assert out[True][3].abs().sum() > 0   # the closure's gradient


@pytest.mark.parametrize("layer", ["mamba", "rwkv"])
def test_recurrence_time_chunks_bitwise(layer, one_thread):
    """Mamba's and RWKV's scans over 300 steps (two chunks, the second
    ragged) with the time chunks recomputed: bitwise the saved run."""
    cfg = treg.SMOKES["jamba-v0.1-52b" if layer == "mamba" else
                      "rwkv6-1.6b"]
    gen = torch.Generator().manual_seed(5)
    if layer == "mamba":
        p = ssm.mamba_init(gen, cfg.d_model, cfg.d_inner, cfg.ssm_d_state,
                           tlm.D_CONV, "float32")
        apply = ssm.mamba_apply
    else:
        p = rwkv.rwkv_init(gen, cfg.d_model, cfg.rwkv_head_dim, "float32")
        apply = rwkv.rwkv_apply
    x0 = torch.randn(2, 300, cfg.d_model, generator=gen)
    out = {}
    for remat in (False, True):
        leaves_ = [t.clone().requires_grad_() for t in leaves(p)]
        pp = unflatten(p, leaves_)
        x = x0.clone().requires_grad_()
        with contextlib.nullcontext() if remat else saving_everything():
            y, st = apply(pp, x)
        last = st["ssm"] if layer == "mamba" else st["S"]
        loss = (y.float() ** 2).sum() + last.sum()
        out[remat] = [y.detach()] + list(torch.autograd.grad(
            loss, [x] + leaves_))
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_model_remat_over_two_time_chunks_bitwise(one_thread):
    """rwkv6-smoke over 272 tokens (chunks of 256 and 16) inside the
    period remat: loss and every gradient bitwise the saved run."""
    cfg = treg.SMOKES["rwkv6-1.6b"]
    params = tlm.init_params(cfg, torch.Generator().manual_seed(3))
    b = as_torch(*batch(cfg, s=272))
    l_on, g_on = torch_loss_and_grads(cfg, params, b, remat=True)
    l_off, g_off = torch_loss_and_grads(cfg, params, b, remat=False)
    assert torch.equal(l_on, l_off)
    for k in g_off:
        assert torch.equal(g_on[k].view(torch.int32),
                           g_off[k].view(torch.int32)), k
