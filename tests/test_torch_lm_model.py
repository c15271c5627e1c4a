"""The port's LM stack against the JAX package's, architecture by
architecture, on the CPU.

For every registry ``SMOKE`` config, JAX's ``init_params`` is carried
across by ``lm_params_from_numpy``; the same numpy-seeded prompt then goes
through ``prefill`` (logits and every cache leaf) and 4 ``decode_step``s
(logits and every cache leaf after each) in both packages, and
``forward`` over the whole sequence; the port also decodes on from JAX's
prefilled cache (``lm_cache_from_numpy``).  The prompt (12 tokens) is longer
than mixtral-smoke's window of 8, so its ring-buffer prefill and decode
run.  Tolerance, relative to the largest |value| of the JAX result:
1e-5 for the attention families, 1e-4 for Mamba, RWKV and Whisper (time
recurrences and a 2 x 2-layer encoder-decoder); the float32 runs here
agree to ~2e-6.  A bfloat16 qwen3-smoke is held within 3e-2 (eager
PyTorch rounds after each op where XLA may round a fused chain once) and
not on greedy tokens.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro_torch.configs import registry as treg
from repro_torch.interop import (lm_cache_from_numpy, lm_cache_to_numpy,
                                 lm_params_from_numpy)
from repro_torch.models import lm as tlm

ARCHS = sorted(treg.SMOKES)
LOOSE = {"jamba-v0.1-52b", "rwkv6-1.6b", "whisper-medium"}  # 1e-4 families
B, S, N_DEC = 2, 12, 4
BF16_BOUND = 3e-2


def tol(arch):
    return 1e-4 if arch in LOOSE else 1e-5


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def jax_params(cfg, seed):
    params = jlm.init_params(cfg, jax.random.key(seed))
    return params, lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")


def inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + N_DEC))
    frontend = None
    if cfg.frontend:
        frontend = (rng.standard_normal((B, cfg.frontend_len, cfg.d_model))
                    * 0.02).astype(np.float32)
    return tokens, frontend


def both(tokens, frontend):
    """(JAX, torch) copies of the token block and the frontend."""
    jf = None if frontend is None else jnp.asarray(frontend)
    tf = None if frontend is None else torch.as_tensor(frontend)
    return ((jnp.asarray(tokens, jnp.int32), jf),
            (torch.as_tensor(tokens, dtype=torch.int32), tf))


def check_cache(tcache, jcache, bound, what):
    want = leaves(jax.tree.map(np.asarray, jcache))
    got = leaves(lm_cache_to_numpy(tcache))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        assert rel_err(got[k], want[k]) <= bound, (what, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_caches_match_jax(arch):
    jcfg, tcfg = jreg.SMOKES[arch], treg.SMOKES[arch]
    jp, tp = jax_params(jcfg, seed=3)
    tokens, frontend = inputs(jcfg)
    (jt, jf), (tt, tf) = both(tokens, frontend)
    n_prefix = jcfg.frontend_len if jcfg.frontend == "vision_stub" else 0
    max_len = S + N_DEC + n_prefix
    bound = tol(arch)

    jl, jc = jax.jit(functools.partial(jlm.prefill, jcfg, max_len=max_len))(
        jp, jt[:, :S], frontend=jf)
    tl, tc = tlm.prefill(tcfg, tp, tt[:, :S], max_len, tf)
    assert rel_err(tl, jl) <= bound
    check_cache(tc, jc, bound, "prefill")

    # JAX's own cache, carried across, decodes as the port's does
    _, from_jax = tlm.decode_step(
        tcfg, tp, lm_cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu"),
        tt[:, S:S + 1], S + n_prefix)

    jdec = jax.jit(functools.partial(jlm.decode_step, jcfg))
    for i in range(N_DEC):
        pos = S + n_prefix + i
        jl, jc = jdec(jp, jc, jt[:, S + i:S + i + 1],
                      jnp.asarray(pos, jnp.int32))
        tl, tc = tlm.decode_step(tcfg, tp, tc, tt[:, S + i:S + i + 1], pos)
        assert rel_err(tl, jl) <= bound, f"decode step {i}"
        check_cache(tc, jc, bound, f"decode step {i}")
        if i == 0:
            check_cache(from_jax, jc, bound, "decode from JAX's cache")

    jfwd = jax.jit(functools.partial(jlm.forward, jcfg))(jp, jt, jf)
    assert rel_err(tlm.forward(tcfg, tp, tt, tf), jfwd) <= bound


def test_init_params_tree_matches_jax_structure():
    """Same keys, shapes and per-leaf dtypes as JAX's tree, for every
    arch, in float32 and in bfloat16 (the f32 leaves stay f32)."""
    for arch in ARCHS:
        for dtype in ("float32", "bfloat16"):
            jcfg = dataclasses.replace(jreg.SMOKES[arch], dtype=dtype)
            tcfg = dataclasses.replace(treg.SMOKES[arch], dtype=dtype)
            want = leaves(jax.eval_shape(
                functools.partial(jlm.init_params, jcfg),
                jax.random.key(0)))
            got = leaves(tlm.init_params(
                tcfg, torch.Generator().manual_seed(0)))
            assert got.keys() == want.keys(), arch
            for k, w in want.items():
                assert tuple(got[k].shape) == w.shape, (arch, k)
                assert str(got[k].dtype).split(".")[1] == str(w.dtype), \
                    (arch, dtype, k)
            cache_want = leaves(jax.eval_shape(functools.partial(
                jlm.init_cache, jcfg, 2, 10, 3 if jcfg.cross_attention
                else 0)))
            cache_got = leaves(tlm.init_cache(
                tcfg, 2, 10, 3 if tcfg.cross_attention else 0,
                device="cpu"))
            assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
                    for k, v in cache_got.items()} == {
                k: (v.shape, str(v.dtype)) for k, v in cache_want.items()}


def test_init_params_is_seeded():
    cfg = treg.SMOKES["jamba-v0.1-52b"]
    a = leaves(tlm.init_params(cfg, torch.Generator().manual_seed(5)))
    b = leaves(tlm.init_params(cfg, torch.Generator().manual_seed(5)))
    c = leaves(tlm.init_params(cfg, torch.Generator().manual_seed(6)))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks/l0/mix/in_proj"],
                           c["blocks/l0/mix/in_proj"])


def test_bfloat16_qwen3_within_bound():
    arch = "qwen3-0.6b"
    jcfg = dataclasses.replace(jreg.SMOKES[arch], dtype="bfloat16")
    tcfg = dataclasses.replace(treg.SMOKES[arch], dtype="bfloat16")
    jp, tp = jax_params(jcfg, seed=3)
    assert tp["embed"].dtype == torch.bfloat16
    tokens, _ = inputs(jcfg)
    (jt, _), (tt, _) = both(tokens, None)
    max_len = S + N_DEC
    jl, jc = jax.jit(functools.partial(jlm.prefill, jcfg, max_len=max_len))(
        jp, jt[:, :S])
    tl, tc = tlm.prefill(tcfg, tp, tt[:, :S], max_len)
    errs = [rel_err(tl.float(), np.asarray(jl, np.float32))]
    jdec = jax.jit(functools.partial(jlm.decode_step, jcfg))
    for i in range(N_DEC):
        jl, jc = jdec(jp, jc, jt[:, S + i:S + i + 1],
                      jnp.asarray(S + i, jnp.int32))
        tl, tc = tlm.decode_step(tcfg, tp, tc, tt[:, S + i:S + i + 1], S + i)
        errs.append(rel_err(tl.float(), np.asarray(jl, np.float32)))
    assert max(errs) <= BF16_BOUND, errs
    assert tc["l0"]["k"].dtype == torch.bfloat16
