"""The port's LM serving surface against the JAX package's on the CPU:
greedy ``generate`` token for token, ``n_new`` edge cases, the KV
repartition plan and the alpha-fusion connection it is built on, the
configs' parameter counts and the registry, the parameter-tree
converters, and ``launch/serve.py --arch``.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import partition as jpart
from repro.models import lm as jlm
from repro.serving import engine as jeng
from repro.serving.repartition_kv import KVRepartitionPlan as JaxPlan
from repro_torch.configs import registry as treg
from repro_torch.core import partition as tpart
from repro_torch.interop import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import lm as tlm
from repro_torch.serving import engine as teng
from repro_torch.serving.repartition_kv import KVRepartitionPlan


def prompts_of(cfg, B=3, S=10, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    frontend = None
    if cfg.frontend:
        frontend = (rng.standard_normal((B, cfg.frontend_len, cfg.d_model))
                    * 0.02).astype(np.float32)
    return tokens, frontend


@pytest.mark.parametrize("arch", ["granite-3-8b", "rwkv6-1.6b",
                                  "paligemma-3b"])
def test_generate_tokens_equal_jax(arch):
    jcfg, tcfg = jreg.SMOKES[arch], treg.SMOKES[arch]
    jp = jlm.init_params(jcfg, jax.random.key(7))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tokens, frontend = prompts_of(jcfg)
    want = jeng.generate(jcfg, jp, jnp.asarray(tokens, jnp.int32), 6,
                         None if frontend is None else jnp.asarray(frontend))
    got = teng.generate(tcfg, tp, torch.as_tensor(tokens, dtype=torch.int32),
                        6, None if frontend is None
                        else torch.as_tensor(frontend))
    assert got.dtype == torch.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_n_new_edge_cases_as_jax():
    jcfg, tcfg = jreg.SMOKES["qwen3-0.6b"], treg.SMOKES["qwen3-0.6b"]
    tp = tlm.init_params(tcfg, torch.Generator().manual_seed(0))
    tokens, _ = prompts_of(tcfg)
    got = teng.generate(tcfg, tp, torch.as_tensor(tokens), 0)
    want = jeng.generate(jcfg, None, jnp.asarray(tokens, jnp.int32), 0)
    assert got.shape == want.shape == (3, 0)
    assert got.dtype == torch.int32 and want.dtype == jnp.int32
    with pytest.raises(ValueError, match="n_new must be >= 0"):
        teng.generate(tcfg, tp, torch.as_tensor(tokens), -1)
    with pytest.raises(ValueError, match="n_new must be >= 0"):
        jeng.generate(jcfg, None, jnp.asarray(tokens, jnp.int32), -1)


def test_start_and_serve_step():
    """The state's position counts the VLM prefix; a step advances it by
    one and returns the step's argmax tokens."""
    cfg = treg.SMOKES["paligemma-3b"]
    tp = tlm.init_params(cfg, torch.Generator().manual_seed(1))
    tokens, frontend = prompts_of(cfg, B=2, S=5)
    state, first = teng.start(cfg, tp, torch.as_tensor(tokens), 5 + 8 + 2,
                              torch.as_tensor(frontend))
    assert state.pos == 5 + cfg.frontend_len
    assert first.shape == (2, 1) and first.dtype == torch.int32
    logits, _ = tlm.decode_step(
        cfg, tp, tlm.prefill(cfg, tp, torch.as_tensor(tokens), 15,
                             torch.as_tensor(frontend))[1], first, state.pos)
    state2, nxt = teng.serve_step(cfg, tp, state)
    assert state2.pos == state.pos + 1
    assert torch.equal(nxt[:, 0], torch.argmax(logits, -1).to(torch.int32))


def test_greedy_takes_the_first_maximum():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    got = teng._greedy(logits)
    want = jnp.argmax(jnp.asarray(logits.numpy()), axis=-1)
    assert got[:, 0].tolist() == np.asarray(want).tolist() == [1, 0]


@pytest.mark.parametrize("batch,n_fine,alpha", [(8, 8, 2), (16, 8, 4),
                                                (12, 6, 3), (4, 4, 1),
                                                (32, 16, 16)])
def test_kv_repartition_plan_matches_jax(batch, n_fine, alpha):
    got = KVRepartitionPlan.build(batch, n_fine, alpha)
    want = JaxPlan.build(batch, n_fine, alpha)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    conn = jpart.alpha_fusion(jpart.BlockPartition.uniform(batch, n_fine),
                              alpha)
    for k in range(got.n_coarse):
        np.testing.assert_array_equal(got.owned_rows(k),
                                      conn.coarse.global_ids(k))


@pytest.mark.parametrize("batch,n_fine,alpha", [(8, 8, 3), (8, 3, 1),
                                                (8, 4, 0)])
def test_kv_repartition_plan_errors_as_jax(batch, n_fine, alpha):
    with pytest.raises(ValueError) as want:
        JaxPlan.build(batch, n_fine, alpha)
    with pytest.raises(ValueError) as got:
        KVRepartitionPlan.build(batch, n_fine, alpha)
    assert str(got.value) == str(want.value)


def test_alpha_fusion_matches_jax():
    fine_j = jpart.BlockPartition(np.array([0, 3, 7, 8, 12, 20, 21]))
    fine_t = tpart.BlockPartition(np.array([0, 3, 7, 8, 12, 20, 21]))
    for alpha in (1, 2, 3, 6):
        cj, ct = jpart.alpha_fusion(fine_j, alpha), tpart.alpha_fusion(
            fine_t, alpha)
        np.testing.assert_array_equal(ct.coarse.offsets, cj.coarse.offsets)
        assert ct.n_coarse == cj.n_coarse and ct.n_fine == cj.n_fine
        for f in range(6):
            assert ct.fused_row_offset(f) == cj.fused_row_offset(f)
            assert int(ct.coarse_of(f)) == int(cj.coarse_of(f))
        ids = np.arange(21)
        np.testing.assert_array_equal(ct.coarse.owner_of(ids),
                                      cj.coarse.owner_of(ids))


@pytest.mark.parametrize("arch", sorted(treg.ARCHS))
def test_param_counts_match_jax(arch):
    got, want = treg.get_config(arch), jreg.get_config(arch)
    assert got.active_params() == want.active_params()
    assert got.total_params() == want.total_params()
    assert got.n_periods == want.n_periods
    assert [(s.kind.value, s.moe) for s in got.period()] == [
        (s.kind.value, s.moe) for s in want.period()]


def test_registry_matches_jax():
    assert list(treg.ARCHS) == list(jreg.ARCHS)
    assert treg.FULL_ATTENTION == jreg.FULL_ATTENTION
    for arch in treg.ARCHS:
        assert dataclasses.asdict(treg.get_config(arch)) == \
            dataclasses.asdict(jreg.get_config(arch))
        assert dataclasses.asdict(treg.get_smoke_config(arch)) == \
            dataclasses.asdict(jreg.get_smoke_config(arch))
        for shape in jreg.SHAPES:
            assert treg.cell_is_skipped(arch, shape) == \
                jreg.cell_is_skipped(arch, shape)
    assert {k: dataclasses.asdict(v) for k, v in treg.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jreg.SHAPES.items()}


def test_qwen3_full_config_counts():
    cfg = treg.get_config("qwen3-0.6b")
    assert cfg.total_params() == 595_984_384
    assert cfg.n_periods == 28


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_round_trip_keeps_dtypes(dtype):
    """A tree as JAX's ``np.asarray`` gives it (bf16 leaves as ml_dtypes
    arrays, the f32 leaves f32) in and out of the port: every leaf's
    dtype, shape and bits."""
    cfg = dataclasses.replace(treg.SMOKES["jamba-v0.1-52b"], dtype=dtype)
    tree = lm_params_to_numpy(tlm.init_params(
        cfg, torch.Generator().manual_seed(0)))
    assert tree["embed"].dtype == np.asarray(jnp.zeros(1, dtype)).dtype
    back = lm_params_to_numpy(lm_params_from_numpy(tree, device="cpu"))
    flat_in = jax.tree_util.tree_leaves_with_path(tree)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, a in flat_in:
        b = flat_out[path]
        assert b.dtype == a.dtype and b.shape == a.shape, path
        np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8))
    mixed = lm_params_from_numpy(tree, device="cpu")["blocks"]["l0"]["mix"]
    assert mixed["A_log"].dtype == torch.float32
    assert mixed["in_proj"].dtype == getattr(torch, dtype)


def test_serve_cli_arch_smoke(capsys):
    """The JAX launcher's line shape; the tokens are the port's own
    ``generate`` on the seeded parameters and numpy prompts."""
    out = serve_main(["--device", "cpu", "--arch", "qwen3-0.6b", "--smoke",
                      "--n-new", "4"])
    text = capsys.readouterr().out
    assert re.search(r"^generated \(4, 4\) in \d+\.\d\ds \(\d+\.\d tok/s\)$",
                     text, re.MULTILINE), text
    rows = [list(map(int, re.findall(r"\d+", line)))
            for line in text.splitlines()[1:3]]
    assert rows == out[:2].tolist()
    cfg = treg.get_smoke_config("qwen3-0.6b")
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32))
    want = teng.generate(cfg, params, torch.as_tensor(prompts,
                                                      dtype=torch.int32), 4)
    np.testing.assert_array_equal(out, want.numpy())


def test_serve_cli_needs_arch_or_sessions(capsys):
    with pytest.raises(SystemExit):
        serve_main(["--device", "cpu"])
    assert "--arch is required (or use --sessions N" in \
        capsys.readouterr().err
