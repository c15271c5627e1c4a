"""The port's mesh train step for the ssm, vlm and audio families, whose
products split over ``model`` (rwkv6-1.6b's heads and channel mix,
paligemma-3b's attention, MLP and vocabulary over its patch rows and
text, whisper-medium's encoder, self- and cross-attention), on the CPU.

tests/test_torch_lm_mesh_train.py's two bars, on (2, 4) meshes naming
the CPU 8 times, one CPU thread (a multithreaded CPU product may round
differently run to run).  (1) Against the one-device step at accum 2 (the
mesh's 2 data rows): bitwise the same step on a mesh of the same shape
alternating ``cpu`` and ``cpu:0``, bitwise on a repeat, and within (2)'s
bar of the one-device step (loss and grad_norm 1e-5 relative, every
parameter within 2 lr k).  (2) Against JAX's sharded step
(``param_shardings`` on an Auto-axis (2, 4) mesh of 8 forced host
devices, run once for the module in a subprocess of its own) from its
``init_state(key 0)`` with ``AdamW()``'s lr: after each of 3 steps on
``batch_at(DataConfig(seed=0, frontend_len=, d_model=), k)`` (the patch
embeddings and encoder frames as the batch's ``frontend``), loss and
grad_norm within 1e-5 relative, every parameter within 2 lr k, the
moments within tests/test_torch_train_step.py's bounds.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.interop import train_state_from_numpy, train_state_to_numpy
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.sharding import Sharded
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts
from repro_torch.training.tree import leaves
from test_torch_lm_mesh_train import (CPU8, JAX_LR, LR, SEQ, STEPS, dcfg,
                                      run, same_state, within_bar)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["rwkv6-1.6b", "paligemma-3b", "whisper-medium"]

JAX_SIDE = textwrap.dedent(f"""
    import pickle, sys
    import jax, numpy as np
    from jax.sharding import AxisType
    from repro.configs.registry import get_smoke_config
    from repro.models.sharding import param_shardings, set_activation_mesh
    from repro.training.data import DataConfig, batch_at
    from repro.training.optimizer import AdamW, AdamWState
    from repro.training.train_step import init_state, make_train_step

    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    set_activation_mesh(mesh)
    out = {{}}
    for arch in {ARCHS!r}:
        cfg = get_smoke_config(arch)
        opt = AdamW(lr={JAX_LR})
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len={SEQ},
                          global_batch=4, seed=0,
                          frontend_len=cfg.frontend_len if cfg.frontend
                          else 0, d_model=cfg.d_model)
        s = init_state(cfg, opt, jax.random.key(0))
        init = jax.tree.map(np.asarray, s)
        p_sh = param_shardings(mesh, jax.eval_shape(lambda: s.params))
        put = lambda t: jax.device_put(t, p_sh)
        s = s._replace(params=put(s.params), opt=AdamWState(
            step=s.opt.step, m=put(s.opt.m), v=put(s.opt.v)))
        step = jax.jit(make_train_step(cfg, opt))
        metrics = []
        for k in range({STEPS}):
            s, m = step(s, batch_at(dcfg, k))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[arch] = (init, jax.tree.map(np.asarray, s), metrics)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's sharded step, 3 steps per arch, run once on 8 forced host
    devices in a subprocess."""
    path = tmp_path_factory.mktemp("mesh_families") / "out.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, str(path)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(path, "rb") as f:
        return pickle.load(f)


# rwkv6 at (2)'s lr and sequence length, as tests/test_torch_lm_mesh_train.py
# runs its split cases (its docstring says why)
ONE_DEVICE_CASES = [("rwkv6-1.6b", JAX_LR, SEQ), ("paligemma-3b", LR, 16),
                    ("whisper-medium", LR, 16)]


@pytest.mark.parametrize("arch,lr,seq", ONE_DEVICE_CASES)
def test_mesh_step_splits_and_holds_the_one_device_bars(arch, lr, seq):
    """Bitwise on a repeat and with the positions on two devices, within
    the JAX bar of the one-device step at accum 2; the step moves
    ``model`` bytes, and what it moves is what ``mesh_step_moves``
    composes."""
    cfg = treg.SMOKES[arch]
    assert cfg.family in tp.SPLIT_FAMILIES and tp.splits(cfg, 4)
    opt = topt.AdamW(lr=lr)
    state = tts.init_state(cfg, opt, torch.Generator().manual_seed(0))
    batches = [tdata.batch_at(dcfg(cfg, seq=seq), k, device="cpu")
               for k in range(STEPS)]
    one, m_one = run(tts.make_train_step(cfg, opt, accum=2), state, batches)
    mesh = make_debug_mesh(2, 4, CPU8)
    step = tts.make_train_step(cfg, opt, accum=1)
    on, m_on = run(step, tts.shard_state(state, mesh), batches)
    again, m_again = run(step, tts.shard_state(state, mesh), batches)
    assert m_again == m_on and same_state(again, on)
    alt = make_debug_mesh(2, 4, ["cpu", "cpu:0"] * 4)
    moved, m_moved = run(step, tts.shard_state(state, alt), batches)
    assert m_moved == m_on and same_state(moved, on)
    within_bar(on, m_on, one, m_one, False, lr)
    _, m = step(tts.shard_state(state, mesh), batches[0])
    assert m["moved"].model.positions > 0
    assert m["moved"] == tts.mesh_step_moves(cfg, mesh, 1, 4, seq)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_jax_sharded_step(jax_runs, arch):
    init, want, jmetrics = jax_runs[arch]
    cfg = treg.SMOKES[arch]
    mesh = make_debug_mesh(2, 4, CPU8)
    state = train_state_from_numpy(init, mesh=mesh)
    assert all(isinstance(x, Sharded) for x in leaves(state.params))
    step = tts.make_train_step(cfg, topt.AdamW(lr=JAX_LR), accum=1)
    for k in range(STEPS):
        state, m = step(state, tdata.batch_at(dcfg(cfg), k, device="cpu"))
        jl, jg = jmetrics[k]
        assert abs(float(m["loss"]) - jl) <= 1e-5 * abs(jl), k
        assert abs(float(m["grad_norm"]) - jg) <= 1e-5 * abs(jg), k
        assert m["moved"].model.positions > 0
    got = train_state_to_numpy(state)
    for g, w in zip(leaves(got.params), leaves(want.params)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.abs(g.astype(np.float64) - w).max() <= (
            2 * JAX_LR * STEPS + 1e-7)
    for tree in ("m", "v"):
        for g, w in zip(leaves(getattr(got.opt, tree)),
                        leaves(getattr(want.opt, tree))):
            assert (np.abs(g.astype(np.float64) - w).max()
                    <= 2e-4 * max(np.abs(w).max(), 1e-30)), tree
