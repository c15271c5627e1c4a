"""The port's train step on a device mesh, on the CPU.

Two bars.  (1) Against the one-device step: where no product splits
(rwkv6-1.6b on a (2, 3) mesh, whose 3 ``model`` positions divide none of
its heads, widths or vocabulary; its parameters gathered a period at a
time) the mesh step performs the one-device step's arithmetic at ``accum
* D`` with ``D`` data rows and ``accum`` microbatches (the same slices,
shapes and f32 adds in the same order), and after 3 steps every loss,
grad_norm, parameter, moment and error buffer equals the one-device
run's bit for bit, compression off and on.  Where products split over
``model`` (each position's slice, the partials summed) the cases
(glm4-9b, JAX's own case in tests/test_distributed.py, qwen3-0.6b,
starcoder2-7b, whose 6 heads do not split over 4 positions, mixtral-8x22b,
also on a (2, 2, 2) mesh with a ``pod`` axis, 4 data rows, and rwkv6 on
(2, 4)) hold three bars instead: bitwise the same step on a mesh of the
same shape alternating ``cpu`` and ``cpu:0``, bitwise on a repeat, and
within (2)'s bar of the one-device step (loss and grad_norm 1e-5
relative, 1e-4 for grad_norm with compression; every parameter within 2
lr k).  rwkv6's split cases run at (2)'s lr and sequence length: at lr
1e-2 its group norm's rounding, amplified by AdamW's sign-like first
updates, carries the one-device step past 1e-5 against itself with its
microbatches reordered within 3 steps.  The runs use one CPU thread (a multithreaded CPU product may
round differently run to run).  (2) Against JAX: its sharded step
(``param_shardings`` on an Auto-axis (2, 4) mesh of 8 forced host
devices, one subprocess for the module, as tests/test_torch_full_mesh.py
runs JAX) from its ``init_state(key 0)`` with ``AdamW()``'s lr, carried
across by ``train_state_from_numpy(..., mesh=)``; after each of 3 steps
on ``batch_at(DataConfig(seed=0), k)``, loss and grad_norm within 1e-5
relative (1e-4 for grad_norm with compression, as
tests/test_torch_train_step.py allows), every parameter within that
file's bounds (2 lr k; 1e-2 lr where the gradient stayed above noise,
without compression, for qwen3: glm4's one-device step is outside that
rule against JAX's one-device step too; the moments and error buffers
as there): glm4-9b, qwen3-0.6b, starcoder2-7b (whose 6 heads do not
split over 4 positions), mixtral-8x22b (its experts' ``d_ff`` split,
EP), phi3.5-moe and jamba (its Mamba mixer's ``d_inner`` and its MoE
split), and microbatches whose data rows differ: qwen3-0.6b with a
seeded half of the first batch row's labels masked (JAX's loss divides
the microbatch's summed losses by its valid labels), phi3.5-moe with the
sorted dispatch at capacity factor 1.0 (its capacity and drops the
microbatch's; the case asserts that each row's own sort would keep other
assignments), also at 4096 positions (two chunks; a batch of 2, one
step).  JAX's step computes the whole batch at once and the port's two
rows' halves, so the two differ by rounding only.  Then the launcher
(qwen3-0.6b): a mesh run resumed on the mesh is bitwise an uninterrupted
mesh run; ``--mesh 2,4`` resumes an unsharded run's checkpoint and the
reverse, and both, like the mesh run, are within (1)'s bar of an
unsharded run at ``--accum 2``; a mesh with too few devices raises.
"""
import dataclasses
import json
import os
import pickle
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.interop import (lm_params_from_numpy, train_state_from_numpy,
                                train_state_to_numpy)
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import make_debug_mesh, make_mesh
from repro_torch.models.sharding import (MoveStats, NamedSharding, P,
                                         Sharded, param_shardings)
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts
from repro_torch.training.tree import leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8
STEPS, LR, SEQ, BATCH = 3, 1e-2, 32, 4
JAX_LR = 3e-4   # AdamW()'s: the lr tests/test_torch_train_step.py's
#                 parameter bounds were chosen at
JAX_CASES = [("glm4-9b", False), ("glm4-9b", True), ("qwen3-0.6b", False),
             ("starcoder2-7b", False), ("mixtral-8x22b", False),
             ("phi3.5-moe-42b-a6.6b", False), ("jamba-v0.1-52b", False)]
# the archs whose one-device step meets the 1e-2 lr rule against JAX's
# (tests/test_torch_train_step.py); glm4's does not: 3 of its 16,384
# w_gate elements sit at 1.29e-2 lr after 3 one-device steps, a rounding
# drift JAX's own accum 1 against accum 2 shows at 4.0e-3 lr
TIGHT_ARCHS = ("qwen3-0.6b",)
NOISE, TIGHT = 1e-3, 1e-2   # tests/test_torch_train_step.py's rule
# microbatches whose data rows differ: a seeded half of the first batch
# row's labels masked (the first data row then holds fewer valid labels
# than the second); the sorted MoE dispatch at capacity factor 1.0 (its
# capacity and drops the microbatch's), also at 4096 positions (two
# 2048-position chunks; a batch of 2, one step)
VARIANTS = [("qwen3-0.6b", "masked"), ("phi3.5-moe-42b-a6.6b", "sorted"),
            ("phi3.5-moe-42b-a6.6b", "sorted_4096")]
MASK_SEED, MASK_SHARE = 7, 0.5


def shape_of(variant) -> tuple:
    """``(seq_len, global batch, steps)`` of a case."""
    return (4096, 2, 1) if variant == "sorted_4096" else (SEQ, BATCH, STEPS)


def masked(labels, k: int):
    """``labels`` (numpy) with a seeded share of the first batch row's
    masked (step ``k``'s draw)."""
    rng = np.random.default_rng([MASK_SEED, k])
    out = labels.copy()
    out[0, rng.random(out.shape[1]) < MASK_SHARE] = -100
    return out


JAX_SIDE = textwrap.dedent(f"""
    import dataclasses, pickle, sys
    import jax, numpy as np
    from jax.sharding import AxisType
    from repro.configs.registry import get_smoke_config
    from repro.models.sharding import param_shardings, set_activation_mesh
    from repro.training.data import DataConfig, batch_at
    from repro.training.optimizer import AdamW, AdamWState
    from repro.training.train_step import init_state, make_train_step

    def masked(labels, k):
        rng = np.random.default_rng([{MASK_SEED}, k])
        out = labels.copy()
        out[0, rng.random(out.shape[1]) < {MASK_SHARE}] = -100
        return out

    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    set_activation_mesh(mesh)
    out = {{}}
    cases = ([(a, c, None) for a, c in {JAX_CASES!r}]
             + [(a, False, v) for a, v in {VARIANTS!r}])
    for arch, compress, variant in cases:
        cfg = get_smoke_config(arch)
        if variant and variant.startswith("sorted"):
            cfg = dataclasses.replace(cfg, moe_dispatch="sorted",
                                      moe_capacity_factor=1.0)
        seq, batch, steps = (4096, 2, 1) if variant == "sorted_4096" else (
            {SEQ}, {BATCH}, {STEPS})
        opt = AdamW(lr={JAX_LR})
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=batch, seed=0)
        s = init_state(cfg, opt, jax.random.key(0), compress=compress)
        init = jax.tree.map(np.asarray, s)
        p_sh = param_shardings(mesh, jax.eval_shape(lambda: s.params))
        put = lambda t: jax.device_put(t, p_sh)
        s = s._replace(params=put(s.params), opt=AdamWState(
            step=s.opt.step, m=put(s.opt.m), v=put(s.opt.v)))
        step = jax.jit(make_train_step(cfg, opt, compress=compress))
        metrics = []
        for k in range(steps):
            b = batch_at(dcfg, k)
            if variant == "masked":
                b = dict(b, labels=masked(np.asarray(b["labels"]), k))
            s, m = step(s, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[(arch, variant or compress)] = (
            init, jax.tree.map(np.asarray, s), metrics)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's sharded step, 3 steps per case, run once on 8 forced host
    devices in a subprocess."""
    path = tmp_path_factory.mktemp("mesh_train") / "out.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, str(path)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dcfg(cfg, batch=BATCH, seq=SEQ):
    return tdata.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0,
        frontend_len=cfg.frontend_len if cfg.frontend else 0,
        d_model=cfg.d_model)


def bits(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def same_state(a, b) -> bool:
    """Two states bitwise equal, a sharded one gathered whole."""
    la = leaves(tts.unshard_state(a, "cpu"))
    lb = leaves(tts.unshard_state(b, "cpu"))
    return len(la) == len(lb) and all(bits(x) == bits(y)
                                      for x, y in zip(la, lb))


def run(step, state, batches):
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append((bits(m["loss"]), bits(m["grad_norm"]),
                        int(m["step"]), float(m["loss"]),
                        float(m["grad_norm"])))
    return state, metrics


def within_bar(on, m_on, one, m_one, compress, lr):
    """``on`` (a sharded state) within the JAX comparison's bar of
    ``one``: loss and grad_norm 1e-5 relative (1e-4 for grad_norm with
    compression), every parameter within 2 lr k after k steps."""
    for a, b in zip(m_on, m_one):
        assert a[2] == b[2]
        assert abs(a[3] - b[3]) <= 1e-5 * abs(b[3])
        assert abs(a[4] - b[4]) <= (1e-4 if compress else 1e-5) * abs(b[4])
    got = leaves(tts.unshard_state(on, "cpu").params)
    for g, w in zip(got, leaves(one.params)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert float((g.double() - w.double()).abs().max()) <= (
            2 * lr * len(m_on))


# ---------------------------------------------------------------------------
# bitwise the one-device step at accum * D
# ---------------------------------------------------------------------------

MESH_CASES = [(arch, compress, "2x4", accum)
              for arch in ("glm4-9b", "mixtral-8x22b", "rwkv6-1.6b")
              for compress in (False, True) for accum in (1,)] + [
    ("glm4-9b", False, "2x4", 2), ("mixtral-8x22b", True, "2x2x2", 1),
    ("qwen3-0.6b", False, "2x4", 1), ("starcoder2-7b", False, "2x4", 1),
    ("rwkv6-1.6b", False, "2x3", 1), ("rwkv6-1.6b", True, "2x3", 1)]


def mesh_of(name, devices=CPU8):
    if name == "2x4":
        return make_debug_mesh(2, 4, devices)
    if name == "2x3":
        return make_debug_mesh(2, 3, devices[:6])
    return make_mesh((2, 2, 2), ("pod", "data", "model"), devices)


@pytest.mark.parametrize("arch,compress,mesh_name,accum", MESH_CASES)
def test_mesh_step_is_bitwise_the_one_device_step(arch, compress, mesh_name,
                                                  accum, one_thread):
    """Bitwise the one-device step at accum * D where no product splits
    (rwkv6 on (2, 3): no ``model`` copy composed); where products split
    (glm4, mixtral, rwkv6 on (2, 4)) their three bars."""
    cfg = treg.SMOKES[arch]
    mesh = mesh_of(mesh_name)
    D = len(tts.data_rows(mesh))
    batch = 2 * accum * D
    split = tts.mesh_step_moves(cfg, mesh, accum, batch,
                                16).model.positions > 0
    assert split == (mesh_name != "2x3")
    lr, seq = (JAX_LR, SEQ) if split and arch == "rwkv6-1.6b" else (LR, 16)
    opt = topt.AdamW(lr=lr)
    state = tts.init_state(cfg, opt, torch.Generator().manual_seed(0),
                           compress=compress)
    batches = [tdata.batch_at(dcfg(cfg, batch=batch, seq=seq), k,
                              device="cpu") for k in range(STEPS)]
    one, m_one = run(tts.make_train_step(cfg, opt, compress=compress,
                                         accum=accum * D), state, batches)
    placed = tts.shard_state(state, mesh)
    assert all(isinstance(x, Sharded) for x in leaves(placed.params))
    assert same_state(placed, state)
    step = tts.make_train_step(cfg, opt, compress=compress, accum=accum)
    on, m_on = run(step, placed, batches)
    if split:
        again, m_again = run(step, placed, batches)
        assert m_again == m_on and same_state(again, on)
        alt = mesh_of(mesh_name, ["cpu", "cpu:0"] * 4)
        moved, m_moved = run(step, tts.shard_state(state, alt), batches)
        assert m_moved == m_on and same_state(moved, on)
        within_bar(on, m_on, one, m_one, compress, lr)
    else:
        assert m_on == m_one
        assert same_state(on, one)
    assert all(isinstance(x, Sharded) for x in leaves(on.opt.m))
    assert (on.err is None) == (not compress)
    # each position holds only its shards
    sh = leaves(param_shardings(mesh, state.params))
    for p, s in zip(leaves(on.params), sh):
        assert p.sharding == s
        assert all(tuple(t.shape) == s.shard_shape(p.shape)
                   for t in p.shards)


def test_mesh_step_counts_the_bytes_it_moves(one_thread):
    """glm4 on a (2, 4) mesh, both rows on the CPU (nothing crosses a
    device), 2 rows of 16 tokens a data row:

    * gather, each period's forward and recomputation: the split leaves
      (``wq``, ``wo`` and the MLP's, ``(data, model)`` or ``(model,
      data)``) the other data block of each position's slice; ``wk`` and
      ``wv`` (one kv head, 4 query heads: each position's one query head
      shares it) whole at every position, 7 of 8 blocks; the norms
      (replicated) and the vocabulary slices (``(model, None)``) nothing;
    * reduce: every piece but the first position's goes there: a split
      leaf's 8 slices of a quarter, ``wk``/``wv`` whole from 8 positions,
      the norms whole from the second row's first position;
    * scatter: the reduced gradient to the 7 other positions;
    * model: at each of the 3 other positions of each row, a split
      sublayer's input out and partial back in the forward, the
      recomputation and the backward pass, the positions twice an
      attention, the tokens and the looked-up rows (and their gradient),
      and the head's input (and its gradient), labels, each slice's
      logsumexp and gold logits (and theirs)."""
    cfg = treg.SMOKES["glm4-9b"]
    opt = topt.AdamW(lr=LR)
    mesh = make_debug_mesh(2, 4, CPU8)
    state = tts.shard_state(tts.init_state(
        cfg, opt, torch.Generator().manual_seed(0)), mesh)
    batch = tdata.batch_at(dcfg(cfg, seq=16), 0, device="cpu")
    _, m = tts.make_train_step(cfg, opt, accum=1)(state, batch)
    moved = m["moved"]
    ps = state.params
    blocks = ps["blocks"]["l0"]

    def nbytes(s):
        return int(np.prod(s.shape)) * s.shards[0].element_size()

    part = [blocks["attn"]["wq"], blocks["attn"]["wo"]] + list(
        blocks["ffn"].values())
    kv = [blocks["attn"]["wk"], blocks["attn"]["wv"]]
    norms = [blocks["ln1"], blocks["ln2"], ps["final_ln"]]
    vocab = [ps["embed"], ps["lm_head"]]
    assert all(p.sharding.spec[1:] in (P("data", "model"), P("model", "data"))
               for p in part + kv)
    assert moved.gather == MoveStats(
        2 * sum(nbytes(p) for p in part)
        + 2 * 2 * 4 * 7 * sum(p.position_bytes() for p in kv), 0)
    assert moved.reduce == MoveStats(
        sum(nbytes(p) * 7 // 4 for p in part + vocab)
        + sum(nbytes(p) * 7 for p in kv) + sum(nbytes(p) for p in norms), 0)
    assert moved.scatter == MoveStats(7 * sum(p.position_bytes()
                                              for p in leaves(ps)), 0)
    assert moved.relayout == MoveStats(0, 0)
    T, f32, tok = 2 * 16, 4, 4
    act = T * cfg.d_model * f32
    per = (6 * act * 2 * cfg.n_periods + 2 * 16 * 8 * cfg.n_periods
           + T * tok + 2 * act + 2 * act + T * tok + 4 * T * f32)
    assert moved.model == MoveStats(2 * 3 * per, 0)


def test_grad_shardings_relayout_and_need_a_mesh(one_thread):
    """``grad_shardings`` (here: replicated everywhere) hold the reduced
    gradient before the update; it is then laid out as the parameters
    are, bytes counted, and the step's result does not change.  Without
    a mesh ``grad_shardings`` raise."""
    cfg = treg.SMOKES["glm4-9b"]
    opt = topt.AdamW(lr=LR)
    mesh = make_debug_mesh(2, 4, CPU8)
    state = tts.init_state(cfg, opt, torch.Generator().manual_seed(0))
    placed = tts.shard_state(state, mesh)
    batch = tdata.batch_at(dcfg(cfg, seq=16), 0, device="cpu")
    rep = {k: v for k, v in param_shardings(mesh, state.params).items()}

    def replicated(tree):
        if isinstance(tree, dict):
            return {k: replicated(v) for k, v in tree.items()}
        return NamedSharding(mesh, P())

    rep = replicated(rep)
    a, ma = tts.make_train_step(cfg, opt, accum=1)(placed, batch)
    b, mb = tts.make_train_step(cfg, opt, accum=1,
                                grad_shardings=rep)(placed, batch)
    assert same_state(a, b)
    assert mb["moved"].relayout.positions == 0  # a replica holds it all
    assert mb["moved"].scatter.positions > ma["moved"].scatter.positions
    with pytest.raises(ValueError, match="mesh"):
        tts.make_train_step(cfg, opt, grad_shardings=rep)(state, batch)
    with pytest.raises(ValueError, match="does not split"):
        tts.make_train_step(cfg, opt, accum=3)(placed, batch)


# ---------------------------------------------------------------------------
# against JAX's sharded step
# ---------------------------------------------------------------------------

def keep_of(idx, E: int, C: int):
    """The assignments of routes ``idx`` ``(N, k)`` a stable sort by
    expert over their flat order keeps at capacity ``C`` (JAX's
    ``_moe_sorted_block``'s rule), in that order."""
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    se = flat[order]
    rank = torch.arange(se.numel()) - torch.searchsorted(se, se)
    keep = torch.empty_like(flat, dtype=torch.bool)
    keep[order] = rank < C
    return keep


def first_routes(cfg, params, tokens):
    """The routes of the first MoE layer's first chunk (at most 2048
    positions) at ``params`` (one device) for ``tokens``."""
    from repro_torch.models import lm
    from repro_torch.models.attention import attn_train
    from repro_torch.models.layers import rms_norm

    p = {k: v[0] for k, v in params["blocks"]["l0"].items()
         if not isinstance(v, dict)}
    sub = {n: {k: v[0] for k, v in params["blocks"]["l0"][n].items()}
           for n in ("attn", "ffn")}
    x = params["embed"][tokens]
    y, _ = attn_train(sub["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                      torch.arange(x.shape[1]), lm.attn_spec(cfg))
    h2 = rms_norm(x + y, p["ln2"], cfg.norm_eps)[:, :2048]
    logits = h2.reshape(-1, cfg.d_model).float() @ sub["ffn"]["router"]
    return torch.topk(logits, cfg.experts_per_token, dim=-1).indices


JAX_PARAMS = ([pytest.param(a, c, None, id=f"{a}-{c}") for a, c in JAX_CASES]
              + [pytest.param(a, False, v, id=f"{a}-{v}")
                 for a, v in VARIANTS])


@pytest.mark.parametrize("arch,compress,variant", JAX_PARAMS)
def test_mesh_step_matches_jax_sharded_step(jax_runs, arch, compress,
                                           variant, one_thread):
    """The mesh step against JAX's sharded step; besides the cases of
    ``JAX_CASES``, microbatches whose data rows differ (``VARIANTS``):
    masked labels spread unevenly over the rows (the loss is the
    microbatch's sum over its valid labels), and the sorted MoE dispatch
    at capacity factor 1.0, whose sort over the microbatch drops other
    assignments than each row's own sort would."""
    init, want, jmetrics = jax_runs[(arch, variant or compress)]
    cfg = treg.SMOKES[arch]
    if variant and variant.startswith("sorted"):
        cfg = dataclasses.replace(cfg, moe_dispatch="sorted",
                                  moe_capacity_factor=1.0)
    seq, batch, steps = shape_of(variant)
    mesh = make_debug_mesh(2, 4, CPU8)
    state = train_state_from_numpy(init, mesh=mesh)
    assert all(isinstance(x, Sharded) for x in leaves(state.params))
    step = tts.make_train_step(cfg, topt.AdamW(lr=JAX_LR),
                               compress=compress, accum=1)
    batches = [tdata.batch_at(dcfg(cfg, batch, seq), k, device="cpu")
               for k in range(steps)]
    if variant == "masked":
        for k, b in enumerate(batches):
            b["labels"] = torch.as_tensor(masked(b["labels"].numpy(), k))
        valid = (batches[0]["labels"] != -100).reshape(2, -1).sum(-1)
        assert valid[0] < valid[1]
    for k in range(steps):
        state, m = step(state, batches[k])
        jl, jg = jmetrics[k]
        assert abs(float(m["loss"]) - jl) <= 1e-5 * abs(jl), k
        assert abs(float(m["grad_norm"]) - jg) <= (
            1e-4 if compress else 1e-5) * abs(jg), k
    got = train_state_to_numpy(state)
    bc2 = 1 - 0.95 ** steps
    for g, w, v in zip(leaves(got.params), leaves(want.params),
                       leaves(want.opt.v)):
        assert g.dtype == w.dtype and g.shape == w.shape
        d = np.abs(g.astype(np.float64) - w)
        assert d.max() <= 2 * JAX_LR * steps + 1e-7
        sv = np.sqrt(v / bc2)
        above = sv >= NOISE * sv.max()
        if not compress and arch in TIGHT_ARCHS and above.any():
            assert d[above].max() <= TIGHT * JAX_LR
    for tree, n in (("m", steps / 127), ("v", 2 * steps / 127)):
        bound = 2e-4 + (n if compress else 0.0)
        for g, w in zip(leaves(getattr(got.opt, tree)),
                        leaves(getattr(want.opt, tree))):
            assert (np.abs(g.astype(np.float64) - w).max()
                    <= bound * max(np.abs(w).max(), 1e-30)), tree
    if compress:
        for g, w in zip(leaves(got.err), leaves(want.err)):
            assert np.abs(g - w).max() <= 2.5 * np.abs(w).max() + 1e-12
    if variant and variant.startswith("sorted"):
        # the case exposes a per-row sort: at the first step's first MoE
        # layer, sorting each data row's half apart keeps other
        # assignments than the microbatch's sort
        one = lm_params_from_numpy(init.params, device="cpu")
        idx = first_routes(cfg, one, batches[0]["tokens"])
        E, k = cfg.n_experts, cfg.experts_per_token

        def capacity(n):   # JAX's C at capacity factor 1.0
            return int(n * k / E + 0.999)

        whole = keep_of(idx, E, capacity(idx.shape[0]))
        half = idx.shape[0] // 2
        rows = torch.cat([keep_of(h, E, capacity(half))
                          for h in (idx[:half], idx[half:])])
        assert (~whole).any() and not torch.equal(whole, rows)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

SMOKE = ["--device", "cpu", "--arch", "qwen3-0.6b", "--smoke"]
MESH = ["--mesh", "2,4", "--mesh-devices", ",".join(CPU8)]


def launch(*args):
    lines = []
    tlaunch.main(SMOKE + list(args), log=lines.append)
    return lines


def npz(path):
    with np.load(path / "shard-0.npz") as z:
        return {k: z[k].tobytes() for k in z.files}


def params_of(path) -> list:
    """The parameter leaves of a (float32) checkpoint, by its manifest."""
    with open(path / "manifest.json") as f:
        meta = json.load(f)
    with np.load(path / "shard-0.npz") as z:
        return [z[leaf["key"]] for leaf in meta["leaves"]
                if leaf["path"].startswith(".params")]


def test_launcher_resumes_across_meshes(tmp_path, one_thread):
    """qwen3 (dense: its mesh step computes split products).  A mesh run
    to step 2 resumed on the mesh to step 4 is bitwise an uninterrupted
    mesh run, and its step 2 bitwise that run's; an unsharded run to step
    2 resumed on the mesh, the mesh run resumed unsharded and the
    uninterrupted mesh run are each, at step 4, within the bar of an
    unsharded run at ``--accum 2`` (the mesh's 2 data rows at accum 1):
    every parameter within 2 lr k of its."""
    whole, mesh, a, b, c = (tmp_path / x for x in
                            ("whole", "mesh", "a", "b", "c"))
    launch("--steps", "4", "--accum", "2", "--ckpt", str(whole),
           "--ckpt-every", "2")
    out = launch("--steps", "4", "--ckpt", str(mesh), "--ckpt-every", "2",
                 *MESH)
    assert out[-1] == "done"
    launch("--steps", "2", "--accum", "2", "--ckpt", str(a),
           "--ckpt-every", "2")
    out = launch("--steps", "4", "--ckpt", str(a), "--ckpt-every", "2",
                 *MESH)
    assert out[0] == "resumed from step 2" and out[-1] == "done"
    launch("--steps", "2", "--ckpt", str(b), "--ckpt-every", "2", *MESH)
    shutil.copytree(b, c)
    out = launch("--steps", "4", "--accum", "2", "--ckpt", str(b),
                 "--ckpt-every", "2")
    assert out[0] == "resumed from step 2"
    out = launch("--steps", "4", "--ckpt", str(c), "--ckpt-every", "2",
                 *MESH)
    assert out[0] == "resumed from step 2"
    assert npz(b / "step-2") == npz(mesh / "step-2")
    assert npz(c / "step-4") == npz(mesh / "step-4")
    assert npz(a / "step-2") == npz(whole / "step-2")
    ref = params_of(whole / "step-4")
    bound = 2 * JAX_LR * 4   # the launcher's lr (AdamW()'s), 4 steps
    for run_dir in (a, b, mesh):
        got = params_of(run_dir / "step-4")
        assert len(got) == len(ref)
        for g, w in zip(got, ref):
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
            assert np.abs(g.astype(np.float64) - w).max() <= bound
    assert npz(mesh / "step-4") != npz(whole / "step-4")


def test_launcher_mesh_needs_its_devices():
    with pytest.raises(ValueError, match="needs 8 devices, have 1"):
        launch("--steps", "1", "--mesh", "2,4")
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        launch("--steps", "1", "--mesh", "2,4", "--mesh-devices",
               "cpu,cpu,cpu,cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            launch("--steps", "1", "--mesh", "1,1", "--mesh-devices",
                   "cuda:0")
