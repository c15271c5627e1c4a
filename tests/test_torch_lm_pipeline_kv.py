"""The GPipe forward and the KV-cache repartition on a device mesh, against
the JAX package's, on the CPU.

The JAX side runs once for the module in a subprocess with 8 forced host
devices and Auto-axis meshes (as tests/test_torch_full_mesh.py runs JAX)
and hands back numpy arrays.  The port's meshes name the CPU 8 times.

* ``pipelined_forward`` on a (pod 2, data 2, model 2) mesh for
  granite-3-8b SMOKE (JAX's case in tests/test_distributed.py) and
  qwen3-0.6b SMOKE, from JAX's ``init_params`` (key 0) and tokens from
  ``default_rng(0)``: within 1e-5 of JAX's pipelined output (relative to
  its largest |value|, the LM tests' float32 bar), and bitwise the port's
  ``hidden_states`` run per (microbatch, data row) slice and concatenated.
* ``repartition_cache`` (``KVRepartitionPlan.build(8, 8, 4)`` on a (2, 4)
  mesh; K/V leaves (2, 8, 16, 2, 4) and a 3-D state leaf from
  ``default_rng(0)``, laid out by ``fine_spec``) under both schedules:
  JAX's output values and every position's shard shape and slice, the
  identity bitwise, and the bytes moved between positions equal to the
  count derived from the two specs (``host_buffer`` at least
  ``device_direct``'s).
"""
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch.mesh import make_debug_mesh, make_mesh
from repro_torch.models import lm as tlm
from repro_torch.models.sharding import (MoveStats, NamedSharding, P,
                                         shard, unshard)
from repro_torch.serving.repartition_kv import (KVRepartitionPlan,
                                                repartition_cache)
from repro_torch.training.pipeline import pipelined_forward, split_periods

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8
PIPE_ARCHS = ("granite-3-8b", "qwen3-0.6b")
PIPE_MICRO = {"granite-3-8b": 2, "qwen3-0.6b": 4}
TOKENS = (8, 16)
SCHEDULES = ("device_direct", "host_buffer")
KV_SHAPE, STATE_SHAPE = (2, 8, 16, 2, 4), (2, 8, 64)
PARITY = 1e-5

JAX_SIDE = textwrap.dedent(f"""
    import pickle, sys
    import jax, numpy as np, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from jax.sharding import PartitionSpec as P
    from repro.configs.registry import get_smoke_config
    from repro.models import lm
    from repro.serving.repartition_kv import (KVRepartitionPlan,
                                              repartition_cache)
    from repro.training.pipeline import pipelined_forward

    auto = lambda n: (AxisType.Auto,) * n
    out = {{"pipe": {{}}, "kv": {{}}}}
    mesh3 = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                          axis_types=auto(3))
    for arch, n_micro in {PIPE_MICRO!r}.items():
        cfg = get_smoke_config(arch)
        params = lm.init_params(cfg, jax.random.key(0))
        rng = np.random.default_rng(0)
        tokens = np.asarray(rng.integers(0, cfg.vocab_size, {TOKENS!r}),
                            np.int32)
        y = pipelined_forward(cfg, params, jnp.asarray(tokens), mesh=mesh3,
                              n_micro=n_micro)
        out["pipe"][arch] = (jax.tree.map(np.asarray, params), tokens,
                             np.asarray(y))

    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=auto(2))
    plan = KVRepartitionPlan.build(batch=8, n_fine=8, alpha=4)
    rng = np.random.default_rng(0)
    k = np.asarray(rng.standard_normal({KV_SHAPE!r}), np.float32)
    st = np.asarray(rng.standard_normal({STATE_SHAPE!r}), np.float32)
    fine = NamedSharding(mesh, plan.fine_spec())
    fine3 = NamedSharding(mesh, P(None, ("data", "model"), None))
    out["kv_in"] = (k, st)
    pos = {{d.id: idx for idx, d in np.ndenumerate(mesh.devices)}}
    for schedule in ("device_direct", "host_buffer"):
        go = jax.jit(lambda k, v, s: repartition_cache(
            plan, mesh, {{"k": k, "v": v, "last": s}}, schedule),
            in_shardings=(fine, fine, fine3))
        res = go(jnp.asarray(k), jnp.asarray(k) + 1, jnp.asarray(st))
        leaves = {{}}
        for name, arr in res.items():
            shards = {{pos[s.device.id]: (s.data.shape,
                                         [(i.start or 0, i.stop) for i in
                                          s.index])
                      for s in arr.addressable_shards}}
            leaves[name] = (np.asarray(arr), shards,
                            tuple(arr.sharding.spec))
        out["kv"][schedule] = leaves
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    import pickle

    path = tmp_path_factory.mktemp("pipe_kv") / "out.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, str(path)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(path, "rb") as f:
        return pickle.load(f)


def mesh3():
    return make_mesh((2, 2, 2), ("pod", "data", "model"), CPU8)


def per_slice(cfg, params, tokens, n_micro, D):
    """``hidden_states`` run on each (microbatch, data row) slice, in
    order, and concatenated."""
    b = tokens.shape[0] // n_micro // D
    return torch.cat([tlm.hidden_states(cfg, params, tokens[j * b:(j + 1) * b])
                      for j in range(n_micro * D)], 0)


# ---------------------------------------------------------------------------
# the GPipe forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PIPE_ARCHS)
def test_pipelined_forward_matches_jax_and_is_bitwise_per_slice(ref, arch):
    jparams, tokens, want = ref["pipe"][arch]
    cfg = treg.SMOKES[arch]
    params = lm_params_from_numpy(jparams, device="cpu")
    tokens = torch.from_numpy(tokens)
    n_micro = PIPE_MICRO[arch]
    stats = {}
    got = pipelined_forward(cfg, params, tokens, mesh=mesh3(),
                            n_micro=n_micro, stats=stats)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= PARITY * float(
        np.abs(want).max())
    assert torch.equal(got, per_slice(cfg, params, tokens, n_micro, 2))
    full = tlm.hidden_states(cfg, params, tokens)
    assert float((got - full).abs().max()) <= PARITY * float(
        full.abs().max())
    # one hop a (microbatch, row) slice to stage 1, and back to stage 0
    act = math.prod(TOKENS) * cfg.d_model * 4
    assert stats == {"hop_bytes": act, "hop_device_bytes": 0,
                     "broadcast_bytes": act, "broadcast_device_bytes": 0}


def test_pipeline_over_two_devices_and_errors():
    """A mesh whose pods are ``cpu`` and ``cpu:0`` (two devices to the
    port): every hop crosses; the result is unchanged.  A stack that does
    not split into the stages, or a batch that does not split into the
    microbatches and rows, raises."""
    cfg = treg.SMOKES["granite-3-8b"]
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, TOKENS,
                           generator=torch.Generator().manual_seed(1))
    two = make_mesh((2, 2, 2), ("pod", "data", "model"),
                    ["cpu"] * 4 + ["cpu:0"] * 4)
    stats = {}
    got = pipelined_forward(cfg, params, tokens, mesh=two, n_micro=2,
                            stats=stats)
    assert torch.equal(got, per_slice(cfg, params, tokens, 2, 2))
    assert stats["hop_device_bytes"] == stats["hop_bytes"] > 0
    assert stats["broadcast_device_bytes"] == stats["broadcast_bytes"]
    stages = split_periods(params, 2)
    assert [s["l0"]["ln1"].shape[0] for s in stages] == [1, 1]
    with pytest.raises(ValueError, match="stages"):
        pipelined_forward(cfg, params, tokens, mesh=make_mesh(
            (4, 2, 1), ("pod", "data", "model"), CPU8), n_micro=2)
    with pytest.raises(ValueError, match="does not split"):
        pipelined_forward(cfg, params, tokens, mesh=mesh3(), n_micro=3)


# ---------------------------------------------------------------------------
# the KV-cache repartition
# ---------------------------------------------------------------------------

def trimmed(spec) -> tuple:
    """A spec without its trailing ``None``s (JAX drops them from a
    computed result's spec)."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def spec_bytes(src: NamedSharding, dst: NamedSharding, shape, item) -> int:
    """Each position's destination slice less what it already holds."""
    total = 0
    for c in src.mesh.positions():
        d, s = dst.box(c, shape), src.box(c, shape)
        inter = math.prod(max(0, min(a1, b1) - max(a0, b0))
                          for (a0, a1), (b0, b1) in zip(d, s))
        total += (math.prod(hi - lo for lo, hi in d) - inter) * item
    return total


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_repartition_cache_matches_jax(ref, schedule):
    k, st = ref["kv_in"]
    mesh = make_debug_mesh(2, 4, CPU8)
    plan = KVRepartitionPlan.build(batch=8, n_fine=8, alpha=4)
    fine = NamedSharding(mesh, plan.fine_spec())
    fine3 = NamedSharding(mesh, P(None, ("data", "model"), None))
    kt, stt = torch.from_numpy(k), torch.from_numpy(st)
    cache = {"k": shard(kt, fine), "v": shard(kt + 1, fine),
             "last": shard(stt, fine3)}
    stats = {}
    out = repartition_cache(plan, mesh, cache, schedule, stats=stats)
    want = ref["kv"][schedule]
    for name, src in (("k", kt), ("v", kt + 1), ("last", stt)):
        values, shards, spec = want[name]
        got = out[name]
        assert torch.equal(unshard(got, "cpu"), src)          # identity
        assert np.array_equal(unshard(got, "cpu").numpy(), values)
        assert trimmed(got.sharding.spec) == trimmed(spec)
        for idx, c in enumerate(mesh.positions()):
            shape, box = shards[c]
            assert tuple(got.shards[idx].shape) == tuple(shape), (name, c)
            assert [tuple(b) for b in got.sharding.box(c, got.shape)] == [
                (lo, hi if hi is not None else n)
                for (lo, hi), n in zip(box, got.shape)], (name, c)
    assert out["k"].sharding.spec == plan.coarse_spec()
    staged = NamedSharding(mesh, P(None, "data", None, None, None))
    coarse = NamedSharding(mesh, plan.coarse_spec())
    kv = (spec_bytes(fine, coarse, KV_SHAPE, 4) if schedule == "device_direct"
          else spec_bytes(fine, staged, KV_SHAPE, 4)
          + spec_bytes(staged, coarse, KV_SHAPE, 4))
    last = spec_bytes(fine3, NamedSharding(mesh, P(None, "data", None)),
                      STATE_SHAPE, 4)
    assert stats["moved"] == MoveStats(2 * kv + last, 0)
    assert stats["moved"].positions > 0


def test_host_buffer_moves_at_least_device_direct_and_errors():
    mesh = make_debug_mesh(2, 4, CPU8)
    plan = KVRepartitionPlan.build(batch=8, n_fine=8, alpha=4)
    x = torch.randn(KV_SHAPE, generator=torch.Generator().manual_seed(0))
    cache = {"l0": {"k": shard(x, NamedSharding(mesh, plan.fine_spec()))}}
    moved = {}
    for schedule in SCHEDULES:
        stats = {}
        out = repartition_cache(plan, mesh, cache, schedule, stats=stats)
        assert torch.equal(unshard(out["l0"]["k"], "cpu"), x)
        moved[schedule] = stats["moved"].positions
    # a position keeps a quarter of its row from the fine layout; the
    # staged layout gathers 4 rows at each position first
    assert moved["device_direct"] == x.numel() * 4 * 3 // 4
    assert moved["host_buffer"] == x.numel() * 4 * 3
    with pytest.raises(ValueError, match="unknown schedule"):
        repartition_cache(plan, mesh, cache, "carrier_pigeon")
    with pytest.raises(ValueError, match="Sharded"):
        repartition_cache(plan, mesh, {"k": x})
    other = make_debug_mesh(2, 4, ["cpu:0"] * 8)
    with pytest.raises(ValueError, match="Sharded"):
        repartition_cache(plan, other, cache)
