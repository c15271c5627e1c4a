"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's, on the CPU.

JAX's ``launch/dryrun.py`` compiles each cell; here it is only imported:
its text tools (``parse_collectives``, ``_shape_bytes``) run on fixed HLO
texts, and its ``build_lowerable`` builds each cell's arguments and
shardings on Auto-axis ``AbstractMesh``es of the production shapes (jax
0.9.0's ``make_mesh`` builds Explicit axes, on which the JAX LM code
fails; ROADMAP C).  Importing it sets ``XLA_FLAGS`` to 512 forced host
devices, so the backend is initialised first and the variable restored
after.  Both packages' ``set_activation_mesh``/``set_sp_outputs`` are
module globals, reset after each test.

For all 80 (arch x shape x mesh) cells the port's record equals what is
composed from JAX's ``build_lowerable`` and ``launch/analysis.py``:
``status``, ``reason``, ``n_devices``, ``argument_size_in_bytes`` (every
argument leaf's ``shard_shape`` times its itemsize) and the analytical
fields.  The composed ``moves`` equal the ``MeshStepStats`` a real mesh
train step counts (parameters gathered a period at a time, the dense, moe
and hybrid families' products split over ``model``; a microbatch over the
data rows ``_fit`` gives it; the sorted MoE dispatch's split experts and
its per-expert counts between a microbatch's rows, ``routes``), and at
18b's configuration of ``chip_smoke.py`` the bytes the card measured;
JAX's hillclimbed sorted cell (phi3.5-moe ``train_4k``) composes on both
production meshes through ``run_cell(..., cfg=)``.  Then the command line
and ``benchmarks/roofline.py``'s ``derive`` on a port record.
"""
import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

from repro.configs import registry as jreg
from repro.launch import analysis as janalysis
from repro.models import sharding as jsh
from repro_torch.configs import registry as treg
from repro_torch.launch import dryrun as tdry
from repro_torch.launch.mesh import DeviceMesh, make_mesh
from repro_torch.models import lm as tlm
from repro_torch.models import sharding as tsh
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.config import validate
from repro_torch.models.sharding import MoveStats, NamedSharding, P
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts
from repro_torch.training.tree import leaves, unflatten

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(treg.ARCHS)
SHAPES = sorted(treg.SHAPES)
MESH_KINDS = ("single_pod", "multi_pod")
PRODUCTION = {"single_pod": ((16, 16), ("data", "model")),
              "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def jdry():
    """JAX's ``repro.launch.dryrun``, imported with ``XLA_FLAGS`` kept."""
    jax.devices()   # the backend first: the import sets 512 host devices
    with pytest.MonkeyPatch.context() as mp:
        if "XLA_FLAGS" in os.environ:
            mp.setenv("XLA_FLAGS", os.environ["XLA_FLAGS"])
        else:
            mp.delenv("XLA_FLAGS", raising=False)
        mod = importlib.import_module("repro.launch.dryrun")
    return mod


@pytest.fixture(autouse=True)
def reset_activation_globals():
    yield
    for mod in (jsh, tsh):
        mod.set_activation_mesh(None)
        mod.set_sp_outputs(False)


def jmesh(kind):
    shape, names = PRODUCTION[kind]
    return AbstractMesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))


def walk(tree, path=()) -> dict:
    """``{path: leaf}`` over dicts and tuples (named tuples by index);
    ``None`` is a leaf."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(walk(v, path + (k,)))
        return out
    if isinstance(tree, tuple):
        out = {}
        for i, v in enumerate(tree):
            out.update(walk(v, path + (i,)))
        return out
    return {path: tree}


def norm(spec) -> tuple:
    """A spec's entries, a one-name tuple as the name (JAX's P equates
    them)."""
    out = []
    for e in spec:
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(tuple(e) if isinstance(e, tuple) else e)
    return tuple(out)


def jax_argument_bytes(args, shardings) -> int:
    a, s = walk(args), walk(shardings)
    assert a.keys() == s.keys()
    return sum(math.prod(s[k].shard_shape(v.shape))
               * np.dtype(v.dtype).itemsize
               for k, v in a.items() if v is not None)


def jax_record(jdry, arch, shape, kind) -> dict:
    """The keys of JAX's record the port keeps, composed from JAX's
    ``build_lowerable`` (argument bytes from ``shard_shape``) and
    ``launch/analysis.py``."""
    rec = {"arch": arch, "shape": shape, "mesh": kind, "status": "ok"}
    skip = jreg.cell_is_skipped(arch, shape)
    if skip:
        return dict(rec, status="skipped", reason=skip)
    mesh = jmesh(kind)
    _, args, shardings, _, _ = jdry.build_lowerable(arch, shape, mesh)
    cfg = jreg.get_config(arch)
    fr = janalysis.analytical_flops(cfg, shape)
    return dict(rec, argument_size_in_bytes=jax_argument_bytes(
        args, shardings), n_devices=mesh.size,
        analytical_flops_global=fr.total, analytical_flops_ideal=fr.ideal,
        model_flops_6nd=fr.model_flops_6nd,
        analytical_bytes_global=janalysis.analytical_bytes(cfg, shape))


# ---------------------------------------------------------------------------
# the text tools
# ---------------------------------------------------------------------------

HLO_TEXTS = {
    "every_kind": """\
  %all-gather.1 = bf16[16,1024]{1,0} all-gather(bf16[1,1024]{1,0} %p0), replica_groups={{0,1}}, dimensions={0}
  %all-reduce.2 = f32[256]{0} all-reduce(f32[256]{0} %x), to_apply=%add
  %reduce-scatter.3 = f32[16]{0} reduce-scatter(f32[256]{0} %y), dimensions={0}
  %all-to-all.4 = s32[8,8]{1,0} all-to-all(s32[8,8]{1,0} %z), dimensions={0}
  %collective-permute.5 = u8[64]{0} collective-permute(u8[64]{0} %w), source_target_pairs={{0,1}}
""",
    "start_done_pairs": """\
  %all-gather-start.1 = (bf16[1,1024]{1,0}, bf16[16,1024]{1,0}) all-gather-start(bf16[1,1024]{1,0} %p0), dimensions={0}
  %all-gather-done.1 = bf16[16,1024]{1,0} all-gather-done((bf16[1,1024]{1,0}, bf16[16,1024]{1,0}) %all-gather-start.1)
  %all-reduce-start = f32[4]{0} all-reduce-start(f32[4]{0} %a), to_apply=%add
  %all-reduce-done = f32[4]{0} all-reduce-done(f32[4]{0} %all-reduce-start)
  %collective-permute-start.2 = (f64[2,2]{1,0}, f64[2,2]{1,0}, u32[], u32[]) collective-permute-start(f64[2,2]{1,0} %b), source_target_pairs={{0,1}}
  %collective-permute-done.2 = f64[2,2]{1,0} collective-permute-done((f64[2,2]{1,0}, f64[2,2]{1,0}, u32[], u32[]) %collective-permute-start.2)
""",
    "root_and_tuple_results": """\
ENTRY %main.10 (a: f32[8], b: bf16[2,3]) -> (f32[8], bf16[2,3]) {
  %a = f32[8]{0} parameter(0)
  ROOT %all-reduce.9 = (f32[8]{0}, bf16[2,3]{1,0}) all-reduce(f32[8]{0} %a, bf16[2,3]{1,0} %b), to_apply=%add
}
  ROOT all-to-all.3 = (s8[4,4]{1,0}, pred[4]{0}) all-to-all(s8[4,4]{1,0} %c, pred[4]{0} %d), dimensions={0}
  ROOT %reduce-scatter.7 = c64[2,2]{1,0} reduce-scatter(c64[4,2]{1,0} %e), dimensions={0}
""",
    "every_dtype": """\
  %all-gather.7 = (f64[2], f32[2], f16[2], bf16[2], f8e4m3[3], f8e5m2[3], s64[1], s32[], s16[5], s8[5], u64[1], u32[2,2], u16[7], u8[9], pred[11], c64[1], c128[2]) all-gather(f64[1] %q), dimensions={0}
""",
    "no_collective": """\
HloModule jit_step, entry_computation_layout={(f32[128]{0})->f32[128]{0}}
  %add.1 = f32[128]{0} add(f32[128]{0} %a, f32[128]{0} %b)
  %fusion.2 = pred[] fusion(s64[3]{0} %c), kind=kLoop, calls=%fused
  %all-gather-ish = this line has no op call
  %custom-call.3 = f32[4]{0} custom-call(f32[4]{0} %d), custom_call_target="all-reduce"
""",
    "empty": "",
}


@pytest.mark.parametrize("name", list(HLO_TEXTS))
def test_parse_collectives_equals_jax(jdry, name):
    text = HLO_TEXTS[name]
    got = tdry.parse_collectives(text)
    assert got == jdry.parse_collectives(text)
    assert tdry._shape_bytes(text) == jdry._shape_bytes(text)
    for line in text.splitlines():
        assert tdry._shape_bytes(line) == jdry._shape_bytes(line), line
    if name == "every_kind":
        assert got["total_count"] == 5 and all(
            got[op]["count"] == 1 for op in tdry._COLLECTIVES)
        assert got["all-gather"]["bytes"] == 16 * 1024 * 2
    if name == "start_done_pairs":
        # JAX's parser skips a ``-done`` only where the op name ends the
        # match: a ``-done`` whose operand is a tuple (``-done((``) reads
        # as the name ``all-gather-done(`` and counts, as it does here
        assert got["all-reduce"] == {"count": 1, "bytes": 16}
        assert got["all-gather"]["count"] == got[
            "collective-permute"]["count"] == 2
        assert got["total_count"] == 5
    if name in ("no_collective", "empty"):
        assert got["total_count"] == got["total_bytes"] == 0


def test_shape_bytes_reads_every_dtype(jdry):
    assert tdry._DTYPE_BYTES == jdry._DTYPE_BYTES
    assert tdry._COLLECTIVES == jdry._COLLECTIVES
    assert tdry._SHAPE_RE.pattern == jdry._SHAPE_RE.pattern
    for dt, n in tdry._DTYPE_BYTES.items():
        assert tdry._shape_bytes(f"{dt}[3,2]") == 6 * n
        assert tdry._shape_bytes(f"{dt}[]") == n
    assert tdry._shape_bytes("f8e4m3fn[4] f32") == 0


# ---------------------------------------------------------------------------
# build_lowerable and the record, all 80 cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_build_lowerable_and_records_equal_jax(jdry, arch, tmp_path):
    from repro_torch.launch.mesh import make_production_mesh

    for shape in SHAPES:
        for kind in MESH_KINDS:
            tag = (shape, kind)
            rec = tdry.run_cell(arch, shape, kind, str(tmp_path))
            on_disk = json.loads((tmp_path / (
                f"{arch}__{shape}__{kind}.json")).read_text())
            assert on_disk == rec, tag
            want = jax_record(jdry, arch, shape, kind)
            kept = {k: v for k, v in rec.items()
                    if k not in ("moves", "moves_reason", "total_s")}
            assert kept == want, tag
            if rec["status"] == "skipped":
                assert set(rec) == set(want)
                continue
            assert rec["total_s"] >= 0
            assert ("moves" in rec or "moves_reason" in rec) == (
                treg.SHAPES[shape].kind == "train"), tag
            # the step's arguments and shardings, leaf for leaf
            mesh = make_production_mesh(multi_pod=kind == "multi_pod")
            jfn, jargs, jin, jdonate, jout = jdry.build_lowerable(
                arch, shape, jmesh(kind))
            fn, args, ins, donate, out = tdry.build_lowerable(arch, shape,
                                                              mesh)
            assert callable(fn) and donate == jdonate, tag
            ja, ta = walk(jargs), walk(args)
            assert ja.keys() == ta.keys(), tag
            for k, j in ja.items():
                t = ta[k]
                if j is None:
                    assert t is None, (tag, k)
                    continue
                assert t.device.type == "meta", (tag, k)
                assert tuple(t.shape) == tuple(j.shape), (tag, k)
                assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
            for jtree, ttree in ((jin, ins), (jout, out)):
                js, ts = walk(jtree), walk(ttree)
                assert js.keys() == ts.keys(), tag
                for k, j in js.items():
                    if j is None:
                        assert ts[k] is None, (tag, k)
                    else:
                        assert norm(ts[k].spec) == norm(j.spec), (tag, k)
            assert tsh.out_spec() == jsh.out_spec()


def test_skips_and_moves_over_the_whole_grid(tmp_path):
    """80 records: 14 skipped (the 7 full-attention archs' long_500k on
    each mesh), 66 ok; ``moves`` on every ok train cell (mixtral's and
    jamba's 16 rows a microbatch over 2x16x16's 32 data rows too: ``pod``
    dropped), ``moves_reason`` on none; ``model`` bytes for the families
    whose products split."""
    recs = [tdry.run_cell(a, s, k, str(tmp_path)) for a in ARCHS
            for s in SHAPES for k in MESH_KINDS]
    assert len(recs) == len(list(tmp_path.iterdir())) == 80
    status = [r["status"] for r in recs]
    assert status.count("ok") == 66 and status.count("skipped") == 14
    assert not [r for r in recs if "moves_reason" in r]
    train = [r for r in recs if r["shape"].startswith("train")
             and r["status"] == "ok"]
    assert len(train) == 20 and all("moves" in r for r in train)
    for r in recs:
        if "moves" in r:
            mv = r["moves"]
            assert mv["accum"] == treg.ARCHS[r["arch"]].train_accum
            assert mv["schedule"] == tdry.MOVES_SCHEDULE
            # on the production mesh every position is its own chip
            assert all(mv[k]["positions"] == mv[k]["devices"]
                       for k in ("gather", "reduce", "scatter", "relayout",
                                 "model"))
            assert mv["relayout"]["positions"] == 0   # grads as params
            assert mv["gather"]["positions"] > 0
            # the model axis's sums: the dense, moe and hybrid families'
            # split products
            split = treg.ARCHS[r["arch"]].family in tp.SPLIT_FAMILIES
            assert (mv["model"]["positions"] > 0) == split


# ---------------------------------------------------------------------------
# moves: composed against a real mesh step
# ---------------------------------------------------------------------------

def mesh_of(name):
    if name == "2x4":
        return make_mesh((2, 4), ("data", "model"), CPU8)
    if name == "2x2x2":
        return make_mesh((2, 2, 2), ("pod", "data", "model"), CPU8)
    if name == "alternating":   # a row's model positions on two devices
        return make_mesh((2, 4), ("data", "model"), ["cpu", "cpu:0"] * 4)
    # two devices to the port: data row 0 on one, row 1 on the other
    return make_mesh((2, 4), ("data", "model"), ["cpu"] * 4 + ["cpu:0"] * 4)


def regrid(mesh, params):
    """Gradient shardings other than the parameters': the last dim over
    every axis where it divides, else replicated."""
    def spec(p):
        if p.shape[-1] % mesh.size:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, P(*([None] * (p.ndim - 1)),
                                     mesh.axis_names))
    return unflatten(params, [spec(p) for p in leaves(params)])


# (arch, mesh, accum, compress, gradient shardings, parameter dtype):
# bf16 parameters reduce in their dtype and scatter a gradient summed in
# f32; the SMOKE configs' own dtype is f32
MOVE_CASES = [("qwen3-0.6b", "2x4", 1, False, False, "bfloat16"),
              ("qwen3-0.6b", "2x4", 2, True, False, "bfloat16"),
              ("mixtral-8x22b", "2x2x2", 1, True, False, None),
              ("glm4-9b", "two_devices", 2, False, False, "bfloat16"),
              ("rwkv6-1.6b", "two_devices", 1, True, True, None),
              ("whisper-medium", "2x4", 1, False, True, None),
              ("starcoder2-7b", "alternating", 1, False, False, None),
              ("qwen3-0.6b", "alternating", 2, True, True, "bfloat16"),
              ("phi3.5-moe-42b-a6.6b", "two_devices", 2, False, False,
               "bfloat16"),
              ("jamba-v0.1-52b", "alternating", 1, False, False, None),
              ("paligemma-3b", "alternating", 2, False, False, "bfloat16")]


@pytest.mark.parametrize("arch,mesh_name,accum,compress,regridded,dtype",
                         MOVE_CASES)
def test_composed_moves_equal_a_real_mesh_step(arch, mesh_name, accum,
                                               compress, regridded, dtype):
    cfg = treg.SMOKES[arch]
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    mesh = mesh_of(mesh_name)
    D = len(tts.data_rows(mesh))
    opt = topt.AdamW()
    state = tts.init_state(cfg, opt, torch.Generator().manual_seed(0),
                           compress=compress)
    g_sh = regrid(mesh, state.params) if regridded else None
    batch = tdata.batch_at(tdata.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2 * accum * D,
        seed=0, frontend_len=cfg.frontend_len if cfg.frontend else 0,
        d_model=cfg.d_model), 0, device="cpu")
    step = tts.make_train_step(cfg, opt, compress=compress, accum=accum,
                               grad_shardings=g_sh)
    _, m = step(tts.shard_state(state, mesh), batch)
    got = tts.mesh_step_moves(cfg, mesh, accum, 2 * accum * D, 16,
                              grad_shardings=g_sh, compress=compress)
    assert got == m["moved"]
    assert got.reduce.positions > 0 and got.gather.positions > 0
    assert (got.relayout.positions > 0) == regridded
    assert (got.gather.devices > 0) == (mesh_name != "2x4"
                                        and mesh_name != "2x2x2")
    # the model axis's copies: the split families', across devices where
    # a row's positions are on two
    split = cfg.family in tp.SPLIT_FAMILIES
    assert (got.model.positions > 0) == split
    assert (got.model.devices > 0) == (split and mesh_name == "alternating")
    # the step and the composition refuse a batch that 2 microbatches do
    # not split, with one message
    odd = {k: v[:2 * accum * D - 1] for k, v in batch.items()}
    with pytest.raises(ValueError, match="does not split") as e1:
        tts.make_train_step(cfg, opt, compress=compress, accum=2)(
            tts.shard_state(state, mesh), odd)
    with pytest.raises(ValueError, match="does not split") as e2:
        tts.mesh_step_moves(cfg, mesh, 2, 2 * accum * D - 1, 16,
                            compress=compress)
    assert str(e1.value) == str(e2.value) == (
        f"a global batch of {2 * accum * D - 1} does not split into 2 "
        f"microbatches")


# the sorted MoE dispatch at capacity factor 1.0 (phi3.5's 4 experts
# over the two rows' devices: EP; mixtral's over the (2, 2, 2) mesh's 4
# data rows, a microbatch over all 4 rows)
SORTED_MOVE_CASES = [("phi3.5-moe-42b-a6.6b", "two_devices", 2),
                     ("phi3.5-moe-42b-a6.6b", "alternating", 1),
                     ("mixtral-8x22b", "2x2x2", 1)]


@pytest.mark.parametrize("arch,mesh_name,accum", SORTED_MOVE_CASES)
def test_composed_moves_equal_a_sorted_mesh_step(arch, mesh_name, accum):
    """A sorted-dispatch step's bytes composed from the specs equal what
    the step counts: its split experts' gathers and ``model`` copies
    (the input and each assignment's slot out, the partials back), and
    ``routes``, each data row's expert counts to the next row of its
    microbatch in each chunk's forward pass (across devices where the
    rows' first positions are on two)."""
    cfg = dataclasses.replace(treg.SMOKES[arch], moe_dispatch="sorted",
                              moe_capacity_factor=1.0)
    mesh = mesh_of(mesh_name)
    D = len(tts.data_rows(mesh))
    opt = topt.AdamW()
    state = tts.init_state(cfg, opt, torch.Generator().manual_seed(0))
    batch = tdata.batch_at(tdata.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2 * accum * D,
        seed=0), 0, device="cpu")
    _, m = tts.make_train_step(cfg, opt, accum=accum)(
        tts.shard_state(state, mesh), batch)
    got = tts.mesh_step_moves(cfg, mesh, accum, 2 * accum * D, 16)
    assert got == m["moved"]
    E, n_moe = cfg.n_experts, cfg.n_layers
    assert got.routes.positions == accum * n_moe * (D - 1) * E * 8
    assert (got.routes.devices > 0) == (mesh_name == "two_devices")
    dense = tts.mesh_step_moves(treg.SMOKES[arch], mesh, accum,
                                2 * accum * D, 16)
    assert dense.routes == MoveStats() and got.model != dense.model
    assert (got.gather, got.reduce, got.scatter) == (
        dense.gather, dense.reduce, dense.scatter)


def test_composes_the_hillclimbed_sorted_cell(tmp_path):
    """JAX's hillclimbed cell, phi3.5-moe ``train_4k`` with
    ``moe_dispatch="sorted"`` (``benchmarks/hillclimb.py``), through
    ``build_lowerable(..., cfg=)`` and ``run_cell(..., cfg=)`` on both
    production meshes: the same arguments as the registry's cell; the
    same gathers, reduce and scatter (the experts split alike), other
    ``model`` copies, and ``routes``: 8 microbatches x 32 layers x 2
    chunks x (D' - 1) hand-offs of 16 int64 counts, D' 16 on 16x16 (32
    rows a microbatch), 32 on 2x16x16."""
    from repro_torch.launch.mesh import make_production_mesh

    arch = "phi3.5-moe-42b-a6.6b"
    cfg = dataclasses.replace(treg.ARCHS[arch], moe_dispatch="sorted")
    for kind, rows in (("single_pod", 16), ("multi_pod", 32)):
        mesh = make_production_mesh(multi_pod=kind == "multi_pod")
        _, args, sh, _, _ = tdry.build_lowerable(arch, "train_4k", mesh, cfg)
        _, want_args, want_sh, _, _ = tdry.build_lowerable(arch, "train_4k",
                                                           mesh)
        assert (tdry.argument_bytes(args, sh)
                == tdry.argument_bytes(want_args, want_sh))
        rec = tdry.run_cell(arch, "train_4k", kind, str(tmp_path / "s"),
                            cfg=cfg)
        base = tdry.run_cell(arch, "train_4k", kind, str(tmp_path / "d"))
        mv, mb = rec["moves"], base["moves"]
        assert rec["status"] == "ok" and "moves_reason" not in rec
        for k in ("gather", "reduce", "scatter", "relayout"):
            assert mv[k] == mb[k], k
        assert mv["model"] != mb["model"] and mb["routes"]["positions"] == 0
        n = 8 * 32 * 2 * (rows - 1) * 16 * 8
        assert mv["routes"] == {"positions": n, "devices": n}
        assert (rec["analytical_flops_global"]
                < base["analytical_flops_global"])


def bits(t):
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16
            else t).numpy().tobytes()


@pytest.mark.parametrize("arch,whole", [("rwkv6-1.6b", False),
                                        ("mixtral-8x22b", False),
                                        ("rwkv6-1.6b", True)],
                         ids=["rwkv6-1.6b", "mixtral-8x22b",
                              "rwkv6-1.6b-whole"])
def test_a_microbatch_over_fewer_data_rows(arch, whole, monkeypatch):
    """The (2, 2, 2) pod/data/model mesh, a global batch of 4 in 2
    microbatches: 2 rows a microbatch over 4 data rows.  JAX's ``_fit``
    drops ``pod``: the 2 rows of ``pod`` 0 compute a row each, those of
    ``pod`` 1 hold the same slices and run nothing.  Two steps are the
    one-device step's at accum 2 x 2: bitwise where the products stay
    whole (``whole``: the ssm family taken out of the split families);
    where they split (mixtral, rwkv6) bitwise on a repeat and with the
    positions on two devices, and within 1e-5 of its loss and grad_norm,
    every parameter within 2 lr k.  The composed moves equal the
    measured ones (one thread: a multithreaded CPU product may round
    differently run to run)."""
    if whole:
        monkeypatch.setattr(tp, "SPLIT_FAMILIES", tuple(
            f for f in tp.SPLIT_FAMILIES if f != "ssm"))
    cfg = treg.SMOKES[arch]
    mesh = mesh_of("2x2x2")
    assert tts.microbatch_rows(mesh, 4, 2) == (2, 1)
    opt = topt.AdamW(lr=1e-2)
    state = tts.init_state(cfg, opt, torch.Generator().manual_seed(0))
    batches = [tdata.batch_at(tdata.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=0), k,
        device="cpu") for k in range(2)]

    def run(step, s):
        out = []
        for b in batches:
            s, m = step(s, b)
            out.append(m)
        return tts.unshard_state(s, "cpu"), out

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one, m_one = run(tts.make_train_step(cfg, opt, accum=4), state)
        step = tts.make_train_step(cfg, opt, accum=2)
        runs = [run(step, tts.shard_state(state, make_mesh(
            (2, 2, 2), ("pod", "data", "model"), devs)))
            for devs in (CPU8, CPU8, ["cpu", "cpu:0"] * 4)]
    finally:
        torch.set_num_threads(n)
    on, m_on = runs[0]
    assert m_on[-1]["moved"] == tts.mesh_step_moves(cfg, mesh, 2, 4, 16)
    keys = ("loss", "grad_norm")

    def same(a, b):
        return (all(bits(x[k]) == bits(y[k]) for x, y in zip(a[1], b[1])
                    for k in keys)
                and all(bits(x) == bits(y)
                        for x, y in zip(leaves(a[0]), leaves(b[0]))))

    assert (m_on[-1]["moved"].model.positions > 0) == (not whole)
    if not whole:
        assert same(runs[1], runs[0]) and same(runs[2], runs[0])
        for x, y in zip(m_on, m_one):
            for k in keys:
                assert abs(float(x[k]) - float(y[k])) <= 1e-5 * abs(
                    float(y[k]))
        for g, w in zip(leaves(on.params), leaves(one.params)):
            assert float((g - w).abs().max()) <= 2 * opt.lr * len(batches)
    else:
        assert same(runs[0], (one, m_one))


def test_composed_moves_are_18b_measured_bytes():
    """chip_smoke.py's 18b: qwen3-0.6b at full width cut to 4 layers, 8 x
    1024 on a (2, 4) mesh naming the card 8 times, accum 1; the card
    measured gather / reduce / scatter / relayout / model 251,658,240 /
    764,772,352 / 1,309,564,928 / 0 / 2,618,228,736 B (PERF.md):
    each position fetches the other data half of its model slice of each
    block matrix (31,457,280 B a layer over the 8 positions) in the
    forward and the recomputation, and nothing of the vocabulary (split
    over model, replicated over data).  On the abstract mesh every
    position is a device of its own: the same bytes, all between
    devices."""
    cfg = validate(dataclasses.replace(treg.ARCHS["qwen3-0.6b"], n_layers=4))
    want = [251_658_240, 764_772_352, 1_309_564_928, 0, 2_618_228_736]
    assert want[0] == 2 * 4 * 31_457_280
    got = tts.mesh_step_moves(cfg, make_mesh((2, 4), ("data", "model"),
                                             CPU8), 1, 8, 1024)
    assert got == tts.MeshStepStats(*(MoveStats(w, 0) for w in want))
    abstract = tts.mesh_step_moves(cfg, DeviceMesh((2, 4),
                                                   ("data", "model")),
                                   1, 8, 1024)
    assert abstract == tts.MeshStepStats(*(MoveStats(w, w) for w in want))


@pytest.mark.parametrize("arch", ARCHS)
def test_two_point_extrapolation_gives_the_full_depth(arch):
    """JAX's ``scan_corrected`` over ``moves``: one and two periods (and
    two encoder layers where there are more than one) extrapolate to the
    full depth exactly: the port counts every period directly."""
    cfg = treg.ARCHS[arch]
    mesh = DeviceMesh(*PRODUCTION["single_pod"])

    shape = treg.SHAPES["train_4k"]

    def moves(c):
        got = tts.mesh_step_moves(c, mesh, c.train_accum,
                                  shape.global_batch, shape.seq_len)
        return np.array([list(x) for x in got], dtype=object)

    plen = len(cfg.period())
    enc1 = min(1, cfg.encoder_layers)
    m1 = moves(dataclasses.replace(cfg, n_layers=plen, encoder_layers=enc1))
    m2 = moves(dataclasses.replace(cfg, n_layers=2 * plen,
                                   encoder_layers=enc1))
    est = m1 + (cfg.n_periods - 1) * (m2 - m1)
    if cfg.encoder_layers > 1:
        m3 = moves(dataclasses.replace(cfg, n_layers=plen, encoder_layers=2))
        est = est + (cfg.encoder_layers - 1) * (m3 - m1)
    assert (est == moves(cfg)).all()
    assert (m2 != m1).any()


# ---------------------------------------------------------------------------
# the command line and the roofline reader
# ---------------------------------------------------------------------------

def test_cli_writes_jax_s_file_name(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-0.6b", "--shape", "train_4k", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert [p.name for p in tmp_path.iterdir()] == [
        "qwen3-0.6b__train_4k__single_pod.json"]
    assert "all cells ok" in r.stdout
    rec = json.loads(next(tmp_path.iterdir()).read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256


def test_cli_errors_and_flags(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        tdry.main(["--arch", "no-such-arch", "--shape", "decode_32k",
                   "--mesh", "both", "--out", str(tmp_path)])
    assert e.value.code == 1
    for kind in MESH_KINDS:
        rec = json.loads((tmp_path / (
            f"no-such-arch__decode_32k__{kind}.json")).read_text())
        assert rec["status"] == "error" and "no-such-arch" in rec["error"]
    assert "FAILURES" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        tdry.main(["--save-hlo", "--out", str(tmp_path)])
    assert e.value.code != 0
    assert "no HLO" in capsys.readouterr().err
    with pytest.raises(ValueError, match="no HLO"):
        tdry.run_cell("qwen3-0.6b", "train_4k", "single_pod", str(tmp_path),
                      save_hlo=True)
    tdry.main(["--arch", "qwen3-0.6b", "--shape", "long_500k", "--mesh",
               "multi_pod", "--no-correct", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "qwen3-0.6b__long_500k__multi_pod.json")
                     .read_text())
    assert rec["status"] == "skipped"
    assert "all cells ok" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        tdry.main(["--help"])
    assert e.value.code == 0
    assert "no scan undercount" in " ".join(capsys.readouterr().out.split())


def test_roofline_derive_reads_a_port_record(tmp_path):
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks.roofline import derive
    finally:
        sys.path.remove(str(ROOT))
    rec = tdry.run_cell("granite-3-8b", "train_4k", "single_pod",
                        str(tmp_path))
    row = derive(rec)
    assert row is not None and row["arch"] == "granite-3-8b"
    assert row["flops"] == row["analytical_flops"] == rec[
        "analytical_flops_global"] > 0
    assert row["hlo_flops"] == 0 and row["t_memory"] == 0
    assert row["dominant"] == "compute"
    assert row["args_gb"] == rec["argument_size_in_bytes"] / 1e9
    skipped = tdry.run_cell("granite-3-8b", "long_500k", "single_pod",
                            str(tmp_path))
    assert derive(skipped) is None
