"""The port's LM sharding policy and layout operations against the JAX
package's, on the CPU.

The JAX side runs in this process on ``AbstractMesh``es with Auto axes
(no devices needed): the production 16x16 and 2x16x16 meshes and the
(2, 4) debug mesh.  For every arch's ``CONFIG`` and ``SMOKE``,
``param_shardings`` must give JAX's spec for every leaf, and the bytes one
mesh position holds of the parameters and of AdamW's state must equal
those from JAX's ``shard_shape``; ``cache_shardings`` and
``batch_shardings`` likewise for every ``SHAPES`` cell that
``cell_is_skipped`` keeps.  The allocation-free ``meta`` specs
(``lm.param_specs``, ``lm.cache_specs``, ``AdamW.init_specs``,
``train_step.state_specs``, ``registry.input_specs``) must equal JAX's
``eval_shape`` shapes and dtypes.  The layout operations (``shard``,
``unshard``, ``reshard``) run on meshes that name the CPU 8 times and
must be bitwise, with the bytes moved between positions equal to the
count derived from the two specs.
"""
import functools
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.models import sharding as jsh
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch.configs import registry as treg
from repro_torch.launch.mesh import (DeviceMesh, make_debug_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.models import lm as tlm
from repro_torch.models import sharding as tsh
from repro_torch.models.sharding import P, NamedSharding, MoveStats
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
ARCHS = sorted(treg.ARCHS)
CELLS = [(a, s) for a in ARCHS for s in treg.SHAPES
         if treg.cell_is_skipped(a, s) is None]
CPU8 = ["cpu"] * 8


def jmesh(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))


def tmesh(name):
    shape, names = MESHES[name]
    return DeviceMesh(shape, names)


def norm(spec) -> tuple:
    """A spec's entries, a one-name tuple as the name (JAX's P equates
    them)."""
    out = []
    for e in spec:
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(tuple(e) if isinstance(e, tuple) else e)
    return tuple(out)


def jflat(tree, is_leaf=None) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {tuple(p.key for p in path): leaf for path, leaf in flat}


def tflat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(tflat(v, path + (k,)))
        return out
    return {path: tree}


def is_jsharding(x):
    return isinstance(x, JNamedSharding)


def cfg_of(arch, kind):
    return (jreg.ARCHS if kind == "config" else jreg.SMOKES)[arch], (
        treg.ARCHS if kind == "config" else treg.SMOKES)[arch]


@functools.lru_cache(maxsize=None)
def jparam_specs(arch, kind):
    return jlm.param_specs(cfg_of(arch, kind)[0])


def jbytes(specs: dict, shardings: dict) -> int:
    return sum(math.prod(shardings[k].shard_shape(v.shape))
               * np.dtype(v.dtype).itemsize for k, v in specs.items())


def tbytes(specs: dict, shardings: dict) -> int:
    return sum(math.prod(shardings[k].shard_shape(tuple(v.shape)))
               * v.element_size() for k, v in specs.items())


def same_shapes(jtree: dict, ttree: dict) -> None:
    assert jtree.keys() == ttree.keys()
    for k, j in jtree.items():
        t = ttree[k]
        assert tuple(t.shape) == tuple(j.shape), k
        assert t.device.type == "meta", k
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), k


# ---------------------------------------------------------------------------
# the policy, leaf for leaf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["config", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_and_bytes_match_jax(arch, kind):
    jspecs = jparam_specs(arch, kind)
    tspecs = tlm.param_specs(cfg_of(arch, kind)[1])
    jf, tf = jflat(jspecs), tflat(tspecs)
    same_shapes(jf, tf)
    for mesh in MESHES:
        js = jflat(jsh.param_shardings(jmesh(mesh), jspecs), is_jsharding)
        ts = tflat(tsh.param_shardings(tmesh(mesh), tspecs))
        assert js.keys() == ts.keys()
        for k in js:
            assert norm(ts[k].spec) == norm(js[k].spec), (mesh, k)
            assert repr(ts[k].spec) == repr(JP(*norm(js[k].spec))), k
        # bytes one position holds: the parameters, then AdamW's state
        # (f32 m and v, laid out as the parameters are)
        assert tbytes(tf, ts) == jbytes(jf, js), mesh
        jo = jopt.AdamW().init_specs(jspecs)
        to = topt.AdamW().init_specs(tspecs)
        for tree in ("m", "v"):
            assert (tbytes(tflat(getattr(to, tree)), ts)
                    == jbytes(jflat(getattr(jo, tree)), js)), (mesh, tree)


def test_qwen3_bytes_a_position_on_the_debug_mesh():
    """qwen3-0.6b: 188,022,784 of 1,192,099,840 parameter bytes at one
    (2, 4) position (the embedding is replicated over ``data``); a
    4-layer cut 93,540,352 of 437,014,528."""
    import dataclasses

    cfg = treg.ARCHS["qwen3-0.6b"]
    for c, per, whole in ((cfg, 188_022_784, 1_192_099_840),
                          (dataclasses.replace(cfg, n_layers=4),
                           93_540_352, 437_014_528)):
        specs = tflat(tlm.param_specs(c))
        sh = tflat(tsh.param_shardings(tmesh("2x4"), tlm.param_specs(c)))
        assert tbytes(specs, sh) == per
        assert sum(v.numel() * v.element_size()
                   for v in specs.values()) == whole


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cache_and_batch_shardings_match_jax(arch, shape):
    jin = jreg.input_specs(arch, shape)
    tin = treg.input_specs(arch, shape)
    same_shapes(jflat(jin), tflat(tin))
    for mesh in MESHES:
        js = jflat(jsh.batch_shardings(jmesh(mesh), jin), is_jsharding)
        ts = tflat(tsh.batch_shardings(tmesh(mesh), tin))
        assert js.keys() == ts.keys()
        for k in js:
            assert norm(ts[k].spec) == norm(js[k].spec), (mesh, k)
        if "cache" not in jin:
            continue
        jc, tc = jflat(jin["cache"]), tflat(tin["cache"])
        jcs = jflat(jsh.cache_shardings(jmesh(mesh), jin["cache"]),
                    is_jsharding)
        tcs = tflat(tsh.cache_shardings(tmesh(mesh), tin["cache"]))
        assert jcs.keys() == tcs.keys()
        for k in jcs:
            assert norm(tcs[k].spec) == norm(jcs[k].spec), (mesh, k)
        assert tbytes(tc, tcs) == jbytes(jc, jcs), mesh


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_specs_match_eval_shape(arch):
    """``state_specs`` (compression on: parameters, ``m``, ``v``, the
    error buffers, the step) and ``cache_specs`` equal JAX's
    ``eval_shape`` and allocate nothing."""
    jcfg, tcfg = jreg.ARCHS[arch], treg.ARCHS[arch]
    js = jts.state_specs(jcfg, jopt.AdamW(), compress=True)
    ts = tts.state_specs(tcfg, topt.AdamW(), compress=True)
    for tree in ("params", "err"):
        same_shapes(jflat(getattr(js, tree)), tflat(getattr(ts, tree)))
    for tree in ("m", "v"):
        same_shapes(jflat(getattr(js.opt, tree)),
                    tflat(getattr(ts.opt, tree)))
    same_shapes({(): js.opt.step}, {(): ts.opt.step})
    assert tts.state_specs(tcfg, topt.AdamW()).err is None
    mem = tcfg.frontend_len if tcfg.cross_attention else 0
    same_shapes(jflat(jlm.cache_specs(jcfg, 2, 64, memory_len=mem)),
                tflat(tlm.cache_specs(tcfg, 2, 64, memory_len=mem)))


# ---------------------------------------------------------------------------
# helpers, meshes, specs
# ---------------------------------------------------------------------------

FIT_CASES = [("2x16x16", 64, ("pod", "data")),
             ("2x16x16", 16, ("pod", "data")),
             ("2x16x16", 8, ("pod", "data")), ("2x16x16", 36, "model"),
             ("2x16x16", 32, None), ("16x16", 257_216, "model"),
             ("16x16", 151_936, "model"), ("2x4", 6, ("data", "model")),
             ("2x4", 8, ("data", "model")), ("2x4", 3, "data"),
             ("16x16", 16, ()), ("2x16x16", 2, ("pod", "data"))]


@pytest.mark.parametrize("mesh,dim,axes", FIT_CASES)
def test_fit_matches_jax(mesh, dim, axes):
    got = tsh._fit(tmesh(mesh), dim, axes)
    want = jsh._fit(jmesh(mesh), dim, axes)
    assert got == want
    assert (tsh._axsize(tmesh(mesh), axes)
            == jsh._axsize(jmesh(mesh), axes))


@pytest.mark.parametrize("mesh", list(MESHES) + ["model-only"])
def test_dp_axes_matches_jax(mesh):
    if mesh == "model-only":
        t, j = DeviceMesh((4,), ("model",)), AbstractMesh(
            (4,), ("model",), axis_types=(AxisType.Auto,))
    else:
        t, j = tmesh(mesh), jmesh(mesh)
    assert tsh.dp_axes(t) == jsh.dp_axes(j)


def test_meshes_and_specs():
    m = make_production_mesh(multi_pod=True)
    assert m.abstract and tuple(m.shape) == (2, 16, 16)
    assert m.shape["pod"] == 2 and m.axis_names == ("pod", "data", "model")
    assert dict(zip(m.axis_names, m.shape)) == {"pod": 2, "data": 16,
                                                 "model": 16}
    assert tuple(make_production_mesh().shape) == (16, 16)
    d = make_debug_mesh(devices=CPU8)
    assert d.size == 8 and d.devices.shape == (2, 4)
    assert d.positions()[:3] == [(0, 0), (0, 1), (0, 2)]
    assert d.device((1, 3)) == torch.device("cpu")
    with pytest.raises(ValueError, match="needs 8 devices, have 1"):
        make_debug_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="needs 8 devices, have 7"):
        make_mesh((2, 4), ("data", "model"), ["cpu"] * 7)
    for spec in (P(None, ("data", "model"), None), P("model", None),
                 P(None,), P()):
        assert repr(spec) == repr(JP(*spec))
    with pytest.raises(ValueError, match="more than one dim"):
        NamedSharding(d, P("model", ("data", "model")))
    with pytest.raises(ValueError, match="not an axis"):
        NamedSharding(d, P("pod"))
    sh = NamedSharding(d, P(None, ("data", "model")))
    with pytest.raises(ValueError, match="size is 12"):
        sh.shard_shape((4, 12))
    with pytest.raises(ValueError, match="abstract"):
        tsh.shard(torch.zeros(8, 8), NamedSharding(tmesh("2x4"), P("data")))
    x = torch.arange(4.0)
    assert tsh.constrain(x, "dp", None) is x
    assert tsh.out_spec() == jsh.out_spec() == ("dp", None, None)
    tsh.set_sp_outputs(True)
    jsh.set_sp_outputs(True)
    try:
        assert tsh.out_spec() == jsh.out_spec() == ("dp", "model", None)
    finally:
        tsh.set_sp_outputs(False)
        jsh.set_sp_outputs(False)


# ---------------------------------------------------------------------------
# layout operations
# ---------------------------------------------------------------------------

LAYOUT_MESHES = {"2x4": ((2, 4), ("data", "model")),
                 "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
SPECS = {"2x4": [P(), P("data"), P(None, "model"), P("model", "data"),
                 P(("data", "model")), P(None, ("model", "data")),
                 P(None, "data", "model")],
         "2x2x2": [P(("pod", "data")), P(None, "model", "pod"),
                   P("pod", None, ("data", "model")), P(None, None, "data")]}
SHAPE = (8, 8, 4)


def box_bytes(a, b) -> int:
    return math.prod(max(0, min(x1, y1) - max(x0, y0))
                     for (x0, x1), (y0, y1) in zip(a, b))


def moved_from_specs(src: NamedSharding, dst: NamedSharding, shape,
                     item: int) -> int:
    """Each destination slice less what the position already holds."""
    total = 0
    for c in src.mesh.positions():
        d, s = dst.box(c, shape), src.box(c, shape)
        total += (box_bytes(d, d) - box_bytes(d, s)) * item
    return total


@pytest.mark.parametrize("mesh", list(LAYOUT_MESHES))
def test_shard_unshard_reshard_bitwise(mesh):
    shape, names = LAYOUT_MESHES[mesh]
    m = make_mesh(shape, names, CPU8)
    jm = AbstractMesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(SHAPE, generator=g).to(torch.bfloat16)
    placed = {}
    for spec in SPECS[mesh]:
        sh = NamedSharding(m, spec)
        s = tsh.shard(x, sh)
        want = JNamedSharding(jm, JP(*spec)).shard_shape(SHAPE)
        assert all(tuple(t.shape) == want for t in s.shards), spec
        assert len({t.data_ptr() for t in s.shards}) == m.size  # copies
        for c, t in zip(m.positions(), s.shards):
            sl = tuple(slice(lo, hi) for lo, hi in sh.box(c, SHAPE))
            assert torch.equal(t.view(torch.int16), x[sl].view(torch.int16))
        back = tsh.unshard(s, "cpu")
        assert torch.equal(back.view(torch.int16), x.view(torch.int16))
        assert all(back.data_ptr() != t.data_ptr() for t in s.shards)
        assert s.position_bytes() * m.size == sum(
            t.numel() * 2 for t in s.shards)
        placed[spec] = s
    for a in SPECS[mesh]:
        for b in SPECS[mesh]:
            out, moved = tsh.reshard(placed[a], NamedSharding(m, b))
            want = moved_from_specs(NamedSharding(m, a), NamedSharding(m, b),
                                    SHAPE, 2)
            assert moved == MoveStats(want, 0), (a, b)
            assert all(torch.equal(o, p) for o, p in
                       zip(out.shards, placed[b].shards)), (a, b)
            if a == b:
                assert moved.positions == 0
                assert all(o is p for o, p in zip(out.shards,
                                                  placed[a].shards))


def test_reshard_counts_bytes_between_devices():
    """``cpu`` and ``cpu:0`` are two devices to the port (as in
    tests/test_torch_full_mesh.py): data row 0 on one, row 1 on the
    other.  From rows over ``data`` to rows over ``model``, the quarter a
    position needs lies in the other data row's half at 4 of the 8
    positions, and every holder of that half is on the other device."""
    m = make_mesh((2, 4), ("data", "model"), ["cpu"] * 4 + ["cpu:0"] * 4)
    assert len(set(m.device_list())) == 2
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    src, dst = NamedSharding(m, P("data")), NamedSharding(m, P("model"))
    out, moved = tsh.reshard(tsh.shard(x, src), dst)
    quarter = 2 * 8 * 4
    assert moved == MoveStats(moved_from_specs(src, dst, (8, 8), 4),
                              4 * quarter)
    assert moved.positions == 4 * quarter  # the same four: own half else
    assert torch.equal(tsh.unshard(out, "cpu"), x)
    # a replicated source: every position takes its piece from itself
    rep = tsh.shard(x, NamedSharding(m, P()))
    out, moved = tsh.reshard(rep, dst)
    assert moved == MoveStats(0, 0)
    assert torch.equal(tsh.unshard(out, "cpu:0"), x)
