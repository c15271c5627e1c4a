"""The port's checkpoints and training launcher against the JAX
package's, on the CPU.

Checkpoints: the JAX package's on-disk format (the manifest, the
``a0, a1, ...`` keys in JAX's leaf order, ``shard-0.npz``) with atomic
publish and pruning; each package restores the other's float32
checkpoint, and the port restores JAX's bfloat16 one, which JAX's own
``restore`` refuses with a ``TypeError`` (a fault of the reference,
recorded here, not fixed).  The launcher: the CLI's printed line shapes
are JAX's; a killed and resumed run's last checkpoint is bitwise an
uninterrupted run's (the runs use one CPU thread: a multithreaded CPU
product may round differently from run to run); ``--mesh`` with too
few devices is refused;
a step made to raise once gives the same printed sequence in both
launchers, neither re-running the steps since the restored checkpoint.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import train as jlaunch
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch.configs import registry as treg
from repro_torch.interop import train_state_from_numpy
from repro_torch.launch import train as tlaunch
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts
from repro_torch.training.tree import leaves

ROOT = Path(__file__).resolve().parents[1]


def bits(t):
    """A tensor's raw bytes (bfloat16 included), for bitwise checks."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def jax_state(dtype="float32", compress=True, seed=3):
    cfg = dataclasses.replace(jreg.SMOKES["qwen3-0.6b"], dtype=dtype)
    return jts.init_state(cfg, jopt.AdamW(), jax.random.key(seed),
                          compress=compress)


def port_state(dtype="float32", compress=True, seed=0):
    cfg = dataclasses.replace(treg.SMOKES["qwen3-0.6b"], dtype=dtype)
    return tts.init_state(cfg, topt.AdamW(),
                          torch.Generator().manual_seed(seed),
                          compress=compress)


def test_checkpoint_roundtrip_atomic_and_prune(tmp_path):
    """tests/test_training.py::test_checkpoint_roundtrip_atomic_and_prune
    on the port."""
    state = port_state(compress=False)
    d = str(tmp_path / "ckpt")
    assert tckpt.restore(d, state) == (None, None)
    for step in (5, 10, 15, 20):
        path = tckpt.save(d, step, state, keep=2)
        assert path == os.path.join(d, f"step-{step}")
    assert tckpt.latest_step(d) == 20
    steps = sorted(x for x in os.listdir(d) if x.startswith("step-"))
    assert steps == ["step-15", "step-20"]
    restored, step = tckpt.restore(d, state)
    assert step == 20
    assert type(restored) is tts.TrainState and restored.err is None
    for a, b in zip(leaves(state), leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert bits(a) == bits(b)
    # a stale tmp dir must not be picked up (atomicity)
    os.makedirs(os.path.join(d, "tmp-99"), exist_ok=True)
    assert tckpt.latest_step(d) == 20


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_manifest_and_arrays_equal_jax_s(tmp_path, dtype):
    """The same TrainState (JAX's, carried across) written by both
    packages: equal manifests (paths, keys, shapes, dtypes) and equal
    arrays, bfloat16 leaves as JAX's ``|V2`` words."""
    js = jax_state(dtype)
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    jckpt.save(str(tmp_path / "j"), 7, js)
    tckpt.save(str(tmp_path / "t"), 7, ts)
    man = {}
    arrs = {}
    for who in ("j", "t"):
        d = tmp_path / who / "step-7"
        man[who] = json.loads((d / "manifest.json").read_text())
        with np.load(d / "shard-0.npz") as z:
            arrs[who] = {k: z[k] for k in z.files}
    assert man["t"] == man["j"]
    assert man["t"]["leaves"][0]["path"].startswith(".params['")
    assert {leaf["path"] for leaf in man["t"]["leaves"]} >= {
        ".opt.step", ".params['embed']", ".err['embed']",
        ".opt.m['blocks']['l0']['attn']['wq']"}
    assert arrs["t"].keys() == arrs["j"].keys()
    for k, a in arrs["j"].items():
        assert arrs["t"][k].dtype == a.dtype, k
        assert arrs["t"][k].tobytes() == a.tobytes(), k
    if dtype == "bfloat16":
        assert any(a.dtype.str == "|V2" for a in arrs["t"].values())


def test_each_package_restores_the_other_s_f32_checkpoint(tmp_path):
    js = jax_state()
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    # JAX writes, the port reads
    jckpt.save(str(tmp_path / "j"), 4, js)
    got, step = tckpt.restore(str(tmp_path / "j"), port_state())
    assert step == 4
    for a, b in zip(leaves(got), jax.tree.leaves(js)):
        assert a.dtype == torch.float32 or a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the port writes, JAX reads
    tckpt.save(str(tmp_path / "t"), 6, ts)
    back, step = jckpt.restore(str(tmp_path / "t"),
                               jax_state(seed=9))
    assert step == 6
    for a, b in zip(jax.tree.leaves(back), leaves(ts)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_port_restores_jax_s_bf16_checkpoint(tmp_path):
    js = jax_state("bfloat16")
    jckpt.save(str(tmp_path), 2, js)
    got, step = tckpt.restore(str(tmp_path), port_state("bfloat16"))
    assert step == 2
    want = train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert got.params["embed"].dtype == torch.bfloat16
    for a, b in zip(leaves(got), leaves(want)):
        assert a.dtype == b.dtype and bits(a) == bits(b)


def test_jax_restore_refuses_its_own_bf16_checkpoint(tmp_path):
    """The reference's fault, recorded: ``np.savez`` stores a bfloat16
    leaf as ``|V2`` words and JAX's ``restore`` hands them to
    ``jnp.asarray``, which raises, so ``launch/train.py --ckpt`` cannot
    resume any bfloat16 config in the JAX package."""
    js = jax_state("bfloat16", compress=False)
    jckpt.save(str(tmp_path), 1, js)
    with pytest.raises(TypeError, match="V2"):
        jckpt.restore(str(tmp_path), js)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

SMOKE_ARGS = ["--arch", "qwen3-0.6b", "--smoke"]
LINE = re.compile(r"^(resumed from step \d+|step \d+: loss=\d+\.\d{4} "
                  r"gnorm=\d+\.\d{3} \(\d+\.\d+s\)|checkpointed → \S+|"
                  r"step \d+ failed \(.*\); restoring last checkpoint|done)$")


def cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--device", "cpu", *SMOKE_ARGS, *args], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert all(LINE.match(line) for line in lines), lines
    return lines


KINDS = (("resumed", r"resumed from step (\d+)$"), ("step", r"step (\d+): "),
         ("failed", r"step (\d+) failed "),
         ("ckpt", r"checkpointed → .*step-(\d+)$"), ("done", r"done$"))


def shape(lines):
    """The printed sequence without the numbers that differ between the
    two libraries: (kind, step) pairs."""
    out = []
    for line in lines:
        for kind, pat in KINDS:
            m = re.match(pat, line)
            if m:
                out.append((kind, int(m.group(1)) if m.groups() else None))
                break
        else:
            out.append((line, None))
    return out


def npz(path):
    with np.load(Path(path) / "shard-0.npz") as z:
        return {k: z[k].tobytes() for k in z.files}


def test_cli_resumes_bitwise(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    first = cli("--steps", "6", "--ckpt", str(a), "--ckpt-every", "3")
    assert shape(first) == [("step", 0), ("ckpt", 3), ("step", 5),
                            ("ckpt", 6), ("done", None)]
    assert first[1] == f"checkpointed → {a / 'step-3'}"
    resumed = cli("--steps", "9", "--ckpt", str(a), "--ckpt-every", "3")
    assert resumed[0] == "resumed from step 6"
    assert shape(resumed) == [("resumed", 6), ("step", 8), ("ckpt", 9),
                              ("done", None)]
    whole = cli("--steps", "9", "--ckpt", str(b), "--ckpt-every", "3")
    assert not whole[0].startswith("resumed")
    ra, rb = npz(a / "step-9"), npz(b / "step-9")
    assert ra.keys() == rb.keys() and ra == rb
    assert (json.loads((a / "step-9" / "manifest.json").read_text())
            == json.loads((b / "step-9" / "manifest.json").read_text()))


def test_cli_layers_cuts_the_depth(tmp_path):
    """``--layers 1`` trains the smoke config with one layer: each block
    leaf of the checkpoint holds one layer, the other leaves are the
    whole run's."""
    cut, whole = tmp_path / "cut", tmp_path / "whole"
    for d, extra in ((cut, ["--layers", "1"]), (whole, [])):
        tlaunch.main(SMOKE_ARGS + ["--device", "cpu", "--steps", "1",
                                   "--ckpt", str(d), "--ckpt-every", "1",
                                   *extra], log=lambda line: None)
    man = [json.loads((d / "step-1" / "manifest.json").read_text())
           ["leaves"] for d in (cut, whole)]
    assert [e["path"] for e in man[0]] == [e["path"] for e in man[1]]
    blocks = 0
    for c, w in zip(*man):
        if "['blocks']" in w["path"]:
            blocks += 1
            assert w["shape"][0] == 2 and c["shape"] == [1] + w["shape"][1:]
        else:
            assert c["shape"] == w["shape"], w["path"]
    assert blocks > 0


def test_cli_mesh_is_refused(capsys):
    """``--mesh`` without the devices it needs raises (the CPU is one
    device unless ``--mesh-devices`` names it 8 times); it never runs on
    fewer (tests/test_torch_lm_mesh_train.py runs the mesh)."""
    with pytest.raises(ValueError, match="needs 8 devices, have 1"):
        tlaunch.main(SMOKE_ARGS + ["--device", "cpu", "--mesh", "2,4"])
    assert capsys.readouterr().out == ""


def test_cli_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tlaunch.main(SMOKE_ARGS + ["--steps", "1"])


FAIL_AT = 5   # the 5th step call raises: step 4, after the step-3 checkpoint


def failing(make, jit=lambda f: f):
    """``make_train_step`` whose step raises once, at its FAIL_AT-th call."""
    calls = []

    def make_failing(*a, **kw):
        real = jit(make(*a, **kw))

        def step(state, batch):
            calls.append(1)
            if len(calls) == FAIL_AT:
                raise RuntimeError("injected device loss")
            return real(state, batch)
        return step
    return make_failing


def test_failure_path_does_not_replay_in_either_launcher(tmp_path, capsys,
                                                         monkeypatch):
    """Both launchers restore the step-3 checkpoint after step 4 raises
    and go on with step 5: steps 3 and 4 are not re-run (JAX's docstring
    says "restore-from-latest + replay"; its code continues)."""
    args = ["--steps", "8", "--ckpt-every", "3"]
    port = []
    monkeypatch.setattr(tts, "make_train_step",
                        failing(tts.make_train_step))
    tlaunch.main(SMOKE_ARGS + args + ["--device", "cpu", "--ckpt",
                                      str(tmp_path / "t")], log=port.append)
    monkeypatch.setattr(jlaunch, "make_train_step",
                        failing(jlaunch.make_train_step, jax.jit))
    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)
    monkeypatch.setattr(sys, "argv", ["train.py"] + SMOKE_ARGS + args + [
        "--ckpt", str(tmp_path / "j")])
    capsys.readouterr()
    jlaunch.main()
    ref = capsys.readouterr().out.strip().splitlines()
    assert all(LINE.match(line) for line in port + ref), port + ref
    assert shape(port) == shape(ref) == [
        ("step", 0), ("ckpt", 3), ("failed", 4), ("step", 5), ("ckpt", 6),
        ("step", 7), ("done", None)]
    assert "injected device loss" in port[2]
