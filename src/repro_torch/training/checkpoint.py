"""Atomic checkpoints in the JAX package's on-disk format.

The port of the JAX package's ``training/checkpoint.py`` on one process:
a checkpoint is written to ``<dir>/tmp-<step>`` and atomically renamed to
``<dir>/step-<step>`` (a job killed mid-write never leaves a partial
newest checkpoint; ``restore`` reads the newest complete one), and only
the ``keep`` newest are kept.  The directory holds ``manifest.json``
(``step``, and per leaf its ``path`` as ``jax.tree_util.keystr`` gives it,
its ``key`` ``a0, a1, ...`` in JAX's leaf order, ``shape`` and ``dtype``)
and ``shard-0.npz``.  A bfloat16 leaf is stored as JAX stores it: 2-byte
``|V2`` words, with manifest dtype ``"bfloat16"``; it is read back by the
manifest's dtype (the words viewed as ``torch.bfloat16``), so no numpy
bfloat16 type is needed.  Either package reads the other's float32
checkpoints, and the port also reads JAX's bfloat16 ones, which JAX's own
``restore`` refuses (``jnp.asarray`` of a ``|V2`` array raises).

A state on a mesh (:class:`~repro_torch.models.sharding.Sharded` leaves)
is written whole, in the same format, and a sharded template restores
each leaf onto its sharding: a sharded run resumes an unsharded one's
checkpoint and the reverse (JAX's "restore re-shards onto whatever mesh
the restart got").
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.models.sharding import Sharded, shard, unshard
from repro_torch.training.tree import key_paths, unflatten

__all__ = ["save", "latest_step", "restore"]

BF16_WORDS = np.dtype("V2")


def _to_numpy(t) -> tuple[np.ndarray, str]:
    t = unshard(t, "cpu") if isinstance(t, Sharded) else t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_WORDS), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        words = np.asarray(arr, order="C").view(np.int16)
        return torch.from_numpy(words).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.asarray(arr, order="C")).to(device)


def save(ckpt_dir: str, step: int, state, keep: int = 3) -> str:
    """Write one checkpoint; returns the final directory path."""
    tmp = os.path.join(ckpt_dir, f"tmp-{step}")
    final = os.path.join(ckpt_dir, f"step-{step}")
    os.makedirs(tmp, exist_ok=True)

    arrays = {}
    meta = {"step": step, "leaves": []}
    for name, leaf in key_paths(state):
        arr, dtype = _to_numpy(leaf)
        key = f"a{len(arrays)}"
        arrays[key] = arr
        meta["leaves"].append({"path": name, "key": key,
                               "shape": list(arr.shape), "dtype": dtype})
    np.savez(os.path.join(tmp, "shard-0.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _prune(ckpt_dir, keep)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step-") and os.path.exists(
                os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(d.split("-")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, state_template):
    """``(state, step)`` from the newest complete checkpoint, in
    ``state_template``'s structure, each leaf on its template leaf's
    device (a :class:`Sharded` template leaf: laid out by its sharding);
    ``(None, None)`` when there is none."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    d = os.path.join(ckpt_dir, f"step-{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        meta = json.load(f)
    by_path = {leaf["path"]: leaf for leaf in meta["leaves"]}
    out = []
    with np.load(os.path.join(d, "shard-0.npz")) as data:
        for name, leaf in key_paths(state_template):
            entry = by_path[name]
            if isinstance(leaf, Sharded):
                out.append(shard(_from_numpy(data[entry["key"]],
                                             entry["dtype"], "cpu"),
                                 leaf.sharding))
            else:
                out.append(_from_numpy(data[entry["key"]], entry["dtype"],
                                       leaf.device))
    return unflatten(state_template, out), step


def _prune(ckpt_dir: str, keep: int):
    steps = sorted(
        int(d.split("-")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step-"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step-{s}"), ignore_errors=True)
