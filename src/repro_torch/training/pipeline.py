"""Pipeline parallelism over the pod axis (GPipe forward).

The port of the JAX package's ``training/pipeline.py``.  On a mesh with a
``pod`` axis the layer stack is split into one stage per pod: stage ``s``
owns periods ``[s*per, (s+1)*per)`` and holds them on the ``pod == s``
positions.  Microbatches stream through the stages GPipe-style, and a
microbatch's rows are split over ``data`` (JAX's ``in_specs``
``P(None, "data", None, None)``): data row ``r`` of stage ``s`` runs its
slice on the device of position ``(pod=s, data=r, model=0)``.  The
``model`` positions of a row would compute the same thing (JAX's
``shard_map`` replicates over ``model``), so each slice runs once.

At tick ``t`` stage ``s`` runs microbatch ``t - s`` and hands its
activation to stage ``s + 1``'s device (JAX's ``ppermute``); JAX also
computes the bubble ticks and masks their results, which the port skips
(the result is the same).  The last stage's outputs end up on every
stage's devices (JAX's masked ``psum`` over ``pod``), and the final
``rms_norm`` is applied to each slice.  The result is gathered on the
mesh's first device.  Per slice the arithmetic is ``lm.hidden_states``'s
on that slice's tokens, so the result is bitwise ``hidden_states`` run
per slice and concatenated.  Frontends are not taken (JAX's function
embeds tokens only).
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm

__all__ = ["split_periods", "pipelined_forward"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def split_periods(params, n_stages: int) -> list:
    """Slice the stacked ``blocks`` tree into per-stage stacks (axis 0)."""

    def sl(leaf, s):
        per = leaf.shape[0] // n_stages
        return leaf[s * per:(s + 1) * per]

    return [_tree_map(lambda leaf, s=s: sl(leaf, s), params["blocks"])
            for s in range(n_stages)]


@torch.no_grad()
def pipelined_forward(cfg: ModelConfig, params, tokens: torch.Tensor, *,
                      mesh: DeviceMesh, n_micro: int,
                      stats: dict | None = None) -> torch.Tensor:
    """GPipe forward over the pod axis.  Returns the final hidden states
    (B, S, d) on the mesh's first device.

    ``stats``, when given, gets the bytes handed between stages
    (``hop_bytes``) and broadcast from the last stage to the others
    (``broadcast_bytes``), and of those the bytes between distinct devices
    (``hop_device_bytes``, ``broadcast_device_bytes``).
    """
    n_stages = mesh.shape["pod"]
    if cfg.n_periods % n_stages:
        raise ValueError(f"{cfg.n_periods} periods do not split into "
                         f"{n_stages} stages")
    B, S = tokens.shape
    D = mesh.shape["data"]
    if B % n_micro or (B // n_micro) % D:
        raise ValueError(f"a batch of {B} does not split into {n_micro} "
                         f"microbatches over {D} data rows")
    b = B // n_micro // D
    pod, data = mesh.axis_names.index("pod"), mesh.axis_names.index("data")

    def device(s, r):
        c = [0] * len(mesh.axis_names)
        c[pod], c[data] = s, r
        return mesh.device(c)

    # each stage's periods (and the embedding / final norm where they run)
    # once per distinct device of the stage
    stages = split_periods(params, n_stages)
    held: dict = {}

    def stage_params(s, dev):
        if (s, dev) not in held:
            held[(s, dev)] = _tree_map(lambda t: t.to(dev), stages[s])
        return held[(s, dev)]

    def leaf_on(name, dev):
        if (name, dev) not in held:
            held[(name, dev)] = params[name].to(dev)
        return held[(name, dev)]

    first = mesh.device_list()[0]
    per = cfg.n_periods // n_stages
    moved = dict(hop_bytes=0, hop_device_bytes=0, broadcast_bytes=0,
                 broadcast_device_bytes=0)
    bufs: dict = {}      # (microbatch, row) -> activation at the next stage
    outs: dict = {}
    positions = {}
    for t in range(n_micro + n_stages - 1):
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < n_micro:
                continue          # a bubble tick: JAX computes and masks it
            for r in range(D):
                dev = device(s, r)
                if dev not in positions:
                    positions[dev] = torch.arange(S, dtype=torch.int64,
                                                  device=dev)
                if s == 0:
                    j = m * D + r
                    x = lm._embed(cfg, {"embed": leaf_on("embed", dev)},
                                  tokens[j * b:(j + 1) * b].to(dev))
                else:
                    x = bufs.pop((m, r))
                pp = stage_params(s, dev)
                for i in range(per):
                    x, _ = lm._apply_period(cfg, lm._index(pp, i), x,
                                            positions[dev], None, "train")
                if s + 1 < n_stages:
                    nxt = device(s + 1, r)
                    moved["hop_bytes"] += _nbytes(x)
                    moved["hop_device_bytes"] += (_nbytes(x) if nxt != dev
                                                  else 0)
                    bufs[(m, r)] = x.to(nxt)
                else:
                    outs[(m, r)] = rms_norm(x, leaf_on("final_ln", dev),
                                            cfg.norm_eps)
    # the last stage's outputs reach every stage (JAX's masked psum);
    # stage 0's copies are assembled on the mesh's first device
    on_stage0 = {}
    for (m, r), y in outs.items():
        src = device(n_stages - 1, r)
        for s in range(n_stages - 1):
            dst = device(s, r)
            moved["broadcast_bytes"] += _nbytes(y)
            moved["broadcast_device_bytes"] += _nbytes(y) if dst != src else 0
            copy = y.to(dst)
            if s == 0:
                on_stage0[(m, r)] = copy
    if n_stages == 1:
        on_stage0 = outs
    result = torch.cat([on_stage0[(m, r)].to(first) for m in range(n_micro)
                        for r in range(D)], 0)
    if stats is not None:
        stats.update(moved)
    return result
