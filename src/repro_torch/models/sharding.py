"""Divisibility-aware sharding policy (DP/TP/SP/EP + FSDP) over a
:class:`~repro_torch.core.layout.DeviceMesh`.

The port of the JAX package's ``models/sharding.py``.  The policy maps
every parameter / cache / batch leaf to a :class:`PartitionSpec`, rule for
rule as JAX's does:

* **TP** — matmul contraction-free dims (flattened head dim, d_ff, vocab)
  shard over ``model``;
* **FSDP/ZeRO** — the remaining large dim shards over the data-parallel axes
  (``("pod","data")`` on the multi-pod mesh) so parameters + optimizer states
  scale with the fleet;
* **EP** — expert dims shard over the data axes when divisible (phi-3.5's 16
  experts on a 16-way axis), else fall back to FSDP on d_model;
* every rule checks divisibility and falls back to ``None`` (replication).

Batch dims shard over the data axes; cache sequence dims shard over
``model``; the period/stack leading dim is never sharded.

The specs and the layout operations (:class:`PartitionSpec`,
:class:`NamedSharding`, :func:`shard`, :func:`unshard`, :func:`reshard`,
:func:`move_plan`, :class:`MoveStats`, ...) live in
:mod:`repro_torch.core.layout`, which the CFD side's mesh shares; this
module re-exports them.
"""
from __future__ import annotations

from repro_torch.core.layout import (P, DeviceMesh, MoveStats,  # noqa: F401
                                     NamedSharding, PartitionSpec, Sharded,
                                     move_plan, reshard, shard, sharded_leaves,
                                     unshard, unshard_moves, unshard_tree)

__all__ = ["PartitionSpec", "P", "NamedSharding", "Sharded", "MoveStats",
           "dp_axes", "param_shardings", "cache_shardings",
           "batch_shardings", "make_sharding", "set_activation_mesh",
           "set_sp_outputs", "out_spec", "constrain", "shard", "unshard",
           "reshard", "move_plan", "unshard_moves", "unshard_tree",
           "sharded_leaves"]


def make_sharding(mesh: DeviceMesh, *dim_axes) -> NamedSharding:
    return NamedSharding(mesh, P(*dim_axes))


# ---------------------------------------------------------------------------
# activation hints
# ---------------------------------------------------------------------------

_ACT_MESH: DeviceMesh | None = None
_SP_OUTPUTS = False


def set_activation_mesh(mesh: DeviceMesh | None):
    global _ACT_MESH
    _ACT_MESH = mesh


def set_sp_outputs(on: bool):
    """JAX's collective lever (sequence-sharded sublayer outputs); kept as
    a flag with JAX's values for :func:`out_spec`."""
    global _SP_OUTPUTS
    _SP_OUTPUTS = on


def out_spec() -> tuple:
    return ("dp", "model", None) if _SP_OUTPUTS else ("dp", None, None)


def constrain(x, *axes):
    """Returns ``x``.  In JAX this is a GSPMD layout hint
    (``with_sharding_constraint``) that keeps a layer's activations
    batch-sharded; in the port a data row's activations already are its
    batch slice, computed on that row's device, so there is nothing to
    pin.  The LM stack does not call it."""
    return x


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

def dp_axes(mesh: DeviceMesh):
    """Data-parallel axes: ('pod','data') on multi-pod, ('data',) otherwise."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axsize(mesh: DeviceMesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _fit(mesh: DeviceMesh, dim: int, axes):
    """Return `axes` if they evenly divide dim, else progressively shrink."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    while axes:
        if dim % _axsize(mesh, axes) == 0:
            return axes if len(axes) > 1 else axes[0]
        axes = axes[1:]  # drop the leading (pod) axis first
    return None


def _param_rule(name: str, shape: tuple[int, ...], mesh: DeviceMesh,
                stack_dims: int) -> PartitionSpec:
    """PartitionSpec entries for the non-stack dims of one parameter."""
    dp = dp_axes(mesh)
    dims = shape[stack_dims:]
    nd = len(dims)

    def spec(*entries):
        fitted = [_fit(mesh, dims[i], entries[i]) for i in range(nd)]
        return P(*([None] * stack_dims), *fitted)

    if name in ("embed",):            # (V, d): vocab TP; d replicated
        return spec("model", None)
    if name in ("lm_head",):          # (d, V)
        return spec(None, "model")
    if name in ("wq", "wk", "wv"):    # (d, H*hd): TP on flattened heads
        return spec(dp, "model")
    if name in ("wo",):               # (H*hd, d)
        return spec("model", dp)
    if name in ("w_up", "w_gate"):
        if nd == 3:                   # MoE (E, d, ff)
            if _fit(mesh, dims[0], dp):      # EP: experts over data axes
                return spec(dp, None, "model")
            return spec(None, dp, "model")   # else FSDP on d (mixtral: E=8)
        return spec(dp, "model")      # dense (d, ff)
    if name in ("w_down",):
        if nd == 3:                   # (E, ff, d)
            if _fit(mesh, dims[0], dp):
                return spec(dp, "model", None)
            return spec(None, "model", dp)
        return spec("model", dp)      # (ff, d)
    if name in ("router",):           # (d, E) small
        return spec(None, None)
    if name in ("in_proj",):          # mamba (d, 2*di)
        return spec(dp, "model")
    if name in ("x_proj",):           # (di, dt_rank + 2 ds)
        return spec("model", None)
    if name in ("dt_proj",):          # (r, di)
        return spec(None, "model")
    if name in ("out_proj",):         # (di, d)
        return spec("model", dp)
    if name in ("conv_w",):           # (k, di)
        return spec(None, "model")
    if name in ("A_log", "D", "conv_b", "dt_bias"):  # (di, ...) vectors
        return spec("model", *(None,) * (nd - 1))
    if name in ("wr", "wk6", "wv6", "wg"):  # rwkv square mats
        return spec(dp, "model")
    if name in ("wA",):               # (d, r)
        return spec(dp, None)
    if name in ("wB",):               # (r, d)
        return spec(None, "model")
    # norms, biases, mus, u, w0, ln_g, small leftovers: replicate
    return P(*([None] * stack_dims), *([None] * nd))


_STACKED_PREFIXES = ("blocks", "encoder")


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of nested dicts (keys as JAX's
    ``DictKey``s name them); ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_shardings(mesh: DeviceMesh, param_specs) -> dict:
    """NamedSharding tree matching ``lm.param_specs(cfg)`` / init_params
    (any tree of leaves with a ``.shape``)."""

    def visit(path, leaf):
        stack = 1 if (path and path[0] in _STACKED_PREFIXES) else 0
        name = path[-1] if path else ""
        # rwkv shares wk/wv names with attention — same rule applies (d, d)
        return NamedSharding(mesh, _param_rule(name, tuple(leaf.shape), mesh,
                                               stack))

    return _map_with_path(visit, param_specs)


def cache_shardings(mesh: DeviceMesh, cache_specs) -> dict:
    dp = dp_axes(mesh)

    def visit(path, leaf):
        name = path[-1] if path else ""
        dims = tuple(leaf.shape)  # leading dim = n_periods (never sharded)
        if name in ("k", "v"):       # (np, B, S, Hk, hd): batch DP + seq TP
            return NamedSharding(mesh, P(None, _fit(mesh, dims[1], dp),
                                         _fit(mesh, dims[2], "model"),
                                         None, None))
        if name in ("ck", "cv"):     # (np, B, M, Hk, hd)
            return NamedSharding(mesh, P(None, _fit(mesh, dims[1], dp),
                                         None, None, None))
        if name == "ssm":            # (np, B, di, ds)
            return NamedSharding(mesh, P(None, _fit(mesh, dims[1], dp),
                                         _fit(mesh, dims[2], "model"), None))
        if name == "conv":           # (np, B, k, di)
            return NamedSharding(mesh, P(None, _fit(mesh, dims[1], dp),
                                         None, _fit(mesh, dims[3], "model")))
        if name == "S":              # (np, B, H, hd, hd)
            return NamedSharding(mesh, P(None, _fit(mesh, dims[1], dp),
                                         _fit(mesh, dims[2], "model"),
                                         None, None))
        if name in ("last", "ffn_last"):  # (np, B, d)
            return NamedSharding(mesh, P(None, _fit(mesh, dims[1], dp),
                                         _fit(mesh, dims[2], "model")))
        return NamedSharding(mesh, P(*([None] * len(dims))))

    return _map_with_path(visit, cache_specs)


def batch_shardings(mesh: DeviceMesh, batch_specs) -> dict:
    """tokens/labels (B, S) → batch over DP axes; frontend (B, F, d) same."""
    dp = dp_axes(mesh)

    def visit(path, leaf):
        shape = tuple(leaf.shape)
        if shape == ():  # scalars (pos)
            return NamedSharding(mesh, P())
        entries = [_fit(mesh, shape[0], dp)] + [None] * (len(shape) - 1)
        return NamedSharding(mesh, P(*entries))

    return _map_with_path(visit, batch_specs)
