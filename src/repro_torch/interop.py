"""Carry solver state and plans in and out of the port as numpy arrays.

The CFD system has no weights: what it carries is the field state
``PisoState(U, p, phi, phi_if, phi_b)`` and the repartition plan.  These
helpers move both across as plain numpy arrays, so a state developed by
another implementation (for example the JAX package, with ``np.asarray``
on each leaf) can be stepped on by the port.  A serving cohort's state is
the same five fields with a leading lane axis (:func:`cohort_from_numpy`;
:func:`state_to_numpy` takes it as it is), and a mesh travels as its
defining fields (:func:`mesh_from_fields`, :func:`mesh_fields`; a
size-class ``PaddedCavityMesh`` with its real part count).  The LM side
carries its parameter and decode-cache trees (nested dicts, the JAX
package's keys and layouts) leaf by leaf, each leaf in its own dtype
(:func:`lm_params_from_numpy`, :func:`lm_cache_from_numpy` and their
inverses); a bfloat16 leaf travels as numpy's ``ml_dtypes`` bfloat16,
which JAX's ``np.asarray`` gives.  A training state travels the same way
(:func:`train_state_from_numpy`, :func:`train_state_to_numpy`): the
parameters, the optimizer's ``step``, ``m`` and ``v``, and the error
buffers, each leaf in its dtype; a state on a mesh is gathered whole
(``unshard``) on the way out and, with ``mesh=``, laid out by
``param_shardings`` on the way in.  Nothing here imports that
implementation.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.repartition import RepartitionPlan
from repro_torch.env import DTYPE, resolve_device
from repro_torch.fvm.mesh import CavityMesh, PaddedCavityMesh
from repro_torch.fvm.piso import PisoState
from repro_torch.models.sharding import Sharded, unshard
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train_step import TrainState, shard_state

__all__ = ["state_from_numpy", "state_to_numpy", "plan_from_numpy",
           "cohort_from_numpy", "mesh_fields", "mesh_from_fields",
           "lm_params_from_numpy", "lm_params_to_numpy",
           "lm_cache_from_numpy", "lm_cache_to_numpy",
           "train_state_from_numpy", "train_state_to_numpy"]

_MESH_FIELDS = ("nx", "ny", "nz", "n_parts", "h")

_PLAN_INTS = ("alpha", "m_fine", "m_coarse", "plane", "buffer_len",
              "nnz_local", "nnz_localized", "nnz_halo")


def state_from_numpy(arrays: dict, device="cuda",
                     dtype: torch.dtype = DTYPE) -> PisoState:
    """A :class:`PisoState` from ``{field name: ndarray}`` (all five)."""
    dev = resolve_device(device)
    missing = [f for f in PisoState._fields if f not in arrays]
    if missing:
        raise KeyError(f"state fields missing: {missing}")
    return PisoState(**{f: torch.tensor(np.asarray(arrays[f]), dtype=dtype,
                                        device=dev)
                        for f in PisoState._fields})


def state_to_numpy(state: PisoState) -> dict:
    """``{field name: ndarray}`` of a :class:`PisoState` (copied to host)."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in PisoState._fields}


def cohort_from_numpy(arrays: dict, device="cuda",
                      dtype: torch.dtype = DTYPE) -> PisoState:
    """A cohort's stacked :class:`PisoState` from ``{field: ndarray}``,
    every field with one leading lane axis of the same length."""
    state = state_from_numpy(arrays, device=device, dtype=dtype)
    lanes = {t.shape[0] for t in state}
    if len(lanes) != 1 or state.U.dim() != 4:
        raise ValueError(f"a cohort state needs one leading lane axis on "
                         f"every field, got shapes "
                         f"{[tuple(t.shape) for t in state]}")
    return state


def mesh_fields(mesh) -> dict:
    """The fields that define a cavity mesh (``nx, ny, nz, n_parts, h``),
    with ``n_parts_real`` for a size-class padded one."""
    out = {k: getattr(mesh, k) for k in _MESH_FIELDS}
    real = getattr(mesh, "n_parts_real", None)
    if real is not None:
        out["n_parts_real"] = real
    return out


def mesh_from_fields(fields: dict) -> CavityMesh:
    """The port's mesh from :func:`mesh_fields`: a
    :class:`PaddedCavityMesh` when ``n_parts_real`` is given."""
    kw = {k: fields[k] for k in _MESH_FIELDS}
    if fields.get("n_parts_real") is not None:
        return PaddedCavityMesh(**kw, n_parts_real=int(fields["n_parts_real"]))
    return CavityMesh(**kw)


def plan_from_numpy(arrays: dict) -> RepartitionPlan:
    """A :class:`RepartitionPlan` from its arrays and sizes.

    ``arrays`` holds ``dia_offsets``, ``dia_src`` and the integer fields
    (``alpha``, ``m_fine``, ``m_coarse``, ``plane``, ``buffer_len``,
    ``nnz_local``, ``nnz_localized``, ``nnz_halo``) — e.g. the fields of
    another implementation's plan — and, where present, the ELL target's
    ``ell_cols`` and ``ell_src``.  The rebuilt plan carries no layout, so
    without those its ELL target is unavailable.
    """
    ell = {}
    if "ell_cols" in arrays and "ell_src" in arrays:
        cols = np.asarray(arrays["ell_cols"], dtype=np.int32)
        ell = {"ell": (cols, np.asarray(arrays["ell_src"], dtype=np.int64)),
               "K": cols.shape[1]}
    return RepartitionPlan(
        **{k: int(arrays[k]) for k in _PLAN_INTS},
        dia_offsets=np.asarray(arrays["dia_offsets"], dtype=np.int32),
        dia_src=np.asarray(arrays["dia_src"], dtype=np.int64), **ell)


def _leaf_from_numpy(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: same bits as torch's
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def _leaf_to_numpy(t) -> np.ndarray:
    t = unshard(t, "cpu") if isinstance(t, Sharded) else t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only a bfloat16 leaf needs numpy's bfloat16

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _tree_from_numpy(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, dev) for k, v in tree.items()}
    return _leaf_from_numpy(tree, dev)


def _tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    return _leaf_to_numpy(tree)


def lm_params_from_numpy(tree: dict, device="cuda") -> dict:
    """An LM parameter tree of tensors from nested dicts of arrays (e.g.
    ``jax.tree.map(np.asarray, params)``), every leaf in its own dtype."""
    return _tree_from_numpy(tree, resolve_device(device))


def lm_params_to_numpy(tree: dict) -> dict:
    """Nested dicts of numpy arrays (host copies) of an LM parameter tree,
    every leaf in its own dtype."""
    return _tree_to_numpy(tree)


def lm_cache_from_numpy(tree: dict, device="cuda") -> dict:
    """A decode cache (``lm.init_cache``'s tree, leaves stacked over
    periods) from nested dicts of arrays, so another implementation's
    cache can be decoded on."""
    return _tree_from_numpy(tree, resolve_device(device))


def lm_cache_to_numpy(tree: dict) -> dict:
    """Nested dicts of numpy arrays (host copies) of a decode cache."""
    return _tree_to_numpy(tree)


def train_state_from_numpy(state, device="cuda", mesh=None) -> TrainState:
    """The port's :class:`TrainState` from one whose leaves are arrays
    (e.g. ``jax.tree.map(np.asarray, state)`` of a JAX ``TrainState``):
    anything with ``params``, ``opt.step``, ``opt.m``, ``opt.v`` and
    ``err`` (``None`` when compression is off).  With ``mesh`` (a
    :class:`~repro_torch.launch.mesh.DeviceMesh`), the state is placed on
    it by ``shard_state`` and ``device`` is not used."""
    if mesh is not None:
        return shard_state(train_state_from_numpy(state, device="cpu"), mesh)
    dev = resolve_device(device)

    def tree(t):
        return None if t is None else _tree_from_numpy(t, dev)

    opt = AdamWState(step=_leaf_from_numpy(state.opt.step, dev),
                     m=tree(state.opt.m), v=tree(state.opt.v))
    return TrainState(params=tree(state.params), opt=opt,
                      err=tree(state.err))


def train_state_to_numpy(state: TrainState) -> TrainState:
    """A :class:`TrainState` of numpy arrays (host copies; a sharded leaf
    gathered whole)."""
    def tree(t):
        return None if t is None else _tree_to_numpy(t)

    opt = AdamWState(step=_leaf_to_numpy(state.opt.step),
                     m=tree(state.opt.m), v=tree(state.opt.v))
    return TrainState(params=tree(state.params), opt=opt,
                      err=tree(state.err))
