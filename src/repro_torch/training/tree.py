"""Trees of tensors, flattened in the JAX package's leaf order.

``jax.tree.flatten`` visits a dict's keys sorted, a NamedTuple's fields in
order, and gives ``None`` no leaf; PyTorch's own pytree keeps a dict's
insertion order.  The optimizer's global norm sums its leaves in JAX's
order, and a checkpoint names and numbers its leaves so
(:func:`key_paths` gives the strings ``jax.tree_util.keystr`` gives, e.g.
``.params['blocks']['l0']['attn']['wq']``).
"""
from __future__ import annotations

__all__ = ["key_paths", "leaves", "unflatten", "tree_map"]


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def key_paths(tree, prefix: str = "") -> list:
    """``[(path, leaf), ...]`` in JAX's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in key_paths(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in key_paths(getattr(tree, f), f"{prefix}.{f}")]
    return [(prefix, tree)]


def leaves(tree) -> list:
    """The leaves in JAX's order."""
    return [leaf for _, leaf in key_paths(tree)]


def unflatten(template, new_leaves):
    """``template``'s structure with ``new_leaves`` (in JAX's order) in
    place of its leaves."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, f)) for f in t._fields))
        return next(it)

    return build(template)


def tree_map(fn, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    return fn(tree, *rest)
