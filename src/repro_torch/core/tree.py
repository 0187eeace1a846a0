"""Nested dicts and lists of tensors — the port's pytrees.

The training state of the GAN loop is a tree of dicts and lists, as in
the JAX package: the MLPs are lists of `{"w", "b"}`, the optimizer
states dicts of such lists.  `tree_leaves` and `tree_paths` visit the
leaves in `jax.tree.leaves` order (dict keys sorted, list items by index),
so a fused ring payload has the JAX offsets and a checkpoint the JAX
path-flattened keys ("gen/0/w", "gen_opt/step", ...).
"""
from __future__ import annotations

from typing import Any, Iterator, List, Tuple

_SEP = "/"


def tree_map(fn, *trees):
    """`fn` over the leaves of equal-structure trees; the result has the
    first tree's structure (dict keys in its order)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *(t[i] for t in trees))
                           for i in range(len(first)))
    return fn(*trees)


def tree_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in `jax.tree.leaves` order, paths joined by "/"."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from tree_paths(v, f"{prefix}{_SEP}{k}" if prefix else k)


def tree_leaves(tree) -> List[Any]:
    """The leaves in `jax.tree.leaves` order."""
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(like, leaves):
    """`like`'s structure with its leaves replaced, in `tree_leaves`
    order, by `leaves`."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_from_paths(flat):
    """{"a/0/w": x, ...} -> nested dicts, with a dict whose keys are
    0..n-1 read as a list (how the JAX package's MLPs flatten)."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        *heads, last = path.split(_SEP)
        for k in heads:
            node = node.setdefault(k, {})
        node[last] = leaf

    def listify(t):
        if not isinstance(t, dict):
            return t
        t = {k: listify(v) for k, v in t.items()}
        if t and all(k.isdigit() for k in t) \
                and sorted(map(int, t)) == list(range(len(t))):
            return [t[str(i)] for i in range(len(t))]
        return t
    return listify(root)
