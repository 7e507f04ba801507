"""The JAX package's view of the port's parameter and state trees.

The JAX package stacks every layer stack on axis 0 (for `lax.scan`); the
port keeps each as a list of per-layer dicts (`bridge.STACKS`). Optimizers
and checkpoints work on JAX leaves: a JAX leaf is one tensor of the port's
tree, or the group of same-named tensors across a list's entries, which
JAX stacks. A leaf is named by its JAX `keystr` path (`['layers']['attn']
['wq']`); a key that is already such a path (the optimizer state keys its
tensors so) is taken as it is.
"""
from __future__ import annotations

import re


def keystr(keys) -> str:
    """The JAX `keystr` of a path of dict keys."""
    return "".join(k if k.startswith("[") else f"['{k}']" for k in keys)


def path_keys(path: str) -> list:
    """The dict keys of a `keystr` path."""
    return re.findall(r"\['([^']*)'\]", path)


def map_leaves(fn, tree, prefix=(), index=None):
    """A tree of `tree`'s structure whose tensor at path `keys` is fn(keys,
    index, tensor): index is the entry of the list it sits in (its row of
    the stacked JAX leaf), None outside a list."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, prefix + (k,), index) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_leaves(fn, v, prefix, i) for i, v in enumerate(tree)]
    return fn(prefix, index, tree)


def leaves(tree) -> list:
    """[(keystr, tensors, stacked)] for every JAX leaf, in `jax.tree.leaves`
    order (dict keys sorted): `tensors` the port's tensors of the leaf, in
    stack order, and `stacked` whether JAX stacks them on a new axis 0."""
    groups = {}

    def visit(keys, index, t):
        groups.setdefault(keys, ([], index is not None))[0].append(t)
    map_leaves(visit, tree)
    return [(keystr(keys), ts, stacked) for keys, (ts, stacked) in sorted(groups.items())]


def flat(tree) -> list:
    """The tensors of a tree in its own order (dicts as they iterate)."""
    out = []
    map_leaves(lambda keys, index, t: out.append(t), tree)
    return out


def like(tree, values) -> dict:
    """A tree of `tree`'s structure holding `values` in `flat` order."""
    it = iter(values)
    return map_leaves(lambda keys, index, t: next(it), tree)


def at(tree, keys, index):
    """The entry of a tree at dict `keys`, in list entry `index` where the
    path crosses a list (the port's layer stacks)."""
    node = tree
    for k in keys:
        node = node[k]
        if isinstance(node, list):
            node = node[index]
    return node
