"""Parameter trees as nested dicts of tensors, the port's stand-in for the
JAX package's pytrees.

A model's parameters (:class:`~repro_torch.models.transformer.Model`) are
an ``nn.Module``; its tree is the nested dict of its parameters under their
names split on dots (``layers.attn.wq`` -> ``["layers"]["attn"]["wq"]``),
the reference's parameter tree. Leaves are visited in sorted key order, as
``jax.tree.leaves`` visits a dict's.
"""

from __future__ import annotations

from torch import nn


def nest(flat: dict) -> dict:
    """``{"a.b": t}`` -> ``{"a": {"b": t}}``."""
    tree: dict = {}
    for name, value in flat.items():
        *path, last = name.split(".")
        sub = tree
        for part in path:
            sub = sub.setdefault(part, {})
        sub[last] = value
    return tree


def param_tree(params) -> dict:
    """The nested dict of tensors ``params`` holds: a module's parameters
    under their names, or ``params`` itself when it is a dict already."""
    if isinstance(params, nn.Module):
        return nest(dict(params.named_parameters()))
    return params


def leaves(tree) -> list:
    """The tensors of ``tree`` (a module or a nested dict), in sorted key
    order."""
    tree = param_tree(tree)
    if not isinstance(tree, dict):
        return [tree]
    return [leaf for key in sorted(tree) for leaf in leaves(tree[key])]


def tree_map(fn, tree, *rest):
    """A nested dict of ``fn(leaf, *leaves of rest at the same path)``."""
    tree = param_tree(tree)
    rest = [param_tree(r) for r in rest]
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
            for key in tree}
