"""Walks over nested dicts, lists and tuples (a cache or spec tree): the
structure the model layer slices and the serving layer builds."""
from __future__ import annotations

from typing import List


def tmap(fn, tree):
    """``fn`` over the leaves of a tree (anything that is not a dict, list
    or tuple), keeping its structure."""
    if isinstance(tree, dict):
        return {k: tmap(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tmap(fn, v) for v in tree)
    return fn(tree)


def leaves(tree) -> List:
    """A tree's leaves in the reference's pytree order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in leaves(sub)]
    return [tree]
