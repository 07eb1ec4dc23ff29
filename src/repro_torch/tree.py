"""Nested-dict trees of tensors: the port's stand-in for JAX pytrees.

Parameters, momentum and aggregation state are plain nested dicts whose
leaves are tensors with the peer axis first; decode caches may also hold
tuples (the sLSTM carry). Leaves are visited in sorted key order at
every dict level and in order within a tuple, the order
``jax.tree.leaves`` uses, so a leaf list lines up with the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple, Union

import torch

Tree = Union[torch.Tensor, Dict[str, "Tree"], Tuple["Tree", ...]]


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, t, *(r[i] for r in rest))
                     for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(like: Tree, leaves: Sequence[Any]) -> Tree:
    """``like``'s structure with ``leaves`` in :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
