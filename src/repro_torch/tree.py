"""Nested-dict trees of tensors: the port's stand-in for JAX pytrees.

Parameters, momentum and aggregation state are plain nested dicts whose
leaves are tensors with the peer axis first. Leaves are visited in
sorted key order at every level, the order ``jax.tree.leaves`` uses for
dicts, so a leaf list lines up with the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Union

import torch

Tree = Union[torch.Tensor, Dict[str, "Tree"]]


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]
