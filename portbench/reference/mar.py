"""Moshpit All-Reduce as the paper states it, on peers stacked on a
leading axis: the peers lie on a grid of ``dims`` (peer ``i`` at the
mixed-radix digits of ``i``), and round ``r`` replaces each peer's value
by the mean over the peers that differ from it in digit ``r`` alone.
Values are averaged in float32 and stored back in their own dtype after
every round, as the state holds them."""
from __future__ import annotations

from typing import Dict, Sequence

import torch

_BLOCK = 1 << 28


def _round_(x: torch.Tensor, dims: Sequence[int], r: int) -> None:
    if x.dim() >= 3 and x.numel() > _BLOCK:
        for j in range(x.shape[1]):
            _round_(x[:, j], dims, r)
        return
    g = x.float().reshape(tuple(dims) + tuple(x.shape[1:]))
    x.copy_(g.mean(dim=r, keepdim=True).expand_as(g).reshape(x.shape))


def aggregate_(state: Dict[str, torch.Tensor], dims: Sequence[int]) -> None:
    """Every round of the grid, in order, on every leaf, in place."""
    for r in range(len(dims)):
        for x in state.values():
            _round_(x, dims, r)
