"""AdamW on nested-dict trees of tensors.

Port of the JAX package's ``repro/optim/adamw.py``: functional, with
state (mu, nu, count); params may be bf16 with f32 moments. The update
runs in f32 and stores params back in their own dtype.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.tree import Tree, tree_leaves, tree_map


class AdamWState(NamedTuple):
    mu: Tree
    nu: Tree
    count: torch.Tensor


def adamw_init(params: Tree) -> AdamWState:
    """Zero f32 moments and a zero int32 step count."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def adamw_step(params: Tree, state: AdamWState, grads: Tree, lr: float,
               b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
               weight_decay: float = 0.1) -> Tuple[Tree, AdamWState]:
    count = state.count + 1
    c = count.float()
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c

    new_mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state.mu, grads)
    new_nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g.float().square(),
                      state.nu, grads)

    def upd(p, m, v):
        step = (m / bc1) / ((v / bc2).sqrt() + eps)
        step = step + weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype)

    new_p = tree_map(upd, params, new_mu, new_nu)
    return new_p, AdamWState(new_mu, new_nu, count)
