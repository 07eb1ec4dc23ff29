"""Damped momentum SGD (Reddi et al., 2020) — the paper's local optimizer.

Update (the "damped" form used by FedOpt's ClientOpt and by MAR-FL):

    m_t = mu * m_{t-1} + (1 - mu) * g_t
    theta_t = theta_{t-1} - eta * m_t

Momentum vectors are first-class federation state: MAR averages (theta, m)
jointly (Alg. 1 line 10), so ``m`` lives in the same tree structure as
the params. Port of the JAX package's ``repro/optim/sgdm.py``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.tree import Tree, tree_map


def momentum_sgd_init(params: Tree, dtype: torch.dtype = torch.float32
                      ) -> Tree:
    """Zero momentum, f32 by default."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                          device=p.device), params)


def momentum_sgd_step(params: Tree, momentum: Tree, grads: Tree,
                      lr: float, mu: float = 0.9) -> Tuple[Tree, Tree]:
    """Update in f32, store momentum back in its own dtype."""
    new_m = tree_map(
        lambda m, g: (mu * m.float() + (1.0 - mu) * g.float()).to(m.dtype),
        momentum, grads)
    new_p = tree_map(lambda p, m: (p.float() - lr * m.float()).to(p.dtype),
                     params, new_m)
    return new_p, new_m
