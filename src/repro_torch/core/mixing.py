"""Mixing dynamics of MAR (paper §2.3, Eq. 1): theory and estimators.

For peers randomly partitioned each iteration into ``r`` groups that
average locally, the expected distortion from the global mean contracts
per averaging iteration by

    factor(N, r) = (r - 1) / N + r / N^2                       (Eq. 1)

so after T iterations E[dist_T] = factor^T * dist_0, where
dist = (1/N) sum_i ||theta_i - theta_bar||^2. The deterministic grid
schedule mixes faster (exact in d rounds when N = M^d).

Port of the JAX package's ``repro/core/mixing.py``; the draws are numpy
(``np.random.Generator``), as in the reference.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def contraction_factor(n_peers: int, n_groups: int) -> float:
    """Eq. 1 per-iteration contraction of expected average distortion."""
    r, n = n_groups, n_peers
    return (r - 1) / n + r / (n * n)


def predicted_distortion(dist0: float, n_peers: int, n_groups: int,
                         iterations: int) -> float:
    return dist0 * contraction_factor(n_peers, n_groups) ** iterations


def distortion(values: torch.Tensor) -> float:
    """(1/N) sum_i ||x_i - x_bar||^2 for stacked peer values [N, ...]."""
    mean = values.mean(dim=0, keepdim=True)
    return float(torch.sum(torch.square(values - mean)) / values.shape[0])


def random_group_average(values: torch.Tensor, n_groups: int,
                         rng: np.random.Generator) -> torch.Tensor:
    """One iteration of the random-partition averaging model behind Eq. 1."""
    n = values.shape[0]
    perm = rng.permutation(n)
    groups = np.array_split(perm, n_groups)
    out = values.detach().cpu().numpy().copy()
    for g in groups:
        out[g] = np.mean(out[g], axis=0)
    return torch.as_tensor(out, device=values.device)


def empirical_contraction(n_peers: int, n_groups: int, iterations: int,
                          dim: int = 64, trials: int = 32, seed: int = 0
                          ) -> Tuple[float, float]:
    """(empirical mean factor, Eq. 1 prediction) per iteration."""
    rng = np.random.default_rng(seed)
    factors = []
    for _ in range(trials):
        x = torch.as_tensor(
            rng.normal(size=(n_peers, dim)).astype(np.float32))
        d0 = distortion(x)
        for _ in range(iterations):
            x = random_group_average(x, n_groups, rng)
        dt = distortion(x)
        factors.append((dt / max(d0, 1e-30)) ** (1.0 / iterations))
    return float(np.mean(factors)), contraction_factor(n_peers, n_groups)
