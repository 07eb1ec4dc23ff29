"""Dirichlet non-i.i.d. federated partitioning (paper's LDA, alpha=1.0).

For each class c, draw p_c ~ Dir(alpha * 1_N) over the N peers and
multinomially assign that class's examples — the standard label-skew
construction the paper calls "Latent Dirichlet Allocation (alpha=1.0)".
alpha -> inf recovers i.i.d.; small alpha concentrates classes on few
peers.

A copy of the JAX package's ``repro/data/partition.py`` (numpy) with its imports
rewritten; tests hold it equal to the reference.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_peers: int, alpha: float = 1.0,
                        seed: int = 0, min_per_peer: int = 2
                        ) -> List[np.ndarray]:
    """Returns per-peer index arrays covering all examples exactly once."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    shards: List[List[int]] = [[] for _ in range(n_peers)]
    for c in classes:
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        p = rng.dirichlet(np.full(n_peers, alpha))
        # proportional contiguous split (largest-remainder rounding)
        cuts = np.floor(np.cumsum(p) * len(idx)).astype(int)
        prev = 0
        for peer, cut in enumerate(cuts):
            shards[peer].extend(idx[prev:cut].tolist())
            prev = cut
        shards[-1].extend(idx[prev:].tolist())
    # guarantee every peer has a floor of examples (steal from richest)
    sizes = [len(s) for s in shards]
    for peer in range(n_peers):
        while len(shards[peer]) < min_per_peer:
            donor = int(np.argmax([len(s) for s in shards]))
            shards[peer].append(shards[donor].pop())
    return [np.asarray(sorted(s), np.int64) for s in shards]


def iid_partition(n_examples: int, n_peers: int, seed: int = 0
                  ) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_examples)
    return [np.sort(p) for p in np.array_split(perm, n_peers)]


def partition_stats(shards: List[np.ndarray], labels: np.ndarray
                    ) -> Dict[str, float]:
    """Heterogeneity diagnostics: size spread + mean label-dist TV from
    the global distribution."""
    n_classes = int(labels.max()) + 1
    global_p = np.bincount(labels, minlength=n_classes) / len(labels)
    tvs, sizes = [], []
    for s in shards:
        sizes.append(len(s))
        local = np.bincount(labels[s], minlength=n_classes) / max(len(s), 1)
        tvs.append(0.5 * np.abs(local - global_p).sum())
    return {
        "mean_tv": float(np.mean(tvs)),
        "max_tv": float(np.max(tvs)),
        "min_size": int(np.min(sizes)),
        "max_size": int(np.max(sizes)),
    }
