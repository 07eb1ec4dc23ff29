"""Frozen copies of the text task and its federated split: the
20-class anisotropic Gaussian features of 768 dimensions that stand in
for frozen-DistilBERT CLS features of 20 Newsgroups, Dirichlet label
skew over the peers (the paper's LDA, alpha = 1), and each peer's rows.
NumPy ``default_rng`` throughout, so the arrays are bit-identical to
those the port derives from the same seed."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np


def text_task(cfg: Dict[str, Any], seed: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """The training split: x [num_train, feature_dim] f32, y int32."""
    rng = np.random.default_rng(seed)
    c, f = cfg["num_classes"], cfg["feature_dim"]
    means = rng.normal(size=(c, f))
    means = cfg["margin"] * means / np.linalg.norm(means, axis=1,
                                                   keepdims=True)
    scales = 0.5 + rng.random(f)
    y = rng.integers(0, c, size=cfg["num_train"])
    x = means[y] + rng.normal(size=(cfg["num_train"], f)) * scales
    return x.astype(np.float32), y.astype(np.int32)


def dirichlet_partition(labels: np.ndarray, n_peers: int, alpha: float,
                        seed: int, min_per_peer: int = 2
                        ) -> List[np.ndarray]:
    """Per class, shares of the peers from Dir(alpha), cut in order;
    every peer gets at least ``min_per_peer`` rows."""
    rng = np.random.default_rng(seed)
    shards: List[List[int]] = [[] for _ in range(n_peers)]
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        p = rng.dirichlet(np.full(n_peers, alpha))
        cuts = np.floor(np.cumsum(p) * len(idx)).astype(int)
        prev = 0
        for peer, cut in enumerate(cuts):
            shards[peer].extend(idx[prev:cut].tolist())
            prev = cut
        shards[-1].extend(idx[prev:].tolist())
    for peer in range(n_peers):
        while len(shards[peer]) < min_per_peer:
            donor = int(np.argmax([len(s) for s in shards]))
            shards[peer].append(shards[donor].pop())
    return [np.asarray(sorted(s), np.int64) for s in shards]


def peer_rows(cfg: Dict[str, Any], n_peers: int, batch: int, seed: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Each peer's rows: x [N, rows, F] f32 and y [N, rows] int64, the
    same number of rows for every peer (the median shard, at least one
    batch), drawn from its shard."""
    x, y = text_task(cfg, seed)
    shards = dirichlet_partition(y, n_peers, cfg["alpha"], seed)
    rng = np.random.default_rng(seed + 1)
    rows = max(batch, int(np.median([len(s) for s in shards])))
    xs, ys = [], []
    for s in shards:
        take = rng.choice(s, size=rows, replace=len(s) < rows)
        xs.append(x[take])
        ys.append(y[take])
    return np.stack(xs), np.stack(ys).astype(np.int64)
