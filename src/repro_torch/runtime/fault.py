"""Fault tolerance and straggler mitigation for 1000+ node fleets.

MAR-FL's core property — a dropped peer only corrupts its own group,
and incomplete group means still converge (paper §3.2) — is the
fault-tolerance mechanism. This module supplies the fleet-side glue:

* :class:`HealthTracker` — per-peer heartbeats; marks peers dead after
  ``timeout_s`` and yields per-iteration participation masks (the same
  masks ``mar_aggregate_*`` consumes, so a dead peer is excluded from
  its group's mean instead of stalling the step — dropout semantics).
* :class:`StragglerPolicy` — deadline-based: a peer whose local update
  exceeds mean + k*std of recent durations gets masked for the current
  aggregation round only (it rejoins next iteration with the group
  average, since every MAR round *broadcasts* the mean back).
* :func:`elastic_replan` — on permanent capacity change, re-factorize
  the MAR grid for the new peer count and remap checkpointed state
  (``Checkpointer.restore_elastic``) — restart-free for sim peers,
  restart-with-checkpoint for mesh peers.

On a real multi-pod deployment the heartbeat source is the cluster
manager; here it is fed by the simulation loop and by tests that
script failure sequences.

A copy of the JAX package's ``repro/runtime/fault.py`` (numpy) with its imports
rewritten; tests hold it equal to the reference.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.moshpit import GridPlan, plan_grid


@dataclasses.dataclass
class PeerHealth:
    last_heartbeat: float
    durations: Deque[float]
    alive: bool = True


class HealthTracker:
    def __init__(self, n_peers: int, timeout_s: float = 30.0,
                 history: int = 16):
        self.timeout_s = timeout_s
        self.peers: Dict[int, PeerHealth] = {
            i: PeerHealth(time.monotonic(), deque(maxlen=history))
            for i in range(n_peers)
        }

    def heartbeat(self, peer: int, duration_s: Optional[float] = None,
                  now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        p = self.peers[peer]
        p.last_heartbeat = now
        p.alive = True
        if duration_s is not None:
            p.durations.append(duration_s)

    def mark_failed(self, peer: int):
        self.peers[peer].alive = False

    def sweep(self, now: Optional[float] = None) -> List[int]:
        """Mark timed-out peers dead; returns newly-dead peer ids."""
        now = time.monotonic() if now is None else now
        dead = []
        for i, p in self.peers.items():
            if p.alive and now - p.last_heartbeat > self.timeout_s:
                p.alive = False
                dead.append(i)
        return dead

    def alive_mask(self) -> np.ndarray:
        return np.array([float(p.alive) for p in self.peers.values()],
                        np.float32)


class StragglerPolicy:
    """Deadline = median + k * scaled-MAD of recent local-update times.

    Robust statistics matter here: a straggler's own duration must not
    inflate the deadline that is supposed to catch it (mean/std would be
    dragged by the outlier). ``mask(durations)`` returns the aggregation
    mask for this iteration: stragglers are excluded from MAR (their
    group averages without them — the paper's dropout path) instead of
    blocking the barrier.
    """

    def __init__(self, k_std: float = 3.0, min_deadline_s: float = 1.0):
        self.k_std = k_std
        self.min_deadline_s = min_deadline_s

    def deadline(self, durations: np.ndarray) -> float:
        if durations.size == 0:
            return self.min_deadline_s
        med = float(np.median(durations))
        mad = float(np.median(np.abs(durations - med))) * 1.4826
        spread = max(mad, 0.05 * max(med, 1e-9))   # floor for zero-MAD
        return max(self.min_deadline_s, med + self.k_std * spread)

    def mask(self, durations: np.ndarray) -> np.ndarray:
        dl = self.deadline(durations)
        return (durations <= dl).astype(np.float32)


def elastic_replan(old_plan: GridPlan, new_n_peers: int) -> GridPlan:
    """Re-factorize the MAR grid after a permanent capacity change.

    Keeps the old group size when it still factors the new count
    (minimal schedule churn), otherwise replans from scratch.
    """
    m = old_plan.dims[0]
    if all(d == m for d in old_plan.dims):
        d = 0
        n = new_n_peers
        while n % m == 0:
            n //= m
            d += 1
        if n == 1 and d >= 1:
            return GridPlan(new_n_peers, (m,) * d)
    return plan_grid(new_n_peers)


def failure_impact(plan: GridPlan, failed: List[int]) -> Dict[str, float]:
    """How much of the fleet a failure set touches, per MAR round —
    quantifies the paper's 'dropouts only affect a single group'."""
    out = {}
    for g in range(plan.depth):
        groups = plan.groups_for_round(g)
        touched = sum(1 for grp in groups
                      if any(p in set(grp.tolist()) for p in failed))
        out[f"round_{g}_groups_touched"] = touched / max(len(groups), 1)
    return out
