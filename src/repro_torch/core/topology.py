"""Analytic communication-cost models for every technique (paper §2.2, §3).

A copy of the JAX package's ``repro/core/topology.py``: the formulas
are numpy and unchanged; only :func:`pytree_bytes` is rewritten over
the port's nested dicts of tensors.

Since the discrete-event network layer (DESIGN.md §9) these closed
forms are the cross-checked *oracles*: the ledger is fed from measured
transport transcripts (``core/transport.py`` + ``runtime/network.py``),
and ``tests/test_network.py`` pins transcript bytes equal to these
formulas in the no-loss case for every registered technique.

Byte accounting per FL iteration with ``n`` *aggregating* peers and model
state of ``model_bytes`` (theta + momentum, both averaged by Alg. 1):

* ``fedavg`` — upload + download per peer: ``2 n B``            (O(N))
* ``ar``     — all-to-all, every peer sends to every other:
               ``n (n-1) B``                                    (O(N^2))
* ``rdfl``   — Galaxy-style ring circulation of full models:
               every model traverses the ring: ``n (n-1) B``    (O(N^2));
               differs from AR-FL in latency (n-1 sequential hops vs 1)
* ``mar``    — G rounds, group size M, naive within-group exchange
               (each peer sends its state to M-1 group mates):
               ``n G (M-1) B``                                  (O(N log N))
* ``gossip`` — push-sum ring, one partner per round over
               ceil(log2 n) rounds: ``n ceil(log2 n) B``        (O(N log N))
* ``hierarchical`` — two-tier FedAvg over the leaf MAR groups
               (peers <-> group leader, leaders <-> rendezvous):
               ``2 (n + ceil(n/M)) B``                          (O(N))

The MAR constant reproduces the paper's headline numbers: at N=125
(M=5, G=3): 125*3*4 = 1500 model-units vs AR's 125*124 = 15500 — the
"up to 10x" of Fig. 1 — and the Fig. 11 approximate-aggregation setting
(M=3, G=4) gives 125*4*2 = 1000, the reported 33% reduction. A
``butterfly`` mode (reduce-scatter + all-gather inside each group,
2(M-1)/M per peer per round — what Moshpit-SGD itself implements) is the
beyond-paper option benchmarked in EXPERIMENTS.md §Perf.

MKD adds, per KD-enabled iteration, G rounds of *model-only* exchange
(students pull candidate-teacher weights; Alg. 3) plus logit traffic.

Control plane: DHT coordination is O(N log N) small messages/iteration
(§2.2) — tracked separately, negligible vs data plane.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np

from repro_torch.core.moshpit import GridPlan
from repro_torch.tree import tree_leaves

PyTree = Any

DHT_MSG_BYTES = 64  # one Kademlia get/store record (key+value+routing)


def pytree_bytes(tree: PyTree) -> int:
    """Bytes held by every tensor leaf of a nested dict."""
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(tree)))


def mar_bytes(n: int, plan: GridPlan, model_bytes: int,
              num_rounds: Optional[int] = None,
              mode: str = "naive",
              mask: Optional[np.ndarray] = None) -> int:
    """Data-plane bytes for one MAR aggregation over ``n`` active peers.

    Mask-aware: an active peer only exchanges with the *active* members
    of its round-``g`` group — a churned mate receives no send. With
    ``mask`` given the accounting is exact per group (``sum_g
    k_g (k_g - 1)`` naive-mode sends), byte-identical to the transport
    transcript in the no-loss case (``tests/test_network.py``). With
    only the count ``n`` the per-group split is unknown, so the
    active-pair expectation ``(n-1)/(N-1)`` scales the full-grid
    formula (the old code billed every sender for ``M-1`` mates even
    when the caller passed a churn-reduced ``n`` — overcounting sends
    to dropped peers). At full participation both paths reduce to the
    paper's ``n G (M-1) B``.
    """
    rounds = plan.depth if num_rounds is None else num_rounds
    total = 0.0
    if mask is not None:
        mask = np.asarray(mask)[:plan.n_peers] > 0
        for g in range(rounds):
            for group in plan.groups_for_round(g % plan.depth):
                real = group[group < plan.n_peers]
                k = int(mask[real].sum())
                if k < 2:
                    continue
                if mode == "butterfly":
                    total += 2.0 * (k - 1) * model_bytes
                else:
                    total += k * (k - 1) * model_bytes
        return int(total)
    n_total = plan.n_peers
    pair_frac = 1.0 if n >= n_total or n_total <= 1 else \
        max(n - 1, 0) / (n_total - 1)
    for g in range(rounds):
        m = plan.dims[g % plan.depth]
        if mode == "butterfly":
            per_peer = 2.0 * (m - 1) / m
        else:
            per_peer = float(m - 1)
        total += n * per_peer * pair_frac * model_bytes
    return int(total)


def hierarchical_bytes(n: int, plan: GridPlan, model_bytes: int,
                       mask: Optional[np.ndarray] = None) -> int:
    """Two-tier FedAvg bytes: ``2 (n + #groups) B``.

    The measured transcript bills the leaf groups that are *actually
    nonempty* under the churn mask (an active member anywhere keeps its
    group's leader <-> rendezvous hop alive). With ``mask`` given the
    count is exact — byte-identical to the transport transcript. With
    only the active count ``n`` the per-group split is unknown, and no
    count-only formula can be exact: ``ceil(n / M)`` is the *minimum*
    possible nonempty-group count (actives packed into as few leaf
    groups as possible), so the count-only path is a documented lower
    bound on the measured bytes — pinned by the inequality test in
    ``tests/test_transport.py``. At full participation both paths
    coincide (every group nonempty, ``ceil(N / M)`` of them).
    """
    if mask is not None:
        active = np.asarray(mask)[:plan.n_peers] > 0
        n_act, n_groups = 0, 0
        for group in plan.groups_for_round(plan.depth - 1):
            k = int(active[group[group < plan.n_peers]].sum())
            if k:
                n_groups += 1
                n_act += k
        return int(2 * (n_act + n_groups) * model_bytes)
    n_groups = max(1, math.ceil(n / plan.dims[-1]))
    return int(2 * (n + n_groups) * model_bytes)


def iteration_bytes(technique: str, n: int, model_bytes: int,
                    plan: Optional[GridPlan] = None,
                    num_rounds: Optional[int] = None,
                    use_kd: bool = False, kd_logit_bytes: int = 0,
                    mode: str = "naive",
                    mask: Optional[np.ndarray] = None) -> int:
    """Total data-plane bytes of one FL iteration.

    ``mask`` (the aggregation mask A_t) makes the MAR and hierarchical
    entries exact per group under churn; the remaining techniques'
    formulas depend only on the active count ``n``.
    """
    if technique == "fedavg":
        data = 2 * n * model_bytes
    elif technique in ("ar", "rdfl"):
        data = n * max(n - 1, 0) * model_bytes
    elif technique == "mar":
        assert plan is not None
        data = mar_bytes(n, plan, model_bytes, num_rounds, mode, mask)
    elif technique == "gossip":
        rounds = (num_rounds if num_rounds is not None
                  else max(1, math.ceil(math.log2(max(n, 2)))))
        data = rounds * n * model_bytes
    elif technique == "hierarchical":
        assert plan is not None
        data = hierarchical_bytes(n, plan, model_bytes, mask)
    else:
        raise ValueError(technique)
    if use_kd and technique == "mar":
        # students pull group-mates' thetas (half the (theta, m) state)
        data += mar_bytes(n, plan, model_bytes // 2, num_rounds, "naive",
                          mask)
        rounds = plan.depth if num_rounds is None else num_rounds
        data += n * rounds * kd_logit_bytes
    return int(data)


def iteration_latency_rounds(technique: str, n: int,
                             plan: Optional[GridPlan] = None,
                             num_rounds: Optional[int] = None) -> int:
    """Sequential communication rounds per iteration (latency proxy)."""
    if technique == "fedavg":
        return 2                      # upload, download
    if technique == "ar":
        return 1                      # fully parallel exchange
    if technique == "rdfl":
        return max(n - 1, 1)          # ring circulation
    if technique == "mar":
        return plan.depth if num_rounds is None else num_rounds
    if technique == "gossip":
        return (num_rounds if num_rounds is not None
                else max(1, math.ceil(math.log2(max(n, 2)))))
    if technique == "hierarchical":
        return 4                      # up/down within groups, up/down leaders
    raise ValueError(technique)


def control_plane_bytes(n: int) -> int:
    """DHT coordination per iteration: O(N log N) lookups (§2.2)."""
    return int(n * max(math.log2(max(n, 2)), 1.0) * DHT_MSG_BYTES)


def complexity_table(model_bytes: int, peer_counts=(16, 64, 125, 512, 4096)
                     ) -> "list[dict]":
    """Fig. 1-style scaling table across techniques."""
    from repro_torch.core.moshpit import plan_grid
    rows = []
    for n in peer_counts:
        plan = plan_grid(n)
        for tech in ("fedavg", "hierarchical", "mar", "gossip", "rdfl",
                     "ar"):
            rows.append(dict(
                technique=tech, n_peers=n,
                bytes=iteration_bytes(tech, n, model_bytes, plan),
                rounds=iteration_latency_rounds(tech, n, plan),
                control_bytes=control_plane_bytes(n) if tech == "mar" else 0,
            ))
    return rows
