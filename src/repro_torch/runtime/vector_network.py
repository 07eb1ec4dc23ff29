"""Vectorized large-N event engine: batched round timing in numpy.

The heap-ordered :class:`~repro_torch.runtime.network.NetworkSim` walks one
Python loop iteration and one heap push/pop per message — O(messages ·
log messages) interpreter work that caps every benchmark near N=125.
This module times the *same* plans with numpy segment ops, one batch
per round, and registers the result as the ``"vector_sim"`` transport
backend, scaling the simulation to N=65536 (ROADMAP: three orders of
magnitude past the heap engine).

The timing model is the heap engine's, computed in array form and
bit-for-bit equal on the overlap (``tests/test_vector_network.py``
pins every technique at N <= 125):

* *uplink serialization* — within a round, a sender's transmissions
  drain its uplink in plan order. The per-sender start times are
  seeded sequential prefix sums: messages are stably sorted by sender,
  packed into a ``[senders, max_fanout]`` rectangle whose column 0 is
  the sender's ready time, and one ``np.cumsum(axis=1)`` reproduces
  the heap engine's chain ``ready ⊕ o_1 ⊕ o_2 ...`` exactly (cumsum
  accumulates sequentially; padding zeros are exact no-ops).
* *arrival* — send start + transfer at the slower endpoint + both
  endpoints' propagation, same expression, same evaluation order.
* *loss* — one ``rng.random(k)`` per round consumes the identical
  Generator stream as the heap engine's per-message draws (numpy fills
  batched doubles from the same bit stream), so seeded drops — and the
  ``demote_lost_senders`` masks downstream — match message for
  message.
* *barriers* — per-node ready times advance to max(uplink drain,
  last surviving arrival); rounds chain through those ready times, so
  group waits, ring hops and hierarchy barriers emerge exactly as in
  the heap engine.

For the two techniques whose *plans* are O(N^2) messages (all-to-all
AR-FL, and RDFL's N-1 ring hops) the module also provides closed-form
engines (:func:`all_to_all_seconds`, :func:`ring_seconds`) that apply
the same model without materializing messages — benchmarks use them
past a message budget, cross-checked against the materialized engine
at overlapping sizes.

A copy of the JAX package's ``repro/runtime/vector_network.py`` (numpy) with its imports
rewritten; tests hold it equal to the reference.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.transport import (ArrayMessagePlan, Message, MessagePlan,
                                  _group_rows, _leaf_groups, _valid_slots)
from repro_torch.runtime.network import LinkModel, build_link_model
from repro_torch.runtime.transport_base import (LinkAccounting, Transcript,
                                          Transport, register_transport)

__all__ = ["VectorNetworkSim", "all_to_all_seconds", "ring_seconds",
           "mar_group_seconds", "group_gather_seconds",
           "group_broadcast_seconds"]


def _extended_links(links: LinkModel, n_nodes: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
    """Per-node link arrays with infrastructure rows appended:
    unbounded bandwidth, zero latency, lossless."""
    n_real = links.n_peers
    up = np.full(n_nodes, np.inf)
    down = np.full(n_nodes, np.inf)
    lat = np.zeros(n_nodes)
    loss = np.zeros(n_nodes)
    up[:n_real] = links.up
    down[:n_real] = links.down
    lat[:n_real] = links.lat
    loss[:n_real] = links.loss
    return up, down, lat, loss


@register_transport
class VectorNetworkSim(Transport):
    """Array-native message timing over a :class:`LinkModel` — the
    ``"vector_sim"`` transport backend.

    Accepts :class:`ArrayMessagePlan` directly (the large-N hot path)
    or any :class:`MessagePlan` (converted once, losslessly). The
    transcript schema, clock accumulation, resize semantics and
    ``from_config`` surface are identical to the heap ``"sim"``
    backend, so ``FederationConfig(transport="vector_sim")`` drops in —
    the ``GroupSizeController``, ``CommLedger`` and
    ``record_transcript`` consumers run unchanged.
    """

    name = "vector_sim"
    plan_format = "array"

    def __init__(self, n_peers: int, profile: str = "uniform",
                 seed: int = 0,
                 link_params: Optional[Dict[str, Any]] = None,
                 links: Optional[LinkModel] = None):
        self.links = links if links is not None else build_link_model(
            profile, n_peers, seed=seed, **(link_params or {}))
        self.seed = seed
        self.clock = 0.0
        self.iterations = 0

    @classmethod
    def from_config(cls, n_peers, *, profile=None, seed=0,
                    link_params=None, **kwargs):
        return cls(n_peers, profile=profile or "uniform", seed=seed,
                   link_params=link_params, **kwargs)

    @property
    def n_peers(self) -> int:
        return self.links.n_peers

    @property
    def lossless(self) -> bool:
        return not self.links.loss.any()

    def resize(self, new_n: int) -> None:
        self.links.resize(new_n)

    # ------------------------------------------------------------------
    def run(self, plan: Any,
            compute_s: Optional[np.ndarray] = None,
            payloads: Optional[Any] = None) -> Transcript:
        """Simulate one iteration's plan, one vector batch per round."""
        if not isinstance(plan, ArrayMessagePlan):
            plan = ArrayMessagePlan.from_plan(plan)
        links = self.links
        n_real = links.n_peers
        n_nodes = max(plan.n_nodes, n_real)
        rng = np.random.default_rng(
            (self.seed + 1) * 48611 + self.iterations)
        up, down, lat, loss = _extended_links(links, n_nodes)

        ready = np.zeros(n_nodes)
        if compute_s is not None:
            ready[:min(n_real, len(compute_s))] = compute_s[:n_real]
        tr = Transcript(technique=plan.technique,
                        lost_senders=np.zeros(n_real, bool))
        acct = LinkAccounting(n_nodes, n_real)

        pairwise = getattr(links, "has_pair_terms", False)

        for r in range(plan.n_rounds):
            src, dst, nb = plan.round_arrays(r)
            tr.n_messages += src.size
            rbytes = float(nb.sum())
            tr.total_bytes += rbytes
            nz = src != dst                  # loopback: billed, instant
            s, d, b = src[nz], dst[nz], nb[nz]
            if s.size == 0:
                acct.add_batch(src, dst, nb)
                tr.bytes_by_round.append(rbytes)
                tr.round_s.append(float(ready.max()))
                continue
            # pairwise WAN terms (regions profile): bandwidth cap +
            # extra latency on cross-region real-peer pairs; the
            # neutral (inf, 0.0) fill keeps every other profile's
            # arithmetic — and transcript — bit-identical
            cap = np.full(s.size, np.inf)
            xlat = np.zeros(s.size)
            if pairwise:
                both = (s < n_real) & (d < n_real)
                pc, pl = links.pair_terms(s[both], d[both])
                cap[both] = pc
                xlat[both] = pl
            # seeded Bernoulli loss, one batch on the heap engine's
            # exact draw stream (message order, loopbacks skipped)
            p_loss = 1.0 - (1.0 - loss[s]) * (1.0 - loss[d])
            lost = rng.random(s.size) < p_loss
            senders, drain, arr_plan_order, start_plan_order = \
                _timed_round(ready, s, d, b, up, down, lat, cap, xlat)
            # drain: every node advances to max(ready, uplink busy);
            # survivors' arrivals then lift their receiver
            new_ready = ready.copy()
            new_ready[senders] = np.maximum(ready[senders], drain)
            kept = ~lost
            np.maximum.at(new_ready, d[kept], arr_plan_order[kept])
            # per-message effective seconds (arrival - send start) in
            # plan order; loopbacks stay 0.0 — same billing as the
            # heap engine's acct.add(..., arrival - start)
            secs = np.zeros(src.size)
            secs[nz] = arr_plan_order - start_plan_order
            acct.add_batch(src, dst, nb, secs)
            ready = new_ready
            tr.bytes_by_round.append(rbytes)
            tr.round_s.append(float(ready.max()))
            if lost.any():
                ls, ld, lb = s[lost], d[lost], b[lost]
                tr.dropped.extend(
                    Message(int(a), int(bb), float(c))
                    for a, bb, c in zip(ls, ld, lb))
                tr.lost_senders[ls[ls < n_real]] = True

        tr.peer_finish_s = ready[:n_real].copy()
        tr.iteration_s = float(ready.max()) if n_nodes else 0.0
        acct.finalize(tr)
        self._split_kd_bytes(tr, plan)
        self.clock += tr.iteration_s
        self.iterations += 1
        return tr


def _timed_round(ready: np.ndarray, s: np.ndarray, d: np.ndarray,
                 b: np.ndarray, up: np.ndarray, down: np.ndarray,
                 lat: np.ndarray, cap: np.ndarray, xlat: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                            np.ndarray]:
    """Time one round of non-loopback messages (plan order) against
    per-node ``ready`` times.

    Uplink serialization: stable sort by sender packs each sender's
    messages (plan order preserved) into one row of a
    ``[senders, fanout+1]`` rectangle seeded with its ready time; a
    single sequential cumsum along the row is the heap engine's
    ``ready ⊕ o_1 ⊕ o_2 ...`` chain, bit for bit.

    Returns ``(senders, drain, arrival, start)`` — the unique sender
    ids with their uplink-busy-until times, and per-message arrival /
    send-start times back in plan order. Callers apply loss masks,
    drains and receiver maxima (see :meth:`VectorNetworkSim.run`); the
    superpeer engine reuses this for its materialized rounds so both
    engines share one arithmetic.
    """
    occ = b / np.minimum(up[s], cap)  # inf uplink -> 0.0
    order = np.argsort(s, kind="stable")
    ss = s[order]
    boundary = np.empty(ss.size, bool)
    boundary[0] = True
    np.not_equal(ss[1:], ss[:-1], out=boundary[1:])
    seg_first = np.flatnonzero(boundary)
    seg_id = np.cumsum(boundary) - 1
    pos = np.arange(ss.size) - seg_first[seg_id]
    n_seg, fan = seg_first.size, int(pos.max()) + 1
    rect = np.zeros((n_seg, fan + 1))
    senders = ss[seg_first]
    rect[:, 0] = ready[senders]
    rect[seg_id, pos + 1] = occ[order]
    chain = np.cumsum(rect, axis=1)
    ds = d[order]
    start = chain[seg_id, pos]           # send start, sorted order
    arrival = start + (b[order] / np.minimum(
        np.minimum(up[ss], down[ds]), cap[order]))
    arrival = arrival + lat[ss]
    arrival = arrival + lat[ds]
    arrival = arrival + xlat[order]      # last, as the heap adds it
    arr_plan_order = np.empty(s.size)
    arr_plan_order[order] = arrival
    start_plan_order = np.empty(s.size)
    start_plan_order[order] = start
    return senders, chain[:, fan], arr_plan_order, start_plan_order


# ---------------------------------------------------------------------------
# closed-form group rounds (the superpeer engine's intra-cluster tier)
# ---------------------------------------------------------------------------
#
# Each ``_closed_*_round`` advances per-node ready times through one
# structured round *without materializing its messages*, reproducing
# ``_timed_round``'s arithmetic term by term on per-peer link
# parameters (no pairwise WAN costs, no loss — the superpeer engine
# checks both and falls back to the materialized path otherwise):
#
# * a sender's k-th transmission starts after k-1 sequential uplink
#   drains from its ready time — reproduced by accumulating ``occ``
#   in the same member order the planners emit (cumsum over identical
#   addends is bitwise the same as the rectangle chain);
# * ``min(x, inf)`` and ``+ 0.0`` are bitwise no-ops, so dropping the
#   neutral pairwise cap/xlat terms changes nothing;
# * drains apply before receiver maxima, receivers take the max over
#   their arrivals — order-independent, so group-vectorizing across
#   lanes is exact.
#
# ``sink(src, dst, secs)`` receives each vector of timed messages
# (arrival - send start, plan semantics) so the engine can feed
# ``LinkAccounting`` without re-deriving anything; loopbacks are the
# caller's to bill (0.0 s, as both event engines do).

def _row_counts(vrows: np.ndarray) -> np.ndarray:
    """Valid members per row, as column adds — numpy's axis-1 bool
    reduction is an order of magnitude slower at 2^16 rows."""
    kk = vrows[:, 0].astype(np.int64)
    for j in range(1, vrows.shape[1]):
        kk = kk + vrows[:, j]
    return kk


def _closed_allpairs_round(ready: np.ndarray, rows: np.ndarray,
                           vrows: np.ndarray, nbytes: float,
                           up: np.ndarray, down: np.ndarray,
                           lat: np.ndarray,
                           sink=None, safe: Optional[np.ndarray] = None,
                           kk: Optional[np.ndarray] = None) -> np.ndarray:
    """One MAR all-pairs group round: every valid member of every row
    sends ``nbytes`` to each other valid member, member order.
    ``safe`` / ``kk`` let callers pass precomputed safe-index rows and
    per-row valid counts (the superpeer engine caches them)."""
    g, m = rows.shape
    if safe is None:
        safe = np.where(vrows, rows, 0)
    new_ready = ready.copy()
    if kk is None:
        kk = _row_counts(vrows)
    # per-receiver-lane running max of arrivals, filled sender by sender
    arr_max = np.full((g, m), -np.inf)
    drain_lanes: List[Tuple[np.ndarray, np.ndarray]] = []
    for i in range(m):
        sends = vrows[:, i] & (kk >= 2)
        if not sends.any():
            continue
        s_idx = safe[:, i]
        up_s, lat_s = up[s_idx], lat[s_idx]
        occ = nbytes / up_s
        acc = ready[s_idx]                  # fancy index -> fresh copy
        for j in range(m):
            if j == i:
                continue
            pair = sends & vrows[:, j]
            if not pair.any():
                continue
            d_idx = safe[:, j]
            arr = acc + (nbytes / np.minimum(up_s, down[d_idx]))
            arr = arr + lat_s
            arr = arr + lat[d_idx]
            if sink is not None:
                sink(s_idx[pair], d_idx[pair], (arr - acc)[pair])
            arr_max[:, j] = np.where(pair, np.maximum(arr_max[:, j],
                                                      arr),
                                     arr_max[:, j])
            acc = np.where(pair, acc + occ, acc)
        drain_lanes.append((s_idx[sends], acc[sends]))
    for s_ids, busy in drain_lanes:         # drains first, as run() does
        new_ready[s_ids] = np.maximum(ready[s_ids], busy)
    for j in range(m):
        got = arr_max[:, j] > -np.inf
        if got.any():
            d_ids = safe[got, j]
            new_ready[d_ids] = np.maximum(new_ready[d_ids],
                                          arr_max[got, j])
    return new_ready


def _closed_leaf_gather_round(ready: np.ndarray, rows: np.ndarray,
                              vrows: np.ndarray, leaders: np.ndarray,
                              nbytes: float, up: np.ndarray,
                              down: np.ndarray, lat: np.ndarray,
                              sink=None) -> np.ndarray:
    """Hierarchical up round: every valid member sends ``nbytes`` to
    its row's leader (the leader's own message is a loopback — billed
    by the caller, never timed)."""
    g, m = rows.shape
    safe = np.where(vrows, rows, 0)
    new_ready = ready.copy()
    lead_max = np.full(g, -np.inf)
    for j in range(m):
        pair = vrows[:, j] & (safe[:, j] != leaders)
        if not pair.any():
            continue
        s_idx = safe[:, j]
        start = ready[s_idx]
        arr = start + (nbytes / np.minimum(up[s_idx], down[leaders]))
        arr = arr + lat[s_idx]
        arr = arr + lat[leaders]
        if sink is not None:
            sink(s_idx[pair], leaders[pair], (arr - start)[pair])
        lead_max = np.where(pair, np.maximum(lead_max, arr), lead_max)
        # single message per sender: drain = ready + occ
        busy = start + nbytes / up[s_idx]
        new_ready[s_idx[pair]] = busy[pair]
    got = lead_max > -np.inf
    if got.any():
        d_ids = leaders[got]
        new_ready[d_ids] = np.maximum(new_ready[d_ids], lead_max[got])
    return new_ready


def _closed_leaf_bcast_round(ready: np.ndarray, rows: np.ndarray,
                             vrows: np.ndarray, leaders: np.ndarray,
                             nbytes: float, up: np.ndarray,
                             down: np.ndarray, lat: np.ndarray,
                             sink=None) -> np.ndarray:
    """Hierarchical down round: each row's leader sends ``nbytes`` to
    every valid member in member order (its own copy is a loopback)."""
    g, m = rows.shape
    safe = np.where(vrows, rows, 0)
    new_ready = ready.copy()
    up_l, lat_l = up[leaders], lat[leaders]
    occ = nbytes / up_l
    acc = ready[leaders]
    sent = np.zeros(g, bool)
    for j in range(m):
        pair = vrows[:, j] & (safe[:, j] != leaders)
        if not pair.any():
            continue
        d_idx = safe[:, j]
        arr = acc + (nbytes / np.minimum(up_l, down[d_idx]))
        arr = arr + lat_l
        arr = arr + lat[d_idx]
        if sink is not None:
            sink(leaders[pair], d_idx[pair], (arr - acc)[pair])
        # member receivers are unique within the round: direct max
        d_ids = d_idx[pair]
        new_ready[d_ids] = np.maximum(new_ready[d_ids], arr[pair])
        acc = np.where(pair, acc + occ, acc)
        sent |= pair
    if sent.any():
        l_ids = leaders[sent]
        new_ready[l_ids] = np.maximum(ready[l_ids], acc[sent])
    return new_ready


def _closed_single_round(ready: np.ndarray, s: np.ndarray,
                         d: np.ndarray, nbytes: float,
                         up: np.ndarray, down: np.ndarray,
                         lat: np.ndarray, sink=None) -> np.ndarray:
    """Unique senders each send one ``nbytes`` message to unique
    receivers (gossip shifts, ring hops); loopbacks pre-filtered."""
    start = ready[s]
    arr = start + (nbytes / np.minimum(up[s], down[d]))
    arr = arr + lat[s]
    arr = arr + lat[d]
    if sink is not None:
        sink(s, d, arr - start)
    new_ready = ready.copy()
    new_ready[s] = start + nbytes / up[s]
    new_ready[d] = np.maximum(new_ready[d], arr)
    return new_ready


def _closed_fan_in_round(ready: np.ndarray, s: np.ndarray, d0: int,
                         nbytes: float, up: np.ndarray,
                         down: np.ndarray, lat: np.ndarray,
                         sink=None) -> np.ndarray:
    """Unique senders each send one ``nbytes`` message to the single
    node ``d0`` (fedavg up, hierarchical rendezvous up)."""
    start = ready[s]
    arr = start + (nbytes / np.minimum(up[s], down[d0]))
    arr = arr + lat[s]
    arr = arr + lat[d0]
    if sink is not None:
        sink(s, np.full(s.size, d0, np.int64), arr - start)
    new_ready = ready.copy()
    new_ready[s] = start + nbytes / up[s]
    if s.size:
        new_ready[d0] = max(new_ready[d0], float(arr.max()))
    return new_ready


def _closed_fan_out_round(ready: np.ndarray, s0: int, d: np.ndarray,
                          nbytes: float, up: np.ndarray,
                          down: np.ndarray, lat: np.ndarray,
                          sink=None) -> np.ndarray:
    """The single node ``s0`` sends ``nbytes`` to each of ``d`` in
    order (fedavg down, rendezvous down); its uplink chain is one
    sequential cumsum, exactly the rectangle row it would occupy."""
    k = d.size
    new_ready = ready.copy()
    if k == 0:
        return new_ready
    buf = np.empty(k + 1)
    buf[0] = ready[s0]
    buf[1:] = nbytes / up[s0]
    chain = np.cumsum(buf)
    start = chain[:k]
    arr = start + (nbytes / np.minimum(up[s0], down[d]))
    arr = arr + lat[s0]
    arr = arr + lat[d]
    if sink is not None:
        sink(np.full(k, s0, np.int64), d, arr - start)
    new_ready[s0] = max(ready[s0], float(chain[k]))
    new_ready[d] = np.maximum(new_ready[d], arr)
    return new_ready


def mar_group_seconds(links: LinkModel, plan, model_bytes: float,
                      mask: Optional[np.ndarray] = None,
                      compute_s: Optional[np.ndarray] = None,
                      num_rounds: Optional[int] = None
                      ) -> Tuple[float, np.ndarray]:
    """One MAR iteration's (iteration_s, peer_finish_s) in closed form
    over ``plan``'s grid — O(depth · m · N/m · m) work, no messages.
    Exact (bitwise vs the materialized engines) on any per-peer link
    profile; raises on loss or pairwise terms like the other closed
    engines."""
    active, ready = _active_ready(links, mask, compute_s)
    valid = _valid_slots(plan, active)
    rounds = plan.depth if num_rounds is None else num_rounds
    up, down, lat = links.up, links.down, links.lat
    for g in range(rounds):
        rows = _group_rows(plan, g % plan.depth)
        ready = _closed_allpairs_round(ready, rows, valid[rows],
                                       float(model_bytes),
                                       up, down, lat)
    return (float(ready.max()) if ready.size else 0.0, ready)


def group_gather_seconds(links: LinkModel, plan, model_bytes: float,
                         mask: Optional[np.ndarray] = None,
                         compute_s: Optional[np.ndarray] = None
                         ) -> Tuple[float, np.ndarray]:
    """One leaf-group gather round (members -> first active member, as
    hierarchical's up phase) in closed form."""
    active, ready = _active_ready(links, mask, compute_s)
    rows, vrows, leaders = _leaf_groups(plan, active)
    ready = _closed_leaf_gather_round(ready, rows, vrows, leaders,
                                      float(model_bytes),
                                      links.up, links.down, links.lat)
    return (float(ready.max()) if ready.size else 0.0, ready)


def group_broadcast_seconds(links: LinkModel, plan, model_bytes: float,
                            mask: Optional[np.ndarray] = None,
                            compute_s: Optional[np.ndarray] = None
                            ) -> Tuple[float, np.ndarray]:
    """One leaf-group broadcast round (first active member -> members,
    as hierarchical's down phase) in closed form."""
    active, ready = _active_ready(links, mask, compute_s)
    rows, vrows, leaders = _leaf_groups(plan, active)
    ready = _closed_leaf_bcast_round(ready, rows, vrows, leaders,
                                     float(model_bytes),
                                     links.up, links.down, links.lat)
    return (float(ready.max()) if ready.size else 0.0, ready)


# ---------------------------------------------------------------------------
# closed-form engines for O(N^2)-message techniques
# ---------------------------------------------------------------------------

def _active_ready(links: LinkModel, mask: Optional[np.ndarray],
                  compute_s: Optional[np.ndarray]
                  ) -> Tuple[np.ndarray, np.ndarray]:
    n = links.n_peers
    if mask is None:
        active = np.arange(n)
    else:
        active = np.flatnonzero(np.asarray(mask)[:n] > 0)
    ready = np.zeros(n)
    if compute_s is not None:
        ready[:min(n, len(compute_s))] = compute_s[:n]
    if links.loss.any():
        raise ValueError(
            "closed-form engines require lossless links (per-message "
            "loss draws need the materialized plan's RNG stream); got "
            "a lossy profile — materialize the plan instead")
    if getattr(links, "has_pair_terms", False):
        raise ValueError(
            "closed-form engines model per-peer link terms only; this "
            "profile carries pairwise (src, dst) costs (e.g. the "
            "regions WAN cap) — materialize the plan instead")
    return active, ready


def all_to_all_seconds(links: LinkModel, model_bytes: float,
                       mask: Optional[np.ndarray] = None,
                       compute_s: Optional[np.ndarray] = None,
                       chunk: int = 256
                       ) -> Tuple[float, np.ndarray]:
    """One AR-FL iteration's (iteration_s, peer_finish_s) without
    materializing its O(N^2) messages.

    Applies the vector engine's model to ``ar_plan``'s structure —
    sender-major message order, so sender ``s``'s k-th transmission
    starts ``k`` uplink drains after its ready time — in sender chunks
    of O(chunk * N) memory. Start offsets use ``k * occupy`` instead of
    a sequential chain (float-associativity differences land at ~1e-12
    relative; cross-checked against the materialized engine in tests).
    """
    active, ready = _active_ready(links, mask, compute_s)
    k = active.size
    finish = ready.copy()
    if k < 2:
        return (float(finish.max()) if finish.size else 0.0,
                finish)
    up, down, lat = links.up, links.down, links.lat
    occ = model_bytes / up[active]
    # receiver index k(s, d): position of d in s's ascending dst scan
    # (self skipped) = rank(d) - (rank(d) > rank(s))
    rank = np.arange(k)
    drain = ready[active] + (k - 1) * occ
    peer_best = np.full(k, -np.inf)
    for lo in range(0, k, chunk):
        sl = slice(lo, min(lo + chunk, k))
        s_ids = active[sl]
        idx = rank[None, :] - (rank[None, :] > rank[sl, None])
        start = ready[s_ids, None] + idx * occ[sl, None]
        tx = model_bytes / np.minimum(up[s_ids, None],
                                      down[active][None, :])
        arr = start + tx + lat[s_ids, None] + lat[active][None, :]
        # a peer never "arrives" to itself
        arr[rank[sl, None] == rank[None, :]] = -np.inf
        np.maximum(peer_best, arr.max(axis=0), out=peer_best)
    finish[active] = np.maximum(drain, peer_best)
    return float(finish.max()), finish


def ring_seconds(links: LinkModel, model_bytes: float,
                 mask: Optional[np.ndarray] = None,
                 compute_s: Optional[np.ndarray] = None
                 ) -> Tuple[float, np.ndarray]:
    """One RDFL iteration's (iteration_s, peer_finish_s) by iterating
    the k-1 ring hops as O(k) vector recurrences instead of O(k^2)
    materialized messages: each hop, every active peer forwards one
    full model to its successor, and a hop cannot leave before the
    previous one arrived."""
    active, ready = _active_ready(links, mask, compute_s)
    k = active.size
    if k < 2:
        return (float(ready.max()) if ready.size else 0.0, ready)
    up, down, lat = (links.up[active], links.down[active],
                     links.lat[active])
    r = ready[active]
    occ = model_bytes / up
    tx = model_bytes / np.minimum(up, np.roll(down, -1))
    hop_lat = lat + np.roll(lat, -1)
    for _ in range(k - 1):
        arrival = r + tx + hop_lat
        r = np.maximum(r + occ, np.roll(arrival, 1))
    finish = ready.copy()
    finish[active] = r
    return float(finish.max()), finish
