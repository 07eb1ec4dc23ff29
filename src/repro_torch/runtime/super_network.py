"""Superpeer hybrid engine: closed-form intra-cluster tiers + the
vector engine for everything else — the ``"super_sim"`` backend.

The vectorized engine (``vector_network.py``) still materializes every
message: one MAR iteration at N=2^20 is ~21M (src, dst, nbytes) tuples
before a single timing op runs. This engine never builds them. It
consumes the symbolic :class:`~repro_torch.core.transport.SuperMessagePlan`
recipe and splits each technique's round structure at a grid level:

* **intra-cluster rounds** — the trailing grid coordinates, which
  under the clustered placement policy (``core/placement.py``) stay
  inside one contiguous, link-homogeneous cluster — are timed by the
  closed-form group recurrences of ``vector_network.py``
  (``_closed_allpairs_round`` and friends): O(groups) vector ops per
  round instead of O(messages), bitwise equal to the materialized
  engines on any *per-peer* link profile (the closed forms reproduce
  the rectangle-cumsum arithmetic term by term; neutral pairwise
  cap/xlat fills and ``min(x, inf)`` / ``+ 0.0`` are exact no-ops);
* **inter-cluster rounds** — leading coordinates whose groups span
  clusters, plus any round that needs non-neutral pairwise WAN terms —
  are materialized per round as arrays and pushed through the shared
  ``_timed_round`` step, keeping regions-profile pair terms exact;
* **loss** is all-or-nothing: per-message drops consume a seeded RNG
  stream in materialized-message order, so a lossy link model routes
  the whole plan through an internal ``VectorNetworkSim`` with synced
  seed/iteration counters — transcripts (drops included) stay
  identical to running ``"vector_sim"`` directly.

Exactness contract (DESIGN.md §15): **bytes are exact always**; times
are bit-equal to ``vector_sim`` on uniform / wireless (any per-peer
profile) and on regions wherever clustered placement makes trailing
axes region-pure; the opt-in ``approx_level`` trades exactness for a
*bounded* error — cluster-mean link rates with relative error ≤ the
links' max relative deviation from their cluster means (every atomic
time term lands within (1 ± δ) of its exact value, and the engine's
only combinators, ``+`` of nonnegative terms and ``max``, preserve
that interval).

Per-link accounting reuses :class:`LinkAccounting` peer mode; past
``link_budget`` estimated messages (default 4M) the deferred per-link
top-k buffers are disabled (``track_links=False``) — per-node tx/rx
totals stay exact, only the heavy-link dict comes back empty.

A copy of the JAX package's ``repro/runtime/super_network.py`` (numpy) with its imports
rewritten; tests hold it equal to the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.transport import (ArrayMessagePlan, MessagePlan,
                                  SuperMessagePlan, _active_ids,
                                  _group_rows, _leaf_groups,
                                  _mar_round_arrays, _valid_slots,
                                  mkd_round_arrays)
from repro_torch.runtime.network import LinkModel, build_link_model
from repro_torch.runtime.transport_base import (LINK_DETAIL_MAX_PEERS,
                                          LinkAccounting, Transcript,
                                          Transport, register_transport)
from repro_torch.runtime.vector_network import (VectorNetworkSim,
                                          _closed_allpairs_round,
                                          _closed_fan_in_round,
                                          _closed_fan_out_round,
                                          _closed_leaf_bcast_round,
                                          _closed_leaf_gather_round,
                                          _closed_single_round,
                                          _extended_links, _row_counts,
                                          _timed_round)

__all__ = ["SuperNetworkSim", "approx_link_arrays"]


def approx_link_arrays(links: LinkModel, plan, level: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  float]:
    """Cluster-mean link arrays for the reduced intra-cluster tier.

    Clusters are the contiguous slot blocks below grid ``level`` (block
    size = prod(dims[level:])). Per cluster, the per-peer *rates* —
    seconds-per-byte ``1/up`` and ``1/down``, and ``lat`` — are
    replaced by their cluster means. Returns ``(up_hat, down_hat,
    lat_hat, delta)`` where ``delta`` is the max relative deviation of
    any peer's rate from its cluster mean: every closed-form time
    computed from the hat arrays is within ``(1 ± delta)`` of the exact
    value (each atomic term is, and ``+`` / ``max`` preserve the
    interval). ``delta == 0`` exactly when clusters are link-
    homogeneous.
    """
    n = links.n_peers
    level = max(0, min(int(level), plan.depth))
    block = int(np.prod(plan.dims[level:], dtype=np.int64))
    cluster = plan.slot_of(np.arange(n)) // block
    up_hat = links.up.copy()
    down_hat = links.down.copy()
    lat_hat = links.lat.copy()
    delta = 0.0

    def _rel(vals: np.ndarray, mean: float) -> float:
        if mean == 0.0:
            return 0.0 if not vals.any() else np.inf
        return float(np.abs(vals - mean).max() / mean)

    for c in np.unique(cluster):
        ids = np.flatnonzero(cluster == c)
        iu = 1.0 / links.up[ids]
        idn = 1.0 / links.down[ids]
        la = links.lat[ids]
        mu, md, ml = float(iu.mean()), float(idn.mean()), float(la.mean())
        up_hat[ids] = 1.0 / mu
        down_hat[ids] = 1.0 / md
        lat_hat[ids] = ml
        delta = max(delta, _rel(iu, mu), _rel(idn, md), _rel(la, ml))
    return up_hat, down_hat, lat_hat, delta


class _GridInfo:
    """Per-grid derived state, cached across iterations (the grid
    object is immutable; regroup swaps it, naturally invalidating)."""

    def __init__(self, plan, links: LinkModel,
                 approx_level: Optional[int]):
        self.plan = plan
        self.rows: Dict[int, np.ndarray] = {}
        self._cols: Dict[Tuple[int, float], "_PairData"] = {}
        self._slot: Dict[float, "_SlotData"] = {}
        n_real = links.n_peers
        # axis purity: an axis is closed-form-eligible iff no group of
        # that round spans regions (pairwise terms stay neutral inside
        # a region). Profiles without pair terms are pure everywhere;
        # pairwise profiles without region labels are pure nowhere.
        if not getattr(links, "has_pair_terms", False):
            self.pure = np.ones(plan.depth, bool)
        elif getattr(links, "region_of", None) is None:
            self.pure = np.zeros(plan.depth, bool)
        else:
            reg = links.region_of()
            self.pure = np.empty(plan.depth, bool)
            for axis in range(plan.depth):
                rows = self.axis_rows(axis)
                real = rows < n_real
                r = np.where(real, reg[np.where(real, rows, 0)], -1)
                first = r[np.arange(rows.shape[0]),
                          np.argmax(real, axis=1)]
                self.pure[axis] = bool(
                    ((r == first[:, None]) | ~real).all())
        self.approx: Optional[Tuple[np.ndarray, np.ndarray,
                                    np.ndarray]] = None
        self.delta = 0.0
        if approx_level is not None:
            uh, dh, lh, self.delta = approx_link_arrays(
                links, plan, approx_level)
            self.approx = (uh, dh, lh)

    def axis_rows(self, axis: int) -> np.ndarray:
        rows = self.rows.get(axis)
        if rows is None:
            rows = self.rows[axis] = _group_rows(self.plan, axis)
        return rows

    def pair_data(self, axis: int, b: float, up: np.ndarray,
                  down: np.ndarray, lat: np.ndarray) -> "_PairData":
        """For a dims[axis]==2 round: every iteration-invariant array
        the pair round needs, cached per (axis, model bytes). Link
        values (and the derived transfer/occupancy times ``b/rate``)
        are frozen at first use; ``resize`` — the only sanctioned link
        mutation — drops the whole cache."""
        pd = self._cols.get((axis, b))
        if pd is None:
            pd = self._cols[(axis, b)] = _PairData(
                self.axis_rows(axis), b, up, down, lat)
        return pd

    def slot_data(self, b: float, up: np.ndarray, down: np.ndarray,
                  lat: np.ndarray) -> "_SlotData":
        sd = self._slot.get(b)
        if sd is None:
            sd = self._slot[b] = _SlotData(self.plan, b, up, down, lat)
        return sd


class _SlotData:
    """Slot-ordered constants for the all-closed, full-participation
    MAR run on an all-binary grid — the large-N hot loop.

    In slot order the two members of every axis-``a`` group sit in the
    contiguous lanes of ``slot_ready.reshape(pre, 2, post)``, so each
    round is pure elementwise math on views: no index gathers at all.
    Entity↔slot conversion happens once per run, and per-node seconds
    totals accumulate in slot order (bitwise safe — each node adds its
    per-round values in the same order, just at a different address).
    Per-pair arithmetic is term-for-term :meth:`SuperNetworkSim._pair_round`,
    with the within-pair send order flipped where the placement orders
    a group's entity ids against its slot coordinates — a symmetric
    exchange, so every transcript field is unchanged."""

    __slots__ = ("cap", "ent", "sl", "identity", "axes",
                 "t0", "t1", "t2")

    def __init__(self, plan, b: float, up: np.ndarray,
                 down: np.ndarray, lat: np.ndarray):
        cap = plan.capacity
        self.cap = cap
        self.identity = plan.placement is None
        if self.identity:
            self.ent = self.sl = np.arange(cap)
        else:
            self.ent, self.sl = plan._entity_at, plan._slot_of
        up_s = up[self.ent]
        down_s = down[self.ent]
        lat_s = lat[self.ent]
        self.axes = []
        for a in range(plan.depth):
            pre = int(np.prod(plan.dims[:a], dtype=np.int64))
            post = cap // (pre * 2)
            u = up_s.reshape(pre, 2, post)
            d = down_s.reshape(pre, 2, post)
            lv = lat_s.reshape(pre, 2, post)
            self.axes.append(
                (pre, post,
                 b / np.minimum(u[:, 0], d[:, 1]),      # tx 0 -> 1
                 b / np.minimum(u[:, 1], d[:, 0]),      # tx 1 -> 0
                 b / np.ascontiguousarray(u[:, 0]),     # occ lane 0
                 b / np.ascontiguousarray(u[:, 1]),     # occ lane 1
                 np.ascontiguousarray(lv[:, 0]),
                 np.ascontiguousarray(lv[:, 1])))
        m = cap // 2
        self.t0 = np.empty(m)
        self.t1 = np.empty(m)
        self.t2 = np.empty(m)


class _PairData:
    """Frozen per-(axis, bytes) arrays for the dims==2 MAR fast path.

    The links and payload size never change within a grid's lifetime,
    so the per-message transfer time ``tx01 = b / min(up0, down1)``,
    the sender occupancy ``occ = b / up``, the latency gathers, and
    the round's (senders, receivers) id layout are all constants; the
    hot loop is left with two gathers of ``ready`` plus adds/maxima.
    Scratch buffers are preallocated and reused across rounds (their
    contents never outlive one round)."""

    __slots__ = ("s0", "s1", "cs", "cd", "l0", "l1", "tx01", "tx10",
                 "occ0", "occ1", "t0", "t1", "t2", "secs")

    def __init__(self, rows: np.ndarray, b: float, up: np.ndarray,
                 down: np.ndarray, lat: np.ndarray):
        s0 = rows[:, 0].copy()
        s1 = rows[:, 1].copy()
        self.s0, self.s1 = s0, s1
        self.cs = np.concatenate([s0, s1])
        self.cd = np.concatenate([s1, s0])
        self.l0 = lat[s0]
        self.l1 = lat[s1]
        self.tx01 = b / np.minimum(up[s0], down[s1])
        self.tx10 = b / np.minimum(up[s1], down[s0])
        self.occ0 = b / up[s0]
        self.occ1 = b / up[s1]
        m = s0.size
        self.t0 = np.empty(m)
        self.t1 = np.empty(m)
        self.t2 = np.empty(m)
        self.secs = np.empty(2 * m)


@register_transport
class SuperNetworkSim(Transport):
    """Hybrid closed-form / vectorized plan executor — the
    ``"super_sim"`` transport backend.

    Accepts :class:`SuperMessagePlan` (the symbolic hot path) or any
    list/array plan (delegated verbatim to an internal
    :class:`VectorNetworkSim` over the same links with synced
    seed/iteration counters, so probe plans and mixed callers see
    ``vector_sim``-identical transcripts). ``split_level`` forces
    grid axes below it onto the materialized path (``None`` = closed
    forms wherever exact); ``approx_level`` opts into the bounded-error
    cluster-mean tier.
    """

    name = "super_sim"
    plan_format = "super"

    def __init__(self, n_peers: int, profile: str = "uniform",
                 seed: int = 0,
                 link_params: Optional[Dict[str, Any]] = None,
                 links: Optional[LinkModel] = None,
                 split_level: Optional[int] = None,
                 approx_level: Optional[int] = None,
                 link_budget: int = 500_000):
        self.links = links if links is not None else build_link_model(
            profile, n_peers, seed=seed, **(link_params or {}))
        self.seed = seed
        self.clock = 0.0
        self.iterations = 0
        self.split_level = split_level
        self.approx_level = approx_level
        self.link_budget = link_budget
        self._vec: Optional[VectorNetworkSim] = None
        self._info: Optional[_GridInfo] = None

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
        self._info = None

    # ------------------------------------------------------------------
    def _delegate(self, plan: Any,
                  compute_s: Optional[np.ndarray]) -> Transcript:
        if self._vec is None:
            self._vec = VectorNetworkSim(self.links.n_peers,
                                         links=self.links)
        vec = self._vec
        vec.seed = self.seed
        vec.iterations = self.iterations
        tr = vec.run(plan, compute_s=compute_s)
        self.clock += tr.iteration_s
        self.iterations += 1
        return tr

    def _grid_info(self, plan) -> _GridInfo:
        if self._info is None or self._info.plan is not plan:
            self._info = _GridInfo(plan, self.links, self.approx_level)
        return self._info

    def run(self, plan: Any,
            compute_s: Optional[np.ndarray] = None,
            payloads: Optional[Any] = None) -> Transcript:
        """Execute one iteration's plan; symbolic recipes run hybrid,
        everything else (and every lossy profile) delegates."""
        if not isinstance(plan, SuperMessagePlan):
            return self._delegate(plan, compute_s)
        if (self.links.loss.any() or plan.mode != "naive"
                or plan.technique == "ar"):
            # per-message loss draws need the materialized RNG stream;
            # butterfly MAR and all-to-all have no structured rounds
            return self._delegate(plan.to_array_plan(), compute_s)
        return self._run_hybrid(plan, compute_s)

    # ------------------------------------------------------------------
    @staticmethod
    def _pair_round(pd: "_PairData", ready: np.ndarray,
                    valid: np.ndarray, full: bool, b: float,
                    acct: LinkAccounting
                    ) -> Tuple[np.ndarray, int]:
        """Specialized dims[axis]==2 MAR round: one symmetric exchange
        per group, all lanes at once — the N=2^20 hot loop. Same
        arithmetic as :func:`_closed_allpairs_round` (send start =
        ready, arrival = ((start + tx) + lat_s) + lat_d, drain =
        start + occ, node ready = max(drain, arrival)), message order
        [position-0 senders, position-1 senders]. Transfer/occupancy
        times come precomputed in ``pd``; the full-participation case
        runs allocation-free on ``pd``'s scratch buffers and updates
        ``ready`` in place (both lane gathers are copies)."""
        r0 = ready[pd.s0]
        r1 = ready[pd.s1]
        a01 = np.add(r0, pd.tx01, out=pd.t0)
        np.add(a01, pd.l0, out=a01)
        np.add(a01, pd.l1, out=a01)
        a10 = np.add(r1, pd.tx10, out=pd.t1)
        np.add(a10, pd.l1, out=a10)
        np.add(a10, pd.l0, out=a10)
        m = pd.s0.size
        secs = pd.secs
        np.subtract(a01, r0, out=secs[:m])
        np.subtract(a10, r1, out=secs[m:])
        # new0 = max(r0 + occ0, arr10) lands in a10's buffer (and new1
        # in a01's) once the arrivals have fed the seconds above
        np.maximum(np.add(r1, pd.occ1, out=pd.t2), a01, out=a01)
        np.maximum(np.add(r0, pd.occ0, out=pd.t2), a10, out=a10)
        if full:
            ready[pd.s0] = a10
            ready[pd.s1] = a01
            acct.add_uniform_round(pd.cs, pd.cd, b, secs)
            return ready, 2 * m
        both = valid[pd.s0] & valid[pd.s1]
        if not both.any():
            return ready, 0
        ready[pd.s0[both]] = a10[both]
        ready[pd.s1[both]] = a01[both]
        ss = np.concatenate([pd.s0[both], pd.s1[both]])
        dd = np.concatenate([pd.s1[both], pd.s0[both]])
        acct.add_batch(ss, dd, np.full(ss.size, b),
                       np.concatenate([secs[:m][both], secs[m:][both]]),
                       unique=True)
        return ready, int(ss.size)

    # ------------------------------------------------------------------
    @staticmethod
    def _mar_slot_run(sd: "_SlotData", ready: np.ndarray, rounds: int,
                      b: float, acct: LinkAccounting,
                      tr: Transcript) -> np.ndarray:
        """All rounds of an all-closed, full-participation MAR
        iteration on an all-binary grid, in slot order (see
        :class:`_SlotData`). Per-node seconds totals accumulate in the
        slot-ordered ``stx``/``srx`` and flush once — valid only when
        nothing else contributes to the accounting totals this run
        (callers gate on no-KD, peer mode, no per-link tracking)."""
        cap = sd.cap
        slot_ready = ready if sd.identity else ready[sd.ent]
        stx = np.zeros(cap)
        srx = np.zeros(cap)
        rb = b * cap
        n_axes = len(sd.axes)
        for g in range(rounds):
            pre, post, tx01, tx10, occ0, occ1, l0, l1 = \
                sd.axes[g % n_axes]
            r = slot_ready.reshape(pre, 2, post)
            r0, r1 = r[:, 0], r[:, 1]
            t0 = sd.t0.reshape(pre, post)
            t1 = sd.t1.reshape(pre, post)
            t2 = sd.t2.reshape(pre, post)
            a01 = np.add(r0, tx01, out=t0)
            np.add(a01, l0, out=a01)
            np.add(a01, l1, out=a01)
            a10 = np.add(r1, tx10, out=t1)
            np.add(a10, l1, out=a10)
            np.add(a10, l0, out=a10)
            sx = stx.reshape(pre, 2, post)
            rx = srx.reshape(pre, 2, post)
            sec = np.subtract(a01, r0, out=t2)
            sx[:, 0] += sec
            rx[:, 1] += sec
            sec = np.subtract(a10, r1, out=t2)
            sx[:, 1] += sec
            rx[:, 0] += sec
            # node ready = max(own drain, peer's arrival); lane 0 is
            # untouched while lane 1 is written, so r0 stays the
            # round's start values
            np.maximum(np.add(r1, occ1, out=t2), a01, out=t2)
            r[:, 1] = t2
            np.maximum(np.add(r0, occ0, out=t2), a10, out=t2)
            r[:, 0] = t2
            acct.tx += b
            acct.rx += b
            tr.n_messages += cap
            tr.total_bytes += rb
            tr.bytes_by_round.append(rb)
            tr.round_s.append(float(slot_ready.max()))
        acct.tx_s += stx if sd.identity else stx[sd.sl]
        acct.rx_s += srx if sd.identity else srx[sd.sl]
        return slot_ready if sd.identity else slot_ready[sd.sl]

    # ------------------------------------------------------------------
    def _run_hybrid(self, plan: SuperMessagePlan,
                    compute_s: Optional[np.ndarray]) -> Transcript:
        links = self.links
        n_real = links.n_peers
        n_nodes = max(plan.n_nodes, n_real)
        up, down, lat, _ = _extended_links(links, n_nodes)
        ready = np.zeros(n_nodes)
        if compute_s is not None:
            ready[:min(n_real, len(compute_s))] = compute_s[:n_real]
        tr = Transcript(technique=plan.technique,
                        lost_senders=np.zeros(n_real, bool))
        # small fleets (the exact-dict / parity tier) always track
        # per-link detail like the vector engine; past that, the
        # deferred top-k buffers only run under the message budget
        acct = LinkAccounting(
            n_nodes, n_real,
            track_links=(n_real <= 2 * LINK_DETAIL_MAX_PEERS
                         or plan.n_messages_estimate()
                         <= self.link_budget))
        info = self._grid_info(plan.plan)
        grid = plan.plan
        active = _active_ids(plan.mask, n_real)
        b = float(plan.model_bytes)
        split = (0 if self.split_level is None
                 else max(0, min(self.split_level, grid.depth)))
        # closed rounds use the (possibly cluster-mean) hat arrays;
        # materialized rounds always use the exact ones
        if info.approx is not None:
            c_up, c_down, c_lat = [
                np.concatenate([h, a[n_real:]])
                for h, a in zip(info.approx, (up, down, lat))]
        else:
            c_up, c_down, c_lat = up, down, lat

        def sink(nb):
            def _s(s, d, secs):
                acct.add_batch(s, d, np.full(s.size, nb), secs)
            return _s

        def finish_round(count: int, nb: float) -> None:
            tr.n_messages += count
            rbytes = nb * count
            tr.total_bytes += rbytes
            tr.bytes_by_round.append(rbytes)
            tr.round_s.append(float(ready.max()))

        def vector_round(s, d, nb_arr) -> None:
            """The materialized path: one round through the shared
            vector-engine step, pairwise terms included."""
            nonlocal ready
            tr.n_messages += s.size
            rbytes = float(nb_arr.sum())
            tr.total_bytes += rbytes
            nz = s != d
            sz, dz, bz = s[nz], d[nz], nb_arr[nz]
            if sz.size == 0:
                acct.add_batch(s, d, nb_arr)
                tr.bytes_by_round.append(rbytes)
                tr.round_s.append(float(ready.max()))
                return
            cap = np.full(sz.size, np.inf)
            xlat = np.zeros(sz.size)
            if getattr(links, "has_pair_terms", False):
                both = (sz < n_real) & (dz < n_real)
                pc, pl = links.pair_terms(sz[both], dz[both])
                cap[both] = pc
                xlat[both] = pl
            senders, drain, arr, start = _timed_round(
                ready, sz, dz, bz, up, down, lat, cap, xlat)
            new_ready = ready.copy()
            new_ready[senders] = np.maximum(ready[senders], drain)
            np.maximum.at(new_ready, dz, arr)
            secs = np.zeros(s.size)
            secs[nz] = arr - start
            acct.add_batch(s, d, nb_arr, secs)
            ready = new_ready
            tr.bytes_by_round.append(rbytes)
            tr.round_s.append(float(ready.max()))

        if plan.use_kd:
            # MKD prefix: teacher pulls + logit messages, materialized
            # (mixed byte sizes, interleaved order) at raw model bytes
            for s, d, nb_arr in mkd_round_arrays(
                    grid, plan.mask, plan.raw_model_bytes,
                    plan.kd_logit_bytes, num_rounds=plan.num_rounds):
                vector_round(s, d, nb_arr)

        tech = plan.technique
        if tech == "mar":
            valid = _valid_slots(grid, active)
            full = bool(valid.all())
            rounds = (grid.depth if plan.num_rounds is None
                      else plan.num_rounds)
            if (full and not plan.use_kd and split == 0
                    and grid.capacity == n_real
                    and set(grid.dims) == {2}
                    and bool(info.pure.all())
                    and not acct.exact and not acct.track_links):
                ready = self._mar_slot_run(
                    info.slot_data(b, c_up, c_down, c_lat), ready,
                    rounds, b, acct, tr)
                rounds = 0  # all done, gather-free
            for g in range(rounds):
                axis = g % grid.depth
                if axis >= split and info.pure[axis]:
                    if grid.dims[axis] == 2 and grid.capacity <= n_real:
                        ready, count = self._pair_round(
                            info.pair_data(axis, b, c_up, c_down,
                                           c_lat),
                            ready, valid, full, b, acct)
                        finish_round(count, b)
                        continue
                    rows = info.axis_rows(axis)
                    vrows = valid[rows]
                    kk = _row_counts(vrows)
                    count = int((kk * (kk - 1)).sum())
                    chunks: List[Tuple[np.ndarray, np.ndarray,
                                       np.ndarray]] = []
                    ready = _closed_allpairs_round(
                        ready, rows, vrows, b, c_up, c_down, c_lat,
                        sink=lambda s, d, secs: chunks.append(
                            (s, d, secs)), kk=kk)
                    if chunks:
                        cs = np.concatenate([c[0] for c in chunks])
                        cd = np.concatenate([c[1] for c in chunks])
                        csec = np.concatenate([c[2] for c in chunks])
                        acct.add_batch(cs, cd, np.full(cs.size, b),
                                       csec)
                    finish_round(count, b)
                else:
                    rows = info.axis_rows(axis)
                    s, d, nb_arr = _mar_round_arrays(rows, valid[rows],
                                                     b)
                    vector_round(s, d, nb_arr)
        elif tech == "gossip":
            n = grid.n_peers
            rounds = plan.num_rounds
            if rounds is None:
                rounds = max(1, int(math.ceil(math.log2(max(n, 2)))))
            nb_arr = np.full(active.size, b)
            for r in range(rounds):
                d_all = (active + (1 << r)) % n
                if (1 << r) % n == 0 or active.size == 0:
                    # all loopbacks (or nobody active): billed, instant
                    acct.add_batch(active, d_all, nb_arr)
                    finish_round(active.size, b)
                elif getattr(links, "has_pair_terms", False):
                    vector_round(active, d_all, nb_arr)
                else:
                    ready = _closed_single_round(
                        ready, active, d_all, b, c_up, c_down, c_lat,
                        sink=sink(b))
                    finish_round(active.size, b)
        elif tech == "fedavg":
            server = grid.n_peers
            if active.size:
                ready = _closed_fan_in_round(ready, active, server, b,
                                             c_up, c_down, c_lat,
                                             sink=sink(b))
            finish_round(active.size, b)
            if active.size:
                ready = _closed_fan_out_round(ready, server, active, b,
                                              c_up, c_down, c_lat,
                                              sink=sink(b))
            finish_round(active.size, b)
        elif tech == "rdfl":
            k = active.size
            if k >= 2:
                d_all = np.roll(active, -1)
                pairwise = getattr(links, "has_pair_terms", False)
                nb_arr = np.full(k, b)
                for _ in range(k - 1):
                    if pairwise:
                        vector_round(active, d_all, nb_arr)
                    else:
                        ready = _closed_single_round(
                            ready, active, d_all, b, c_up, c_down,
                            c_lat, sink=sink(b))
                        finish_round(k, b)
        elif tech == "hierarchical":
            rows, vrows, leaders = _leaf_groups(grid, active)
            nonempty = vrows.any(axis=1)
            glead = leaders[nonempty].astype(np.int64)
            rv = grid.n_peers
            n_members = int(np.count_nonzero(vrows))
            leaf_pure = bool(info.pure[grid.depth - 1])
            leaf_closed = leaf_pure and grid.depth - 1 >= split
            # up: members -> leaders (leader's own copy loops back)
            if leaf_closed:
                ready = _closed_leaf_gather_round(
                    ready, rows, vrows, leaders, b, c_up, c_down,
                    c_lat, sink=sink(b))
                acct.add_batch(glead, glead, np.full(glead.size, b))
                finish_round(n_members, b)
            else:
                members = rows[vrows]
                mlead = np.broadcast_to(leaders[:, None],
                                        rows.shape)[vrows]
                vector_round(members, mlead,
                             np.full(members.size, b))
            # mid: leaders <-> rendezvous (infrastructure: pairwise
            # terms never apply, closed is exact on every profile)
            if glead.size:
                ready = _closed_fan_in_round(ready, glead, rv, b, c_up,
                                             c_down, c_lat,
                                             sink=sink(b))
            finish_round(glead.size, b)
            if glead.size:
                ready = _closed_fan_out_round(ready, rv, glead, b,
                                              c_up, c_down, c_lat,
                                              sink=sink(b))
            finish_round(glead.size, b)
            # down: leaders -> members
            if leaf_closed:
                ready = _closed_leaf_bcast_round(
                    ready, rows, vrows, leaders, b, c_up, c_down,
                    c_lat, sink=sink(b))
                acct.add_batch(glead, glead, np.full(glead.size, b))
                finish_round(n_members, b)
            else:
                members = rows[vrows]
                mlead = np.broadcast_to(leaders[:, None],
                                        rows.shape)[vrows]
                vector_round(mlead, members,
                             np.full(members.size, b))
        else:  # pragma: no cover - build_super_plan validates
            return self._delegate(plan.to_array_plan(), compute_s)

        tr.peer_finish_s = ready[:n_real].copy()
        tr.iteration_s = float(ready.max()) if n_nodes else 0.0
        acct.finalize(tr)
        self._split_kd_bytes(tr, plan)
        self.clock += tr.iteration_s
        self.iterations += 1
        return tr
