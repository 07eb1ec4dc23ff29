"""Churn-aware peer lifecycle runtime: event-driven membership.

MAR-FL's resilience claim (paper §3.1/Fig. 3) was reproduced as
per-iteration i.i.d. Bernoulli masks; real deployments exhibit
*structured* availability — session churn with dwell times, correlated
regional outages, deadline-bound wireless stragglers, and permanent
capacity changes. This module makes membership a first-class runtime
concern:

* :class:`ChurnModel` — a registry of availability processes, each
  producing one :class:`ChurnTick` (participation mask U_t, aggregation
  mask A_t, optional simulated durations, membership events) per FL
  iteration. Built-ins:

  - ``bernoulli`` — i.i.d. per-iteration masks; the degenerate case,
    bit-identical to the old ``Federation.sample_masks``.
  - ``sessions`` — per-peer two-state Markov chains (online/offline)
    with configurable mean dwell times: availability is correlated in
    time (a peer that is up tends to stay up for ``mean_up``
    iterations), matching session-structured wireless traces.
  - ``correlated`` — region-level outages: peers are partitioned into
    regions; a region fails together with geometric outage durations,
    on top of background i.i.d. dropout (rack/cell failures).
  - ``wireless`` — deadline stragglers: per-peer compute rates (a slow
    tail) produce per-iteration durations; peers over the
    :class:`~repro.runtime.fault.StragglerPolicy` deadline run their
    local update (U_t) but miss aggregation (A_t) — the paper's
    dropout semantics.
  - ``link`` — deadline stragglers whose durations come from *modeled
    link time*: per-peer uplink/latency are drawn from a
    ``runtime/network.py`` link profile and each iteration costs
    compute + simulated MAR send time, so a slow uplink — not an
    abstract compute rate — is what misses the deadline.
  - ``trace`` — replayable event files (JSONL): record any run's
    membership events with :func:`save_trace`, replay them exactly.

* :class:`PeerLifecycle` — binds a model to the fault machinery
  (:class:`~repro.runtime.fault.HealthTracker` heartbeats + sweeps,
  :class:`~repro.runtime.fault.StragglerPolicy` deadlines) and to a
  permanent-resize schedule. ``tick(t)`` returns the masks the training
  loop consumes plus ``resize_to`` when the fleet permanently grows or
  shrinks — the signal ``Federation.resize`` acts on (elastic
  regrouping via ``elastic_replan``, no checkpoint/restart).

Events are host-side numpy/python — the jitted iteration function only
ever sees the two float32 masks, so every scenario shares one trace.

A copy of the JAX package's ``repro/runtime/lifecycle.py`` (numpy) with its imports
rewritten; tests hold it equal to the reference.
"""
from __future__ import annotations

import dataclasses
import json
from typing import (Any, Callable, Dict, Iterable, List, Optional,
                    Sequence, Tuple, Type)

import numpy as np

from repro_torch.runtime.fault import HealthTracker, StragglerPolicy

# event kinds
DOWN = "down"          # transient: peer unavailable this iteration
UP = "up"              # transient: peer came back
STRAGGLE = "straggle"  # ran the local update but missed the deadline
DEAD = "dead"          # health timeout (no heartbeat)
JOIN = "join"          # permanent: fleet grew
LEAVE = "leave"        # permanent: fleet shrank

EVENT_KINDS = (DOWN, UP, STRAGGLE, DEAD, JOIN, LEAVE)


@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    """One membership change, attributed to an FL iteration."""

    iteration: int
    kind: str
    peers: Tuple[int, ...]

    def to_json(self) -> Dict[str, Any]:
        return {"t": int(self.iteration), "kind": self.kind,
                "peers": [int(p) for p in self.peers]}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "MembershipEvent":
        return MembershipEvent(int(d["t"]), str(d["kind"]),
                               tuple(int(p) for p in d["peers"]))


@dataclasses.dataclass
class ChurnTick:
    """One iteration's membership view.

    ``u`` — participation mask U_t (peers that run the local update);
    ``a`` — aggregation mask A_t (peers whose update joins the group
    means); ``durations`` — simulated per-peer local-update durations
    (seconds), when the model has a latency notion; ``events`` — what
    changed versus the previous iteration.
    """

    u: np.ndarray
    a: np.ndarray
    durations: Optional[np.ndarray] = None
    events: List[MembershipEvent] = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# churn models
# ---------------------------------------------------------------------------

CHURN_MODELS: Dict[str, Type["ChurnModel"]] = {}


def register_churn(cls: Type["ChurnModel"]) -> Type["ChurnModel"]:
    CHURN_MODELS[cls.name] = cls
    return cls


def build_churn_model(name: str, n_peers: int, seed: int = 0,
                      **params: Any) -> "ChurnModel":
    if name not in CHURN_MODELS:
        raise ValueError(f"unknown churn model {name!r}; "
                         f"registered: {sorted(CHURN_MODELS)}")
    return CHURN_MODELS[name](n_peers, seed=seed, **params)


class ChurnModel:
    """An availability process over ``n_peers``; ``tick(t)`` must be
    called with consecutive iterations (models carry session state)."""

    name: str = "?"

    def __init__(self, n_peers: int, seed: int = 0):
        self.n_peers = n_peers
        self.seed = seed

    def tick(self, t: int) -> ChurnTick:
        raise NotImplementedError

    def resize(self, new_n: int) -> None:
        """Permanent capacity change: models with per-peer state resize
        it here (survivors keep their state; new peers start online)."""
        self.n_peers = new_n

    # -- helpers --------------------------------------------------------
    @staticmethod
    def _ensure_someone(mask: np.ndarray, rng: np.random.Generator
                        ) -> np.ndarray:
        if not mask.any():
            mask[int(rng.integers(len(mask)))] = True
        return mask

    @staticmethod
    def _delta_events(t: int, prev: np.ndarray, cur: np.ndarray
                      ) -> List[MembershipEvent]:
        events = []
        went_down = np.flatnonzero(prev & ~cur)
        came_up = np.flatnonzero(~prev & cur)
        if went_down.size:
            events.append(MembershipEvent(t, DOWN, tuple(went_down)))
        if came_up.size:
            events.append(MembershipEvent(t, UP, tuple(came_up)))
        return events


@register_churn
class BernoulliChurn(ChurnModel):
    """i.i.d. per-iteration masks — the degenerate case.

    Reproduces the retired ``Federation.sample_masks`` bit-for-bit: the
    per-iteration rng is seeded ``seed * 100003 + t`` and consumed in
    the same order, so pre-lifecycle runs replay exactly.
    """

    name = "bernoulli"

    def __init__(self, n_peers: int, seed: int = 0,
                 participation_rate: float = 1.0,
                 dropout_rate: float = 0.0):
        super().__init__(n_peers, seed)
        self.participation_rate = participation_rate
        self.dropout_rate = dropout_rate
        self._prev = np.ones(n_peers, bool)

    def tick(self, t: int) -> ChurnTick:
        rng = np.random.default_rng(self.seed * 100003 + t)
        n = self.n_peers
        u = rng.random(n) < self.participation_rate
        u = self._ensure_someone(u, rng)
        drop = rng.random(n) < self.dropout_rate
        a = u & ~drop
        if not a.any():
            a[np.flatnonzero(u)[0]] = True
        # events are deltas (like every other model), so a recorded
        # bernoulli run replays through TraceChurn's toggle semantics
        events = self._delta_events(t, self._prev, u)
        self._prev = u.copy()
        dropped = np.flatnonzero(u & ~a)
        if dropped.size:
            events.append(MembershipEvent(t, STRAGGLE, tuple(dropped)))
        return ChurnTick(u.astype(np.float32), a.astype(np.float32),
                         events=events)

    def resize(self, new_n: int) -> None:
        old = self._prev
        self._prev = np.ones(new_n, bool)
        self._prev[:min(new_n, len(old))] = old[:new_n]
        self.n_peers = new_n


@register_churn
class MarkovSessionChurn(ChurnModel):
    """Per-peer on/off Markov sessions with mean dwell times.

    A peer online at t stays online with probability ``1 - 1/mean_up``;
    an offline peer returns with probability ``1/mean_down`` (geometric
    dwell times, the discrete-time M/M/1-style session model used for
    wireless FL availability). Long-run availability is
    ``mean_up / (mean_up + mean_down)``, but unlike Bernoulli the
    masks are correlated across iterations — whole sessions drop out.
    """

    name = "sessions"

    def __init__(self, n_peers: int, seed: int = 0, mean_up: float = 8.0,
                 mean_down: float = 3.0, start_online: float = 1.0):
        super().__init__(n_peers, seed)
        if mean_up < 1.0 or mean_down < 1.0:
            raise ValueError("dwell times are in iterations; need >= 1")
        self.mean_up = mean_up
        self.mean_down = mean_down
        self._rng = np.random.default_rng(seed * 9176 + 11)
        self.online = self._rng.random(n_peers) < start_online

    def tick(self, t: int) -> ChurnTick:
        prev = self.online.copy()
        leave = self._rng.random(self.n_peers) < 1.0 / self.mean_up
        come = self._rng.random(self.n_peers) < 1.0 / self.mean_down
        self.online = np.where(prev, ~leave, come)
        self.online = self._ensure_someone(self.online, self._rng)
        u = self.online.astype(np.float32)
        return ChurnTick(u, u.copy(),
                         events=self._delta_events(t, prev, self.online))

    def resize(self, new_n: int) -> None:
        old = self.online
        self.online = np.ones(new_n, bool)
        self.online[:min(new_n, len(old))] = old[:new_n]
        self.n_peers = new_n


@register_churn
class CorrelatedOutageChurn(ChurnModel):
    """Region-level correlated outages + background i.i.d. dropout.

    Peers are split into ``n_regions`` contiguous blocks (think racks,
    cells, or MAR leaf groups). Each iteration a healthy region fails
    with probability ``outage_rate``; an outage lasts a geometric number
    of iterations with mean ``mean_outage``. All peers of a failed
    region go down *together* — the failure mode i.i.d. masks cannot
    express, and the one that stresses MAR's group structure most (a
    whole group missing leaves its group mean to the fallback path).
    """

    name = "correlated"

    def __init__(self, n_peers: int, seed: int = 0, n_regions: int = 4,
                 outage_rate: float = 0.05, mean_outage: float = 3.0,
                 base_dropout: float = 0.05):
        super().__init__(n_peers, seed)
        self.n_regions = max(1, min(n_regions, n_peers))
        self.outage_rate = outage_rate
        self.mean_outage = max(1.0, mean_outage)
        self.base_dropout = base_dropout
        self._rng = np.random.default_rng(seed * 5147 + 29)
        self._remaining = np.zeros(self.n_regions, np.int64)
        self._prev = np.ones(n_peers, bool)

    def region_of(self, peers: Optional[np.ndarray] = None) -> np.ndarray:
        peers = np.arange(self.n_peers) if peers is None else peers
        block = -(-self.n_peers // self.n_regions)
        return peers // block

    def tick(self, t: int) -> ChurnTick:
        rng = self._rng
        self._remaining = np.maximum(self._remaining - 1, 0)
        fresh = (self._remaining == 0) & \
            (rng.random(self.n_regions) < self.outage_rate)
        if fresh.any():
            self._remaining[fresh] = 1 + rng.geometric(
                1.0 / self.mean_outage, int(fresh.sum()))
        region_ok = self._remaining == 0
        up = region_ok[self.region_of()]
        u = up & ~(rng.random(self.n_peers) < self.base_dropout)
        u = self._ensure_someone(u, rng)
        events = self._delta_events(t, self._prev, u)
        self._prev = u.copy()
        m = u.astype(np.float32)
        return ChurnTick(m, m.copy(), events=events)

    def resize(self, new_n: int) -> None:
        self.n_peers = new_n
        new_regions = max(1, min(self.n_regions, new_n))
        if new_regions != self.n_regions:
            rem = np.zeros(new_regions, np.int64)
            rem[:min(new_regions, len(self._remaining))] = \
                self._remaining[:new_regions]
            self._remaining = rem
            self.n_regions = new_regions
        self._prev = np.ones(new_n, bool)


@register_churn
class WirelessStragglerChurn(ChurnModel):
    """Deadline-based wireless stragglers (paper's dropout semantics).

    Every peer draws a base compute rate at init — a ``slow_frac`` tail
    runs ``slow_factor`` x slower (heterogeneous edge hardware). Each
    iteration the peer's local-update duration is its base time under
    lognormal jitter; the :class:`StragglerPolicy` deadline (median +
    k * MAD) decides who misses aggregation. Stragglers stay in U_t
    (their update happened, state advances) but leave A_t — exactly the
    paper's "update done, aggregation missed" dropout.
    """

    name = "wireless"

    def __init__(self, n_peers: int, seed: int = 0, mean_s: float = 1.0,
                 slow_frac: float = 0.2, slow_factor: float = 4.0,
                 jitter: float = 0.15, policy: Optional[StragglerPolicy]
                 = None):
        super().__init__(n_peers, seed)
        self.mean_s = mean_s
        self.slow_frac = slow_frac
        self.slow_factor = slow_factor
        self.jitter = jitter
        self.policy = policy or StragglerPolicy(k_std=3.0,
                                                min_deadline_s=0.0)
        self._rng = np.random.default_rng(seed * 7877 + 3)
        self._base = self._draw_base(n_peers)

    def _draw_base(self, n: int) -> np.ndarray:
        base = np.full(n, self.mean_s)
        slow = self._rng.random(n) < self.slow_frac
        base[slow] *= self.slow_factor
        return base

    def tick(self, t: int) -> ChurnTick:
        dur = self._base * np.exp(
            self._rng.normal(0.0, self.jitter, self.n_peers))
        a = self.policy.mask(dur)
        u = np.ones(self.n_peers, np.float32)
        events = []
        stragglers = np.flatnonzero(a == 0.0)
        if stragglers.size:
            events.append(MembershipEvent(t, STRAGGLE, tuple(stragglers)))
        return ChurnTick(u, a.astype(np.float32), durations=dur,
                         events=events)

    def resize(self, new_n: int) -> None:
        old = self._base
        self._base = self._draw_base(new_n)
        self._base[:min(new_n, len(old))] = old[:new_n]
        self.n_peers = new_n


@register_churn
class LinkStragglerChurn(ChurnModel):
    """Deadline stragglers driven by *modeled link time* (DESIGN.md §9).

    Where :class:`WirelessStragglerChurn` draws abstract compute rates,
    this model binds the straggler semantics to the discrete-event
    network layer: each peer's per-iteration duration is its local
    compute time plus the simulated cost of its MAR sends — ``rounds``
    rounds of ``(group_size - 1)`` model transfers serialized over the
    peer's own modeled uplink, plus propagation latency — drawn from a
    ``runtime/network.py`` link profile. A peer misses its group
    deadline *because its simulated uplink is slow*, the paper §3.1
    "update done, aggregation missed" dropout, now with a physical
    cause. Share ``profile``/``link_params``/``seed`` with the
    federation's ``NetworkSim`` to keep the straggler process and the
    transcript on the same links.
    """

    name = "link"

    def __init__(self, n_peers: int, seed: int = 0,
                 profile: str = "wireless", model_bytes: float = 4e6,
                 group_size: int = 4, rounds: int = 3,
                 compute_s: float = 0.5, jitter: float = 0.2,
                 link_params: Optional[Dict[str, Any]] = None,
                 policy: Optional[StragglerPolicy] = None):
        from repro_torch.runtime.network import build_link_model
        super().__init__(n_peers, seed)
        self.links = build_link_model(profile, n_peers, seed=seed,
                                      **(link_params or {}))
        self.model_bytes = model_bytes
        self.group_size = group_size
        self.rounds = rounds
        self.compute_s = compute_s
        self.jitter = jitter
        # lognormal link tails are one-sided: median + 2*MAD keeps the
        # bulk while cutting the slow-uplink tail every iteration
        self.policy = policy or StragglerPolicy(k_std=2.0,
                                                min_deadline_s=0.0)
        self._rng = np.random.default_rng(seed * 12553 + 19)

    def comm_s(self) -> np.ndarray:
        """Deterministic per-peer aggregation cost on the modeled links:
        uplink serialization of the round sends + per-round latency."""
        sends = max(self.group_size - 1, 0) * self.model_bytes
        return self.rounds * (sends / self.links.up
                              + 2.0 * self.links.lat)

    def tick(self, t: int) -> ChurnTick:
        compute = self.compute_s * np.exp(
            self._rng.normal(0.0, self.jitter, self.n_peers))
        dur = compute + self.comm_s()
        a = self.policy.mask(dur)
        u = np.ones(self.n_peers, np.float32)
        events = []
        stragglers = np.flatnonzero(a == 0.0)
        if stragglers.size:
            events.append(MembershipEvent(t, STRAGGLE, tuple(stragglers)))
        return ChurnTick(u, a.astype(np.float32), durations=dur,
                         events=events)

    def resize(self, new_n: int) -> None:
        self.links.resize(new_n)   # survivors keep their links
        self.n_peers = new_n


@register_churn
class TraceChurn(ChurnModel):
    """Replay a recorded membership-event stream (JSONL).

    The trace is the event *delta* representation written by
    :func:`save_trace`: ``down``/``up`` toggle availability,
    ``straggle`` removes peers from A_t for one iteration, and
    ``join``/``leave`` change the peer count permanently (the lifecycle
    turns those into elastic resizes). Iterations past the last traced
    event hold the final availability.
    """

    name = "trace"

    def __init__(self, n_peers: int, seed: int = 0,
                 path: Optional[str] = None,
                 events: Optional[Iterable[MembershipEvent]] = None):
        super().__init__(n_peers, seed)
        if (path is None) == (events is None):
            raise ValueError("TraceChurn needs exactly one of path/events")
        evs = load_trace(path) if path is not None else list(events)
        self._by_t: Dict[int, List[MembershipEvent]] = {}
        for e in evs:
            self._by_t.setdefault(e.iteration, []).append(e)
        self.available = np.ones(n_peers, bool)

    def pending_resize(self, t: int,
                       n_peers: Optional[int] = None) -> Optional[int]:
        """Net peer count after iteration ``t``'s join/leave events, or
        None when membership is unchanged (lifecycle polls this first).
        ``n_peers`` overrides the live count for pure look-ahead scans
        (:meth:`PeerLifecycle.planned_resizes`)."""
        n0 = self.n_peers if n_peers is None else n_peers
        n = n0
        for e in self._by_t.get(t, ()):
            if e.kind == JOIN:
                n += len(e.peers)
            elif e.kind == LEAVE:
                n -= len(e.peers)
        return n if n != n0 else None

    def tick(self, t: int) -> ChurnTick:
        events = list(self._by_t.get(t, ()))
        straggle = np.zeros(self.n_peers, bool)
        for e in events:
            for p in e.peers:
                if p >= self.n_peers:
                    continue
                if e.kind == DOWN:
                    self.available[p] = False
                elif e.kind == UP:
                    self.available[p] = True
                elif e.kind in (STRAGGLE, DEAD):
                    straggle[p] = True
        u = self.available.copy()
        if not u.any():
            u[0] = True
        a = u & ~straggle
        if not a.any():
            a[np.flatnonzero(u)[0]] = True
        return ChurnTick(u.astype(np.float32), a.astype(np.float32),
                         events=events)

    def resize(self, new_n: int) -> None:
        old = self.available
        self.available = np.ones(new_n, bool)
        self.available[:min(new_n, len(old))] = old[:new_n]
        self.n_peers = new_n


def save_trace(path: str, events: Sequence[MembershipEvent]) -> None:
    """Write a replayable JSONL membership trace."""
    with open(path, "w") as f:
        for e in sorted(events, key=lambda e: e.iteration):
            f.write(json.dumps(e.to_json()) + "\n")


def load_trace(path: str) -> List[MembershipEvent]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(MembershipEvent.from_json(json.loads(line)))
    return out


# ---------------------------------------------------------------------------
# the lifecycle runtime
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LifecycleTick:
    """What the training loop consumes each iteration."""

    u: np.ndarray                      # participation mask U_t [n] f32
    a: np.ndarray                      # aggregation mask A_t [n] f32
    resize_to: Optional[int] = None    # permanent capacity change
    events: List[MembershipEvent] = dataclasses.field(default_factory=list)


class PeerLifecycle:
    """Event-driven membership runtime for one federation.

    Composes a :class:`ChurnModel` with the fault machinery and a
    permanent-resize schedule:

    * model ticks produce base U_t/A_t and transient events;
    * simulated (or reported) durations feed :class:`HealthTracker`
      heartbeats; ``sweep()`` runs every iteration, so a peer that
      stops heartbeating for ``timeout`` iterations is marked DEAD and
      masked until it heartbeats again;
    * ``schedule`` entries ``(iteration, n_peers)`` — plus JOIN/LEAVE
      events from trace models — surface as ``resize_to``, which the
      training loop answers with ``Federation.resize`` (elastic
      regrouping, no restart).

    The lifecycle clock is the FL iteration counter: heartbeat
    timestamps and timeouts are measured in iterations for simulated
    models. Callers with real wall-clock durations (``launch/train.py``)
    report them via :meth:`observe_durations`.
    """

    def __init__(self, model: ChurnModel,
                 health: Optional[HealthTracker] = None,
                 straggler: Optional[StragglerPolicy] = None,
                 schedule: Sequence[Tuple[int, int]] = ()):
        self.model = model
        self.health = health
        self.straggler = straggler
        self.schedule = dict(schedule)
        self.event_log: List[MembershipEvent] = []
        self._prev_u = np.ones(model.n_peers, bool)
        if self.health is not None:
            for p in self.health.peers.values():
                p.last_heartbeat = 0.0   # iteration clock starts at 0

    @property
    def n_peers(self) -> int:
        return self.model.n_peers

    # ------------------------------------------------------------------
    def tick(self, t: int) -> LifecycleTick:
        # 1) permanent membership first, so masks are sized for the new
        #    fleet: scheduled resizes, then trace-driven join/leave
        resize_to = self.schedule.get(t)
        if resize_to is None and hasattr(self.model, "pending_resize"):
            resize_to = self.model.pending_resize(t)
        if resize_to is not None and resize_to != self.model.n_peers:
            old_n = self.model.n_peers
            kind = JOIN if resize_to > old_n else LEAVE
            lo, hi = sorted((old_n, resize_to))
            self.event_log.append(
                MembershipEvent(t, kind, tuple(range(lo, hi))))
            self.resize(resize_to, now=float(t))
        else:
            resize_to = None

        # 2) the availability process
        ct = self.model.tick(t)
        u, a = ct.u.copy(), ct.a.copy()
        events = list(ct.events)

        # 3) health. Masks use the PRE-heartbeat alive state, so an
        #    externally mark_failed peer is excluded this iteration and
        #    rejoins via its next heartbeat (with the group mean — the
        #    paper's recovery path); heartbeats for peers the model ran
        #    this iteration come after, then the sweep that catches
        #    silent peers (timeout measured in iterations).
        if self.health is not None:
            alive = self.health.alive_mask()
            for p in np.flatnonzero(u > 0):
                dur = (float(ct.durations[p])
                       if ct.durations is not None else None)
                self.health.heartbeat(int(p), dur, now=float(t))
            dead = self.health.sweep(now=float(t))
            if dead:
                events.append(MembershipEvent(t, DEAD, tuple(dead)))
            u, a = u * alive, a * alive

        # 4) deadline policy on reported durations (when the model did
        #    not already apply one)
        if (self.straggler is not None and ct.durations is not None
                and not isinstance(self.model, (WirelessStragglerChurn,
                                                LinkStragglerChurn))):
            sm = self.straggler.mask(ct.durations)
            cut = np.flatnonzero((a > 0) & (sm == 0))
            if cut.size:
                events.append(MembershipEvent(t, STRAGGLE, tuple(cut)))
            a = a * sm

        # never let the fleet go fully silent (Alg. 1 needs >= 1 peer)
        if not (u > 0).any():
            u[0] = 1.0
        if not (a > 0).any():
            a[np.flatnonzero(u > 0)[0]] = 1.0

        # the event_log records deltas of the FINAL masks (health and
        # deadline effects folded in), so save_trace(event_log) replays
        # this exact run through TraceChurn; ``tick.events`` keeps the
        # richer per-consumer view (DEAD, model-level transitions)
        self.event_log.extend(
            ChurnModel._delta_events(t, self._prev_u, u > 0))
        self._prev_u = u > 0
        stragglers = np.flatnonzero((u > 0) & (a == 0))
        if stragglers.size:
            self.event_log.append(
                MembershipEvent(t, STRAGGLE, tuple(stragglers)))
        return LifecycleTick(u.astype(np.float32), a.astype(np.float32),
                             resize_to=resize_to, events=events)

    # ------------------------------------------------------------------
    def planned_resizes(self, start: int, stop: int
                        ) -> List[Tuple[int, int]]:
        """Permanent join/leave the schedule and the trace will request
        in iterations ``[start, stop)`` — ``[(iteration, new_n), ...]``
        in order.

        Pure look-ahead (no model state is consumed): callers that
        cannot honor mid-run resizes — the device backend in
        ``launch/train.py`` needs an exact grid — validate the whole
        run up front and fail fast at launch instead of discovering the
        constraint when the tick fires mid-run.
        """
        out: List[Tuple[int, int]] = []
        n = self.model.n_peers
        for t in range(start, stop):
            target = self.schedule.get(t)
            if target is None and hasattr(self.model, "pending_resize"):
                target = self.model.pending_resize(t, n_peers=n)
            if target is not None and target != n:
                out.append((t, int(target)))
                n = int(target)
        return out

    # ------------------------------------------------------------------
    def observe_durations(self, t: int, durations: np.ndarray,
                          mask: Optional[np.ndarray] = None) -> None:
        """Report measured per-peer durations (wall-clock callers)."""
        if self.health is None:
            return
        for p in range(min(len(durations), self.model.n_peers)):
            if mask is None or mask[p] > 0:
                self.health.heartbeat(p, float(durations[p]),
                                      now=float(t))

    def resize(self, new_n: int, now: Optional[float] = None) -> None:
        """Propagate a permanent capacity change to model + trackers.

        ``now`` is the lifecycle-clock time joining peers count as
        first seen (their heartbeat baseline) — without it a late
        joiner would look timeout-stale at its very first sweep.
        """
        from collections import deque

        from repro_torch.runtime.fault import PeerHealth
        self.model.resize(new_n)
        old_prev = self._prev_u
        self._prev_u = np.ones(new_n, bool)
        self._prev_u[:min(new_n, len(old_prev))] = old_prev[:new_n]
        if self.health is not None:
            old = self.health.peers
            history = (next(iter(old.values())).durations.maxlen
                       if old else 16)
            if now is None and old:
                now = max(p.last_heartbeat for p in old.values())
            self.health.peers = {
                i: old[i] if i in old else
                PeerHealth(now or 0.0, deque(maxlen=history))
                for i in range(new_n)
            }


# ---------------------------------------------------------------------------
# config-driven assembly
# ---------------------------------------------------------------------------

def build_lifecycle(churn: Optional[str], n_peers: int, *, seed: int = 0,
                    participation_rate: float = 1.0,
                    dropout_rate: float = 0.0,
                    churn_params: Optional[Dict[str, Any]] = None,
                    schedule: Sequence[Tuple[int, int]] = (),
                    health: Optional[HealthTracker] = None,
                    straggler: Optional[StragglerPolicy] = None
                    ) -> PeerLifecycle:
    """One factory for every caller (Federation, train.py, benchmarks).

    ``churn=None`` builds the Bernoulli degenerate case from the legacy
    participation/dropout knobs — existing configs replay bit-exact.
    """
    params = dict(churn_params or {})
    name = churn or "bernoulli"
    if name == "bernoulli":
        params.setdefault("participation_rate", participation_rate)
        params.setdefault("dropout_rate", dropout_rate)
    if name in ("wireless", "link") and straggler is not None:
        # the caller's deadline policy governs the simulated stragglers
        params.setdefault("policy", straggler)
    model = build_churn_model(name, n_peers, seed=seed, **params)
    return PeerLifecycle(model, health=health, straggler=straggler,
                         schedule=schedule)
