"""Discrete-event P2P network layer: measured messages, wall-clock time.

The wireless-FL literature (PAPERS.md: Zhou et al. "Towards Scalable
Wireless Federated Learning"; Le et al. "Exploring the Practicality of
Federated Learning") is clear that link heterogeneity and per-round
timing — not byte counts alone — decide real-world scalability. This
module gives the stack that time axis:

* :class:`LinkModel` registry — per-peer link parameters (uplink /
  downlink bandwidth, propagation latency, per-message loss
  probability). Built-ins: ``uniform`` (homogeneous wired links, the
  lossless default whose transcript is byte-identical to the analytic
  oracles), ``wireless`` (lognormal bandwidth/latency heterogeneity —
  the slow-uplink tail that makes per-round *seconds* diverge from
  per-round *bytes*), ``regions`` (contiguous peer blocks on shared
  per-region profiles: fiber / cable / wireless tiers).

* :class:`NetworkSim` — an event-driven simulator over a
  :class:`~repro.core.transport.MessagePlan`. Each message becomes a
  timed event: it leaves when its sender is ready (previous round done)
  and its uplink drains (transmissions serialize over the sender's
  uplink — the wireless contention model that makes AR-FL's N-1 sends
  per peer cost O(N) *seconds*, not just O(N^2) bytes), arrives after
  transfer + propagation, and may be lost. Arrival events drain through
  a single time-ordered queue; per-peer ready times advance to the last
  arrival, so group barriers, ring hops, and hierarchy waits all emerge
  from message structure alone.

* :class:`~repro.runtime.transport_base.Transcript` — what actually
  happened: per-link and per-round bytes, per-round completion times,
  per-peer finish times, dropped messages, and the senders whose
  traffic was lost (the federation demotes them to receiver-only for
  the iteration — paper §3.1 churn semantics). The transcript, not the
  closed-form formulas in ``core/topology.py``, feeds the
  ``CommLedger``; the formulas stay as cross-checked oracles
  (``tests/test_network.py``).

:class:`NetworkSim` is the ``"sim"`` backend of the pluggable
:class:`~repro.runtime.transport_base.Transport` interface — the same
MessagePlans run unchanged over real loopback TCP
(``runtime/socket_transport.py``), and the two transcripts are
byte-identical in the no-loss case (DESIGN.md §10).

Node ids ``>= n_peers`` (the FedAvg server, the hierarchical
rendezvous) are infrastructure: unbounded bandwidth, zero latency,
lossless — client links stay the bottleneck.

A copy of the JAX package's ``repro/runtime/network.py`` (numpy) with its imports
rewritten; tests hold it equal to the reference.
"""
from __future__ import annotations

import heapq
from typing import Any, Dict, List, Optional, Tuple, Type

import numpy as np

from repro_torch.core.transport import Message, MessagePlan
from repro_torch.runtime.transport_base import (LinkAccounting, Transcript,
                                          Transport,
                                          demote_lost_senders,
                                          register_transport)

__all__ = ["LINK_MODELS", "LinkModel", "MBPS", "NetworkSim", "Transcript",
           "UniformLinks", "LognormalWirelessLinks", "RegionLinks",
           "build_link_model", "demote_lost_senders",
           "register_link_model"]

MBPS = 125_000.0          # 1 Mbit/s in bytes/s


# ---------------------------------------------------------------------------
# link models
# ---------------------------------------------------------------------------

LINK_MODELS: Dict[str, Type["LinkModel"]] = {}


def register_link_model(cls: Type["LinkModel"]) -> Type["LinkModel"]:
    LINK_MODELS[cls.name] = cls
    return cls


def build_link_model(name: str, n_peers: int, seed: int = 0,
                     **params: Any) -> "LinkModel":
    if name not in LINK_MODELS:
        raise ValueError(f"unknown link profile {name!r}; "
                         f"registered: {sorted(LINK_MODELS)}")
    return LINK_MODELS[name](n_peers, seed=seed, **params)


class LinkModel:
    """Per-peer link parameters, drawn once at construction.

    Arrays (length ``n_peers``): ``up`` / ``down`` in bytes/s, ``lat``
    one-way propagation seconds, ``loss`` per-message loss probability.
    ``resize`` keeps survivors' links bit-identical and draws fresh
    links for joiners (elastic membership).
    """

    name: str = "?"

    def __init__(self, n_peers: int, seed: int = 0):
        self.n_peers = n_peers
        self.seed = seed
        self.up, self.down, self.lat, self.loss = self._draw(n_peers)

    def _draw(self, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]:
        raise NotImplementedError

    def peer_attrs(self) -> Dict[str, np.ndarray]:
        """Ground-truth per-peer link parameters (copies).

        The public accessor benchmarks and tests score against instead
        of reaching into private fields; profiles with structure beyond
        the four base arrays (e.g. :class:`RegionLinks`) extend the
        dict — ``"region"`` is the ground-truth cluster label the
        placement benchmark grades recovered clusters with.
        """
        return {"up": self.up.copy(), "down": self.down.copy(),
                "lat": self.lat.copy(), "loss": self.loss.copy()}

    @property
    def has_pair_terms(self) -> bool:
        """True when some (src, dst) pairs carry extra cost beyond the
        endpoints' own parameters (see :meth:`pair_terms`). The
        closed-form engines cannot model this and must refuse."""
        return False

    def pair_terms(self, src: np.ndarray | int,
                   dst: np.ndarray | int) -> Tuple[np.ndarray,
                                                   np.ndarray]:
        """Pairwise ``(bandwidth_cap_bps, extra_latency_s)`` for real
        src/dst indices — ``(inf, 0.0)`` where the pair adds nothing.
        Base models have no pair structure."""
        src = np.asarray(src)
        return (np.full(src.shape, np.inf),
                np.zeros(src.shape))

    def resize(self, new_n: int) -> None:
        old = (self.up, self.down, self.lat, self.loss)
        keep = min(new_n, self.n_peers)
        self.up, self.down, self.lat, self.loss = self._draw(new_n)
        for new_arr, old_arr in zip(
                (self.up, self.down, self.lat, self.loss), old):
            new_arr[:keep] = old_arr[:keep]
        self.n_peers = new_n


@register_link_model
class UniformLinks(LinkModel):
    """Homogeneous wired links — the lossless default.

    With loss 0 the transcript's *bytes* are exactly the analytic
    oracle's at full participation; time is still modeled, so even the
    ideal profile yields per-round wall-clock.
    """

    name = "uniform"

    def __init__(self, n_peers: int, seed: int = 0,
                 bandwidth_bps: float = 1000 * MBPS,
                 latency_s: float = 0.001, loss: float = 0.0):
        self.bandwidth_bps = bandwidth_bps
        self.latency_s = latency_s
        self.loss_rate = loss
        super().__init__(n_peers, seed)

    def _draw(self, n):
        return (np.full(n, self.bandwidth_bps),
                np.full(n, self.bandwidth_bps),
                np.full(n, self.latency_s),
                np.full(n, self.loss_rate))


@register_link_model
class LognormalWirelessLinks(LinkModel):
    """Lognormal-heterogeneous wireless edge links.

    Medians default to a mid-band cellular uplink (20 Mbit/s up,
    100 Mbit/s down, 25 ms one-way); ``sigma`` controls the
    heterogeneity tail — at the default 0.6 the p95/median uplink ratio
    is ~2.7x, the slow tail that turns byte savings into wall-clock
    savings. Per-message loss is i.i.d. at ``loss``.
    """

    name = "wireless"

    def __init__(self, n_peers: int, seed: int = 0,
                 uplink_bps: float = 20 * MBPS,
                 downlink_bps: float = 100 * MBPS,
                 latency_s: float = 0.025, sigma: float = 0.6,
                 latency_sigma: float = 0.4, loss: float = 0.0):
        self.uplink_bps = uplink_bps
        self.downlink_bps = downlink_bps
        self.latency_s = latency_s
        self.sigma = sigma
        self.latency_sigma = latency_sigma
        self.loss_rate = loss
        super().__init__(n_peers, seed)

    def _draw(self, n):
        rng = np.random.default_rng(self.seed * 64901 + 17)
        up = self.uplink_bps * np.exp(rng.normal(0, self.sigma, n))
        down = self.downlink_bps * np.exp(rng.normal(0, self.sigma, n))
        lat = self.latency_s * np.exp(rng.normal(0, self.latency_sigma, n))
        return up, down, lat, np.full(n, self.loss_rate)


@register_link_model
class RegionLinks(LinkModel):
    """Per-region profiles: contiguous peer blocks share a tier.

    ``profiles`` is a sequence of ``(uplink_bps, downlink_bps,
    latency_s, loss)`` tuples assigned round-robin to ``n_regions``
    contiguous blocks (the same region layout as
    ``lifecycle.CorrelatedOutageChurn``); per-peer jitter stays small so
    within-region links are near-identical — the structured
    heterogeneity a lognormal draw cannot express.

    Cross-region messages additionally traverse the WAN:
    ``inter_bw_bps`` caps their transfer (and the sender's uplink drain
    for that message — a flow throttled by the WAN frees the local
    uplink no faster than the WAN accepts bytes) and
    ``inter_latency_s`` adds one-way propagation. Intra-region traffic
    pays neither, which is exactly the asymmetry topology-aware
    placement (``core/placement.py``) exploits. Set
    ``inter_bw_bps=None, inter_latency_s=0.0`` for the flat pre-WAN
    behavior.

    ``shuffle=True`` scatters the region assignment over peer indices
    (seeded) instead of contiguous blocks — peers joined in arbitrary
    order, so raw-index grid coordinates interleave regions and every
    aggregation round crosses the WAN. This is the misaligned world
    placement policies exist for; the default stays the contiguous
    (aligned) layout, bit-identical to the historical draws.
    """

    name = "regions"

    DEFAULT_PROFILES = (
        (500 * MBPS, 500 * MBPS, 0.002, 0.0),     # fiber
        (50 * MBPS, 200 * MBPS, 0.015, 0.0),      # cable
        (10 * MBPS, 50 * MBPS, 0.040, 0.01),      # congested wireless
    )

    def __init__(self, n_peers: int, seed: int = 0, n_regions: int = 4,
                 profiles: Optional[Tuple[Tuple[float, float, float, float],
                                          ...]] = None,
                 jitter: float = 0.05, loss: Optional[float] = None,
                 inter_bw_bps: Optional[float] = 5 * MBPS,
                 inter_latency_s: float = 0.03,
                 shuffle: bool = False):
        self.n_regions = max(1, min(n_regions, n_peers))
        self.profiles = tuple(profiles or self.DEFAULT_PROFILES)
        self.jitter = jitter
        self.loss_override = loss      # None -> per-tier profile loss
        self.inter_bw_bps = inter_bw_bps
        self.inter_latency_s = inter_latency_s
        self.shuffle = shuffle
        super().__init__(n_peers, seed)

    def region_of(self, n: Optional[int] = None) -> np.ndarray:
        n = self.n_peers if n is None else n
        block = -(-n // self.n_regions)
        region = np.arange(n) // block
        if self.shuffle:
            region = region[np.random.default_rng(
                self.seed * 31337 + 11).permutation(n)]
        return region

    def peer_attrs(self) -> Dict[str, np.ndarray]:
        attrs = super().peer_attrs()
        attrs["region"] = self.region_of()
        return attrs

    @property
    def has_pair_terms(self) -> bool:
        return self.inter_bw_bps is not None or self.inter_latency_s > 0

    def pair_terms(self, src, dst):
        r = self.region_of()
        cross = r[np.asarray(src)] != r[np.asarray(dst)]
        cap = np.where(
            cross,
            np.inf if self.inter_bw_bps is None else self.inter_bw_bps,
            np.inf)
        return cap, np.where(cross, self.inter_latency_s, 0.0)

    def _draw(self, n):
        rng = np.random.default_rng(self.seed * 88007 + 5)
        region = self.region_of(n)
        prof = np.array([self.profiles[r % len(self.profiles)]
                         for r in region])
        jit = np.exp(rng.normal(0, self.jitter, (n, 3)))
        loss = (np.full(n, self.loss_override)
                if self.loss_override is not None else prof[:, 3].copy())
        return (prof[:, 0] * jit[:, 0], prof[:, 1] * jit[:, 1],
                prof[:, 2] * jit[:, 2], loss)


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------

@register_transport
class NetworkSim(Transport):
    """Event-driven message timing over a :class:`LinkModel` — the
    ``"sim"`` transport backend.

    One :meth:`run` call simulates one FL iteration's
    :class:`MessagePlan` and returns its :class:`Transcript`;
    ``clock`` accumulates simulated seconds across iterations (the
    wall-clock axis benchmarks and the training history report).

    Timing model, per message ``src -> dst`` in round ``r``:

    * *send start* — when ``src`` is ready (all its round ``r-1``
      arrivals in, uplink drained) and its uplink frees up: a peer's
      transmissions serialize over its single uplink.
    * *transfer* — ``nbytes / min(up[src], down[dst])``; the slower
      endpoint is the bottleneck.
    * *arrival* — send end + ``lat[src] + lat[dst]``.
    * *loss* — Bernoulli per message at the combined endpoint rate;
      lost messages consumed airtime (bytes are billed) but never
      arrive, and their sender is flagged in ``lost_senders``.

    Loopback messages (``src == dst``) and infrastructure nodes
    (``id >= n_peers``) take zero time; infrastructure is lossless.
    """

    name = "sim"

    def __init__(self, n_peers: int, profile: str = "uniform",
                 seed: int = 0,
                 link_params: Optional[Dict[str, Any]] = None,
                 links: Optional[LinkModel] = None):
        self.links = links if links is not None else build_link_model(
            profile, n_peers, seed=seed, **(link_params or {}))
        self.seed = seed
        self.clock = 0.0           # cumulative simulated seconds
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
        """Elastic membership: survivors keep their links, joiners draw
        fresh ones; the cumulative clock carries over."""
        self.links.resize(new_n)

    # ------------------------------------------------------------------
    def run(self, plan: MessagePlan,
            compute_s: Optional[np.ndarray] = None,
            payloads: Optional[Any] = None) -> Transcript:
        """Simulate one iteration; ``compute_s`` (per real peer) seeds
        each peer's ready time with its local-update duration so slow
        *compute* and slow *links* compose into one finish time.
        ``payloads`` is accepted for Transport-interface compatibility
        and ignored — no real byte crosses the simulator."""
        links = self.links
        n_real = links.n_peers
        n_nodes = max(plan.n_nodes, n_real)
        rng = np.random.default_rng(
            (self.seed + 1) * 48611 + self.iterations)

        ready = np.zeros(n_nodes)
        if compute_s is not None:
            ready[:min(n_real, len(compute_s))] = \
                compute_s[:n_real]
        tr = Transcript(technique=plan.technique,
                        lost_senders=np.zeros(n_real, bool))
        acct = LinkAccounting(n_nodes, n_real)

        def up(i):
            return links.up[i] if i < n_real else np.inf

        def down(i):
            return links.down[i] if i < n_real else np.inf

        def lat(i):
            return links.lat[i] if i < n_real else 0.0

        def loss_p(s, d):
            ls = links.loss[s] if s < n_real else 0.0
            ld = links.loss[d] if d < n_real else 0.0
            return 1.0 - (1.0 - ls) * (1.0 - ld)

        pairwise = getattr(links, "has_pair_terms", False)

        def pair(s, d):
            if pairwise and s < n_real and d < n_real:
                cap, xlat = links.pair_terms(s, d)
                return float(cap), float(xlat)
            return np.inf, 0.0

        for messages in plan.rounds:
            events: List[Tuple[float, int, Message, bool]] = []
            busy = ready.copy()            # per-node uplink drain time
            rbytes = 0.0
            for seq, msg in enumerate(messages):
                rbytes += msg.nbytes
                tr.total_bytes += msg.nbytes
                tr.n_messages += 1
                if msg.src == msg.dst:
                    acct.add(msg.src, msg.dst, msg.nbytes, 0.0)
                    continue               # loopback: billed, instant
                cap, xlat = pair(msg.src, msg.dst)
                bw = min(min(up(msg.src), down(msg.dst)), cap)
                tx = msg.nbytes / bw if np.isfinite(bw) else 0.0
                # the sender's uplink is occupied at its *own* drain
                # rate (infrastructure never serializes) — but a flow
                # capped by a pairwise WAN bottleneck drains no faster
                # than the WAN accepts bytes; the transfer itself runs
                # at the slowest of endpoint and pair terms
                occ_bw = min(up(msg.src), cap)
                occupy = (msg.nbytes / occ_bw
                          if np.isfinite(occ_bw) else 0.0)
                start = busy[msg.src]
                busy[msg.src] = start + occupy
                arrival = start + tx + lat(msg.src) + lat(msg.dst) + xlat
                acct.add(msg.src, msg.dst, msg.nbytes, arrival - start)
                lost = bool(rng.random() < loss_p(msg.src, msg.dst))
                heapq.heappush(events, (arrival, seq, msg, lost))
            # drain arrivals in time order
            new_ready = np.maximum(ready, busy)
            while events:
                t, _, msg, lost = heapq.heappop(events)
                if lost:
                    tr.dropped.append(msg)
                    if msg.src < n_real:
                        tr.lost_senders[msg.src] = True
                else:
                    new_ready[msg.dst] = max(new_ready[msg.dst], t)
            ready = new_ready
            tr.bytes_by_round.append(rbytes)
            tr.round_s.append(float(ready.max()))

        tr.peer_finish_s = ready[:n_real].copy()
        tr.iteration_s = float(ready.max()) if n_nodes else 0.0
        acct.finalize(tr)
        self._split_kd_bytes(tr, plan)
        self.clock += tr.iteration_s
        self.iterations += 1
        return tr
