"""The pluggable transport seam: one MessagePlan executor interface.

A :class:`~repro.core.transport.MessagePlan` says *what* one FL
iteration's traffic is — per-round ``(src, dst, nbytes)`` messages. A
:class:`Transport` says *how* those messages move: the discrete-event
simulator (``runtime/network.py``, backend ``"sim"``) times them over
modeled links; the real loopback transport
(``runtime/socket_transport.py``, backend ``"socket"``) runs every peer
as an asyncio task and pushes the bytes through actual TCP sockets.
Both return the same :class:`Transcript` shape — per-link and per-round
bytes, round completion times, per-peer finish times, dropped
messages — so the ``CommLedger`` (via
``AggregationPipeline.record_transcript``), the churn demotion rule
(:func:`demote_lost_senders`) and the benchmarks consume either backend
unchanged. That shared contract is what makes sim-vs-real calibration
possible (``benchmarks/transport_calibration.py``): the *bytes* of a
no-loss transcript are byte-identical across backends (both bill the
plan's scheduled sizes, the socket backend measuring them off received
frame headers), while the *seconds* axis is modeled on one and
wall-clock-measured on the other.

Backend selection threads through ``FederationConfig(transport=...)``
and ``launch/train.py --transport``; new backends register with
:func:`register_transport` and are built by name via
:func:`build_transport`.

A copy of the JAX package's ``repro/runtime/transport_base.py`` (numpy)
with its imports rewritten.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Type

import numpy as np

from repro_torch.core.transport import Message, MessagePlan


# ---------------------------------------------------------------------------
# the transcript — the one shape every backend emits
# ---------------------------------------------------------------------------

#: above this peer count, per-(src, dst) link accounting is aggregated
#: into per-peer totals + a top-k heavy-link dict — the dense dict is
#: O(N^2) entries and dominates memory long before the event engine does
LINK_DETAIL_MAX_PEERS = 512


@dataclasses.dataclass
class Transcript:
    """What one FL iteration actually did on the wire.

    Byte fields bill the plan's *scheduled* sizes (lost messages
    consumed airtime and are billed), so a no-loss transcript is
    byte-identical across transport backends. ``kd_bytes`` is the
    portion carried by the plan's MKD prefix rounds
    (``MessagePlan.kd_rounds``) — distillation traffic rides the same
    transport as aggregation traffic and is split back out for the
    ledger's per-source accounting. ``payload_bytes`` counts the actual
    octets a real transport moved through its frames (0 for the
    simulator).

    Per-link accounting has two modes (``link_mode``). ``"exact"`` —
    the small-N default — fills ``bytes_by_link`` with every (src, dst)
    pair. Above :data:`LINK_DETAIL_MAX_PEERS` peers the backends switch
    to ``"peer"``: ``tx_bytes_by_peer`` / ``rx_bytes_by_peer`` carry
    exact per-node totals, and ``bytes_by_link`` keeps only the top-k
    heavy links (exact totals unless the deferred link buffer had to be
    compacted — see :class:`LinkAccounting` — in which case per-link
    values are a lower bound, never an overcount).
    """

    technique: str
    n_messages: int = 0
    total_bytes: float = 0.0
    bytes_by_round: List[float] = dataclasses.field(default_factory=list)
    round_s: List[float] = dataclasses.field(default_factory=list)
    iteration_s: float = 0.0
    peer_finish_s: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    bytes_by_link: Dict[Tuple[int, int], float] = dataclasses.field(
        default_factory=dict)
    dropped: List[Message] = dataclasses.field(default_factory=list)
    lost_senders: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, bool))
    kd_bytes: float = 0.0
    payload_bytes: float = 0.0
    link_mode: str = "exact"
    tx_bytes_by_peer: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    rx_bytes_by_peer: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    #: per-link effective seconds: transfer + latency per message
    #: (arrival - send start, queue wait excluded), summed per
    #: (src, dst). Loopbacks contribute 0.0; lost messages are billed
    #: (their airtime was consumed). Follows ``link_mode`` exactly like
    #: the byte fields: ``"peer"`` mode keeps exact per-node totals in
    #: ``tx_seconds_by_peer`` / ``rx_seconds_by_peer`` and restricts
    #: ``link_time_stats`` to the byte top-k's key set. Filled by the
    #: modeled engines (sim / vector_sim); the socket backend leaves it
    #: empty — wall-clock per-message timing isn't observable from the
    #: receiving frame alone. This is the placement layer's evidence
    #: (``core/placement.py``): seconds-per-byte reveals slow links the
    #: byte totals can't.
    link_time_stats: Dict[Tuple[int, int], float] = dataclasses.field(
        default_factory=dict)
    tx_seconds_by_peer: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    rx_seconds_by_peer: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))

    @property
    def n_dropped(self) -> int:
        return len(self.dropped)

    def tail_stats(self) -> Tuple[float, float]:
        """(median, max) of positive per-peer finish times — the
        adaptive group-size controllers' signal (``core/adaptive.py``
        reads only this contract, so one policy tunes M over modeled
        links and over real sockets alike)."""
        f = np.asarray(self.peer_finish_s, float)
        f = f[f > 0]
        if f.size == 0:
            return 0.0, 0.0
        return float(np.median(f)), float(f.max())


class LinkAccounting:
    """Per-link byte accounting with an automatic large-N mode.

    At or below ``detail_max`` peers (default
    :data:`LINK_DETAIL_MAX_PEERS`) every (src, dst) pair is tracked —
    the exact dict the calibration gates and small-N tests compare.
    Above it, the accounting keeps exact per-node tx/rx totals, and
    per-link detail is deferred: each round appends its raw
    ``(key, bytes)`` arrays and :meth:`finalize` merges them once into
    exact per-link totals before taking the top ``top_k``. Only when
    the deferred buffer exceeds ``compact_at`` entries is it compacted
    down to a bounded candidate set — from then on the reported top-k
    is a per-link lower bound (a link must stay heavy to stay
    tracked), which keeps memory O(bound) on plans whose *distinct
    link count* itself is O(N^2).
    """

    def __init__(self, n_nodes: int, n_peers: int,
                 detail_max: Optional[int] = None, top_k: int = 32,
                 compact_at: int = 4_000_000,
                 track_links: bool = True):
        self.n_nodes = n_nodes
        self.top_k = top_k
        self.compact_at = compact_at
        if detail_max is None:
            detail_max = LINK_DETAIL_MAX_PEERS
        self.exact = n_peers <= detail_max
        #: peer mode only: when False, skip the deferred per-link
        #: (key, bytes) buffers entirely — per-node totals stay exact,
        #: ``bytes_by_link`` / ``link_time_stats`` come back empty. The
        #: superpeer engine disables tracking past a message budget
        #: where even the deferred buffers would dominate memory.
        self.track_links = track_links or self.exact
        self.links: Dict[Tuple[int, int], float] = {}
        self.link_secs: Dict[Tuple[int, int], float] = {}
        if not self.exact:
            self.tx = np.zeros(n_nodes)
            self.rx = np.zeros(n_nodes)
            self.tx_s = np.zeros(n_nodes)
            self.rx_s = np.zeros(n_nodes)
            self._keys: List[np.ndarray] = []
            self._sums: List[np.ndarray] = []
            self._secs: List[np.ndarray] = []
            self._pending = 0

    def add(self, src: int, dst: int, nbytes: float,
            seconds: float = 0.0) -> None:
        """Scalar path (the per-message heap / socket engines)."""
        if self.exact:
            key = (src, dst)
            self.links[key] = self.links.get(key, 0.0) + nbytes
            self.link_secs[key] = self.link_secs.get(key, 0.0) + seconds
        else:
            self.tx[src] += nbytes
            self.rx[dst] += nbytes
            self.tx_s[src] += seconds
            self.rx_s[dst] += seconds
            if not self.track_links:
                return
            self._keys.append(np.asarray([src * self.n_nodes + dst]))
            self._sums.append(np.asarray([float(nbytes)]))
            self._secs.append(np.asarray([float(seconds)]))
            self._pending += 1
            if self._pending > self.compact_at:
                self._compact()

    def add_batch(self, src: np.ndarray, dst: np.ndarray,
                  nbytes: np.ndarray,
                  seconds: Optional[np.ndarray] = None,
                  unique: bool = False) -> None:
        """Array path (the vectorized engine): one call per round.

        ``unique=True`` asserts that ``src`` has no repeated ids and
        ``dst`` has no repeated ids (each node sends and receives at
        most once in this batch) — peer-mode totals then use direct
        indexed adds instead of bincounts. Each per-node total still
        receives exactly one addend, so the result is bitwise the same.
        """
        if src.size == 0:
            return
        if seconds is None:
            seconds = np.zeros(src.size)
        if self.exact:
            keys = src * self.n_nodes + dst
            uniq, inv = np.unique(keys, return_inverse=True)
            sums = np.bincount(inv, weights=nbytes, minlength=uniq.size)
            secs = np.bincount(inv, weights=seconds,
                               minlength=uniq.size)
            links, lsecs = self.links, self.link_secs
            for k, v, s in zip(uniq.tolist(), sums.tolist(),
                               secs.tolist()):
                kk = (k // self.n_nodes, k % self.n_nodes)
                links[kk] = links.get(kk, 0.0) + v
                lsecs[kk] = lsecs.get(kk, 0.0) + s
            return
        if unique:
            self.tx[src] += nbytes
            self.rx[dst] += nbytes
            self.tx_s[src] += seconds
            self.rx_s[dst] += seconds
        else:
            self.tx += np.bincount(src, weights=nbytes,
                                   minlength=self.n_nodes)
            self.rx += np.bincount(dst, weights=nbytes,
                                   minlength=self.n_nodes)
            self.tx_s += np.bincount(src, weights=seconds,
                                     minlength=self.n_nodes)
            self.rx_s += np.bincount(dst, weights=seconds,
                                     minlength=self.n_nodes)
        if not self.track_links:
            return
        self._keys.append(src * self.n_nodes + dst)
        self._sums.append(np.asarray(nbytes, float))
        self._secs.append(np.asarray(seconds, float))
        self._pending += src.size
        if self._pending > self.compact_at:
            self._compact()

    def add_uniform_round(self, src: np.ndarray, dst: np.ndarray,
                          nbytes: float,
                          seconds: np.ndarray) -> None:
        """Round where ``src`` and ``dst`` are each a permutation of
        *all* nodes and every message carries ``nbytes`` bytes (a full
        MAR pair round at exact capacity). Peer-mode byte totals then
        add uniformly — each node gets exactly one ``nbytes`` addend,
        so ``tx += nbytes`` is bitwise the indexed add — and the
        seconds use the unique-indexed adds. Falls back to
        :meth:`add_batch` whenever per-link keys are kept (copying
        ``seconds``, which callers may hand in as a reused scratch
        buffer — the fast path consumes it immediately, but the
        fallback defers it into the per-link key buffers)."""
        if self.exact or self.track_links:
            self.add_batch(src, dst, np.full(src.size, nbytes),
                           seconds.copy(), unique=True)
            return
        self.tx += nbytes
        self.rx += nbytes
        self.tx_s[src] += seconds
        self.rx_s[dst] += seconds

    def _merge(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        keys = np.concatenate(self._keys) if self._keys else \
            np.empty(0, np.int64)
        sums = np.concatenate(self._sums) if self._sums else \
            np.empty(0)
        secs = np.concatenate(self._secs) if self._secs else \
            np.empty(0)
        uniq, inv = np.unique(keys, return_inverse=True)
        return (uniq,
                np.bincount(inv, weights=sums, minlength=uniq.size),
                np.bincount(inv, weights=secs, minlength=uniq.size))

    def _compact(self, bound: int = 65536) -> None:
        uniq, sums, secs = self._merge()
        if uniq.size > bound:
            top = np.argpartition(sums, -bound)[-bound:]
            uniq, sums, secs = uniq[top], sums[top], secs[top]
        self._keys, self._sums = [uniq], [sums]
        self._secs = [secs]
        self._pending = uniq.size

    def finalize(self, tr: "Transcript") -> None:
        if self.exact:
            tr.bytes_by_link = self.links
            tr.link_time_stats = self.link_secs
            return
        tr.link_mode = "peer"
        tr.tx_bytes_by_peer = self.tx
        tr.rx_bytes_by_peer = self.rx
        tr.tx_seconds_by_peer = self.tx_s
        tr.rx_seconds_by_peer = self.rx_s
        uniq, sums, secs = self._merge()
        if uniq.size > self.top_k:
            top = np.argpartition(sums, -self.top_k)[-self.top_k:]
            uniq, sums, secs = uniq[top], sums[top], secs[top]
        # one ranking (by bytes) keys both top-k dicts, so the byte and
        # seconds views of a heavy link stay aligned
        order = np.argsort(-sums, kind="stable")
        tr.bytes_by_link = {
            (int(k) // self.n_nodes, int(k) % self.n_nodes): float(v)
            for k, v in zip(uniq[order], sums[order])}
        tr.link_time_stats = {
            (int(k) // self.n_nodes, int(k) % self.n_nodes): float(s)
            for k, s in zip(uniq[order], secs[order])}


def demote_lost_senders(a: np.ndarray, u: np.ndarray,
                        transcript: Transcript) -> np.ndarray:
    """Fold a transcript's lost senders out of the aggregation mask.

    A peer whose send was dropped mid-round becomes receiver-only for
    this aggregation (paper §3.1 — it still receives the group mean);
    if every aggregator was lost, the first participating peer is kept
    so Alg. 1 always has >= 1 contributor. Returns a new mask; the sim
    federation, the device trainer, and both transport backends share
    this rule.
    """
    if not transcript.n_dropped:
        return a
    a = np.asarray(a) * (1.0 - transcript.lost_senders
                         .astype(np.float32))
    if not (a > 0).any():
        a[np.flatnonzero(np.asarray(u) > 0)[0]] = 1.0
    return a


# ---------------------------------------------------------------------------
# the transport interface + registry
# ---------------------------------------------------------------------------

TRANSPORTS: Dict[str, Type["Transport"]] = {}


def register_transport(cls: Type["Transport"]) -> Type["Transport"]:
    TRANSPORTS[cls.name] = cls
    return cls


class Transport:
    """A MessagePlan executor.

    One :meth:`run` call executes one FL iteration's plan and returns
    its :class:`Transcript`; ``clock`` accumulates seconds across
    iterations (simulated for the sim backend, wall-clock for real
    ones) and ``iterations`` counts runs — both feed the training
    history and benchmarks regardless of backend.
    """

    name: str = "?"
    #: a real transport serializes actual update tensors into its
    #: frames; the federation only encodes payloads when this is set
    wants_payloads: bool = False
    #: the plan shape this backend runs fastest on: ``"list"``
    #: (MessagePlan / ArrayMessagePlan, the default) or ``"super"``
    #: (the symbolic :class:`~repro.core.transport.SuperMessagePlan`
    #: recipe — no materialized messages). The federation negotiates
    #: via this attribute; every backend still accepts list plans.
    plan_format: str = "list"

    clock: float = 0.0
    iterations: int = 0

    @property
    def n_peers(self) -> int:
        raise NotImplementedError

    @property
    def lossless(self) -> bool:
        """True when no message of any run can be dropped — the
        fast-path predicate callers use to skip mask plumbing."""
        raise NotImplementedError

    def run(self, plan: MessagePlan,
            compute_s: Optional[np.ndarray] = None,
            payloads: Optional[Any] = None) -> Transcript:
        """Execute one iteration's plan; ``compute_s`` (per real peer)
        seeds peer readiness where the backend models it, ``payloads``
        carries per-peer serialized update bytes for backends that move
        real data (``wants_payloads``)."""
        raise NotImplementedError

    def resize(self, new_n: int) -> None:
        """Elastic membership: survivors keep their identity (and, for
        modeled backends, their links); the cumulative clock carries
        over."""
        raise NotImplementedError

    @classmethod
    def from_config(cls, n_peers: int, *, profile: Optional[str] = None,
                    seed: int = 0,
                    link_params: Optional[Dict[str, Any]] = None,
                    **kwargs: Any) -> "Transport":
        """Uniform constructor surface for :func:`build_transport`:
        every backend interprets the federation's link knobs its own
        way (the simulator builds a LinkModel; the socket backend has
        real loopback links and keeps only the loss rate for
        injection)."""
        raise NotImplementedError

    @staticmethod
    def _split_kd_bytes(tr: Transcript, plan: MessagePlan) -> None:
        """Fill ``kd_bytes`` from the plan's MKD prefix rounds — shared
        epilogue so both backends split distillation traffic the same
        way."""
        kd = getattr(plan, "kd_rounds", 0)
        if kd:
            tr.kd_bytes = float(sum(tr.bytes_by_round[:kd]))


def available_transports() -> List[str]:
    """Sorted names of every registered transport backend.

    Imports the bundled implementations first so the registry is
    populated (the same lazy import :func:`build_transport` does) —
    CLI validation and error messages use this list, so a newly
    registered backend shows up everywhere without edits.
    """
    # importing the implementations registers them; lazy to avoid the
    # transport_base <-> network import cycle
    from repro_torch.runtime import (network,  # noqa: F401
                                     socket_transport, super_network,
                                     vector_network)
    return sorted(TRANSPORTS)


def build_transport(name: str, n_peers: int, *,
                    profile: Optional[str] = None, seed: int = 0,
                    link_params: Optional[Dict[str, Any]] = None,
                    **kwargs: Any) -> Transport:
    """Build a registered transport backend by name.

    ``"sim"`` — the discrete-event simulator over modeled links;
    ``"vector_sim"`` — the same link model timed with batched numpy
    segment ops (the large-N engine, byte-exact and time-equal vs
    ``"sim"``); ``"super_sim"`` — the superpeer hybrid engine (closed
    forms for intra-cluster rounds, the vector engine for the rest;
    byte-exact always, time-equal on per-peer link profiles);
    ``"socket"`` — real asyncio tasks over loopback TCP (or, with an
    ``address_book=``/``rank=``, one rank of a multi-process world on
    fixed host:port endpoints).
    """
    names = available_transports()
    if name not in TRANSPORTS:
        raise ValueError(f"unknown transport {name!r}; "
                         f"registered: {names}")
    return TRANSPORTS[name].from_config(
        n_peers, profile=profile, seed=seed, link_params=link_params,
        **kwargs)
