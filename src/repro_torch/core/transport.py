"""Message plans: who sends what to whom, per round, per technique.

``topology.py`` answers "how many bytes should one FL iteration cost" in
closed form; this module answers "which concrete messages make up that
iteration". A :class:`MessagePlan` is the bridge between the aggregation
strategies (``aggregation.py``) and the discrete-event network simulator
(``runtime/network.py``): every registered technique can be *unrolled*
into per-round ``(src, dst, nbytes)`` messages over the
:class:`~repro.core.moshpit.GridPlan` schedule, the simulator times and
possibly drops them, and the resulting transcript feeds the
``CommLedger`` — measured traffic replacing the analytic formulas
(which remain as cross-checked oracles; see ``tests/test_network.py``).

Conventions, chosen so the no-loss transcript reproduces ``topology.py``
exactly at full participation:

* Node ids ``0..n_peers-1`` are real peers. Ids ``>= n_peers`` are
  *infrastructure* (the FedAvg parameter server, the hierarchical
  rendezvous) — modeled by the simulator as infinitely provisioned
  (unbounded bandwidth, zero latency, lossless), so client links stay
  the bottleneck.
* Only **active** peers (``mask > 0``) send. Masked peers are
  receiver-only — the paper §3.1 semantics where a dropped peer
  contributes to no group mean but rejoins with the averaged model;
  the mean delivery rides the next iteration's exchange and is not
  billed separately, matching the analytic model's accounting.
* Self-messages (a hierarchical group leader "uploading" to itself)
  are loopback: bytes are counted (keeping parity with the analytic
  ``2 (n + #groups)`` convention) but transfer time is zero.

This is the list-plan half of the JAX package's ``repro/core/transport.py``
(numpy, copied with its imports rewritten): per-round tuples of
:class:`Message` objects, and the MKD rounds that ride in front of them.
The array and symbolic plans of the large-N engines are not ported yet
(ROADMAP.md, Queue 1 item 13).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.moshpit import GridPlan


@dataclasses.dataclass(frozen=True)
class Message:
    """One data-plane transfer of ``nbytes`` from ``src`` to ``dst``."""

    src: int
    dst: int
    nbytes: float


@dataclasses.dataclass(frozen=True)
class MessagePlan:
    """One FL iteration's traffic, unrolled into rounds of messages.

    Rounds are sequential dependency steps: a round-``r+1`` send leaves
    as soon as *its sender* has finished round ``r`` (received all its
    round-``r`` messages and drained its uplink) — there is no global
    barrier, so group/ring/hierarchy timing emerges from the message
    structure alone.
    """

    technique: str
    n_peers: int                                 # real peers
    n_nodes: int                                 # peers + infrastructure
    rounds: Tuple[Tuple[Message, ...], ...]
    # MKD prefix: the first ``kd_rounds`` entries of ``rounds`` are
    # distillation traffic (teacher pulls + logit exchanges); transports
    # split their bytes back out into ``Transcript.kd_bytes``
    kd_rounds: int = 0

    @property
    def n_messages(self) -> int:
        return sum(len(r) for r in self.rounds)

    @property
    def total_bytes(self) -> float:
        return float(sum(m.nbytes for r in self.rounds for m in r))


def _active_ids(mask: Optional[np.ndarray], n: int) -> np.ndarray:
    if mask is None:
        return np.arange(n)
    mask = np.asarray(mask)
    return np.flatnonzero(mask[:n] > 0)


def _group_members(group: np.ndarray, active: np.ndarray,
                   n_real: int) -> List[int]:
    """Active real peers of one grid group (virtual padding slots and
    masked peers drop out)."""
    act = set(int(a) for a in active)
    return [int(p) for p in group if int(p) < n_real and int(p) in act]


# ---------------------------------------------------------------------------
# per-technique planners
# ---------------------------------------------------------------------------

def mar_plan(plan: GridPlan, mask: Optional[np.ndarray],
             model_bytes: float, num_rounds: Optional[int] = None,
             mode: str = "naive") -> MessagePlan:
    """MAR: ``G`` rounds of within-group exchange over the grid schedule.

    ``naive`` — every active member sends its full state to every other
    active member of its round-``g`` group (the paper's accounting).
    ``butterfly`` — reduce-scatter + all-gather on the active members'
    ring: ``2 (k-1)`` chunks of ``B/k`` per member (what Moshpit-SGD
    itself implements in-group); chunk hops are billed inside one MAR
    round, so uplink serialization models their cost while the round
    count stays the paper's ``G``.
    """
    rounds = plan.depth if num_rounds is None else num_rounds
    active = _active_ids(mask, plan.n_peers)
    out: List[Tuple[Message, ...]] = []
    for g in range(rounds):
        msgs: List[Message] = []
        for group in plan.groups_for_round(g % plan.depth):
            members = _group_members(group, active, plan.n_peers)
            k = len(members)
            if k < 2:
                continue
            if mode == "butterfly":
                chunk = model_bytes / k
                for hop in range(2 * (k - 1)):
                    for i, s in enumerate(members):
                        msgs.append(Message(s, members[(i + 1) % k], chunk))
            else:
                for s in members:
                    for d in members:
                        if d != s:
                            msgs.append(Message(s, d, model_bytes))
        out.append(tuple(msgs))
    return MessagePlan("mar", plan.n_peers, plan.n_peers, tuple(out))


def fedavg_plan(plan: GridPlan, mask: Optional[np.ndarray],
                model_bytes: float) -> MessagePlan:
    """Client-server FedAvg: uploads to the rendezvous, then downloads."""
    n = plan.n_peers
    server = n
    active = _active_ids(mask, n)
    ups = tuple(Message(int(p), server, model_bytes) for p in active)
    downs = tuple(Message(server, int(p), model_bytes) for p in active)
    return MessagePlan("fedavg", n, n + 1, (ups, downs))


def ar_plan(plan: GridPlan, mask: Optional[np.ndarray],
            model_bytes: float) -> MessagePlan:
    """All-to-all AR-FL: one round, every active peer to every other."""
    n = plan.n_peers
    active = _active_ids(mask, n)
    msgs = tuple(Message(int(s), int(d), model_bytes)
                 for s in active for d in active if s != d)
    return MessagePlan("ar", n, n, (msgs,))


def rdfl_plan(plan: GridPlan, mask: Optional[np.ndarray],
              model_bytes: float) -> MessagePlan:
    """RDFL ring circulation: ``k-1`` sequential hops over the active
    ring; each hop every active peer forwards a full model to its
    successor, so a hop cannot leave before the previous one arrived."""
    n = plan.n_peers
    active = _active_ids(mask, n)
    k = len(active)
    if k < 2:
        return MessagePlan("rdfl", n, n, ())
    rounds = tuple(
        tuple(Message(int(active[i]), int(active[(i + 1) % k]), model_bytes)
              for i in range(k))
        for _ in range(k - 1))
    return MessagePlan("rdfl", n, n, rounds)


def gossip_plan(plan: GridPlan, mask: Optional[np.ndarray],
                model_bytes: float,
                num_rounds: Optional[int] = None) -> MessagePlan:
    """Push-sum ring gossip with doubling shifts: in round ``r`` active
    peer ``i`` pushes to peer ``(i + 2^r) mod N`` on the fixed ring over
    *all* N slots (matching ``gossip_aggregate_sim``'s rolls — the ring
    covers peers whether or not they participate)."""
    n = plan.n_peers
    if num_rounds is None:
        num_rounds = max(1, int(math.ceil(math.log2(max(n, 2)))))
    active = _active_ids(mask, n)
    rounds = tuple(
        tuple(Message(int(p), int((p + (1 << r)) % n), model_bytes)
              for p in active)
        for r in range(num_rounds))
    return MessagePlan("gossip", n, n, rounds)


def hierarchical_plan(plan: GridPlan, mask: Optional[np.ndarray],
                      model_bytes: float) -> MessagePlan:
    """Two-tier FedAvg over the leaf MAR groups: members -> leader,
    leaders -> rendezvous, rendezvous -> leaders, leader -> members.
    The leader is each group's first active member; its own up/down
    "transfers" are loopback messages (counted, instant) so measured
    bytes reproduce the analytic ``2 (n + #groups)`` convention."""
    n = plan.n_peers
    rendezvous = n
    active = _active_ids(mask, n)
    groups = [
        _group_members(g, active, n)
        for g in plan.groups_for_round(plan.depth - 1)
    ]
    groups = [g for g in groups if g]
    leaders = [g[0] for g in groups]
    up = tuple(Message(p, lead, model_bytes)
               for g, lead in zip(groups, leaders) for p in g)
    mid_up = tuple(Message(lead, rendezvous, model_bytes)
                   for lead in leaders)
    mid_down = tuple(Message(rendezvous, lead, model_bytes)
                     for lead in leaders)
    down = tuple(Message(lead, p, model_bytes)
                 for g, lead in zip(groups, leaders) for p in g)
    return MessagePlan("hierarchical", n, n + 1,
                       (up, mid_up, mid_down, down))


# ---------------------------------------------------------------------------
# MKD traffic (Alg. 2/3 — rides the same transport as aggregation)
# ---------------------------------------------------------------------------

def mkd_message_rounds(plan: GridPlan, mask: Optional[np.ndarray],
                       model_bytes: float, kd_logit_bytes: float,
                       num_rounds: Optional[int] = None
                       ) -> Tuple[Tuple[Message, ...], ...]:
    """Unroll one iteration's MKD rounds into messages.

    MKD round ``g`` reuses the round-``g`` MAR groups (``core/mkd.py``):

    * **teacher pulls** — every active member sends its theta (half the
      ``(theta, m)`` state, Alg. 3's candidate-model transfer) to every
      other active member of its group: ``sum_g k_g (k_g - 1)`` sends
      of ``model_bytes // 2`` — exactly the mask-aware
      ``topology.mar_bytes`` accounting at half size;
    * **logit exchange** — each active student receives one mixed
      teacher-logit message (``kd_logit_bytes``) from its first active
      group mate, or as a loopback when its group has no other active
      member (billed, instant — the degenerate-group convention), so
      each round bills exactly ``n_active`` logit messages, matching
      the analytic ``n * G * kd_logit_bytes`` add-on.
    """
    rounds = plan.depth if num_rounds is None else num_rounds
    half = model_bytes // 2
    active = _active_ids(mask, plan.n_peers)
    out: List[Tuple[Message, ...]] = []
    for g in range(rounds):
        msgs: List[Message] = []
        for group in plan.groups_for_round(g % plan.depth):
            members = _group_members(group, active, plan.n_peers)
            for t in members:
                for s in members:
                    if s != t:
                        msgs.append(Message(t, s, half))
            for s in members:
                mates = [t for t in members if t != s]
                msgs.append(Message(mates[0] if mates else s, s,
                                    kd_logit_bytes))
        out.append(tuple(msgs))
    return tuple(out)


def with_mkd_traffic(mplan: MessagePlan, plan: GridPlan,
                     mask: Optional[np.ndarray], model_bytes: float,
                     kd_logit_bytes: float,
                     num_rounds: Optional[int] = None) -> MessagePlan:
    """Prepend an iteration's MKD rounds to an aggregation plan (MKD
    precedes aggregation within the iteration). KD sizes are the *raw*
    model bytes — distillation doesn't ride the compressed delta wire
    format — while the aggregation rounds keep their post-stage sizes.
    """
    kd = mkd_message_rounds(plan, mask, model_bytes, kd_logit_bytes,
                            num_rounds=num_rounds)
    return dataclasses.replace(mplan, rounds=kd + mplan.rounds,
                               kd_rounds=len(kd))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

_PLANNERS = {
    "mar": mar_plan,
    "fedavg": fedavg_plan,
    "ar": ar_plan,
    "rdfl": rdfl_plan,
    "gossip": gossip_plan,
    "hierarchical": hierarchical_plan,
}


def build_message_plan(technique: str, plan: GridPlan,
                       mask: Optional[np.ndarray], model_bytes: float,
                       num_rounds: Optional[int] = None,
                       mode: str = "naive") -> MessagePlan:
    """Unroll one FL iteration of ``technique`` into timed-able messages.

    ``mask`` is the aggregation mask A_t over real peers (None = full
    participation); ``model_bytes`` is the *wire* size of one state
    transfer (post compression-stage transforms).
    """
    if technique not in _PLANNERS:
        raise ValueError(
            f"no message planner for technique {technique!r}; "
            f"known: {sorted(_PLANNERS)}")
    if technique == "mar":
        return mar_plan(plan, mask, model_bytes, num_rounds, mode)
    if technique == "gossip":
        return gossip_plan(plan, mask, model_bytes, num_rounds)
    return _PLANNERS[technique](plan, mask, model_bytes)
