"""Message plans: who sends what to whom, per round, per technique.

``topology.py`` answers "how many bytes should one FL iteration cost" in
closed form; this module answers "which concrete messages make up that
iteration". A :class:`MessagePlan` is the bridge between the aggregation
strategies (``aggregation.py``) and the discrete-event network simulator
(``runtime/network.py``): every registered technique can be *unrolled*
into per-round ``(src, dst, nbytes)`` messages over the
:class:`~repro_torch.core.moshpit.GridPlan` schedule, the simulator times and
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

Two plan representations share these conventions:

* :class:`MessagePlan` — per-round tuples of :class:`Message` objects,
  the original per-message form every transport accepts.
* :class:`ArrayMessagePlan` — the same iteration as flat ``src`` /
  ``dst`` / ``nbytes`` numpy arrays with CSR-style ``round_ptr``
  boundaries, built *directly* by vectorized planners
  (:func:`build_array_plan`) without ever materializing Python message
  objects. Conversion between the two is lossless and order-preserving
  (``from_plan`` / ``to_plan``), and the vectorized builders emit
  messages in exactly the per-round order of the list planners — the
  invariant that makes the batched simulator
  (``runtime/vector_network.py``) byte-exact *and* time-equal against
  the heap-ordered :class:`~repro_torch.runtime.network.NetworkSim`.

A copy of the JAX package's ``repro/core/transport.py`` (numpy) with its imports
rewritten; tests hold it equal to the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

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
    # distillation traffic (teacher pulls + logit exchanges) prepended
    # by :func:`with_mkd_traffic`; transports split their bytes back
    # out into ``Transcript.kd_bytes`` for per-source accounting
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


# ---------------------------------------------------------------------------
# array-form plans (the large-N hot path)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArrayMessagePlan:
    """One FL iteration's traffic as flat per-message arrays.

    ``src`` / ``dst`` / ``nbytes`` concatenate every round's messages
    in round order; ``round_ptr`` (length ``n_rounds + 1``) holds the
    CSR boundaries, so round ``r`` is the slice
    ``round_ptr[r]:round_ptr[r+1]``. Message order *within* each round
    is exactly the list planners' emission order — per-sender uplink
    serialization and seeded loss draws depend on it, so preserving it
    is what keeps the vectorized simulator time-equal and
    drop-identical to the heap engine.
    """

    technique: str
    n_peers: int
    n_nodes: int
    src: np.ndarray                     # int64 [n_messages]
    dst: np.ndarray                     # int64 [n_messages]
    nbytes: np.ndarray                  # float64 [n_messages]
    round_ptr: np.ndarray               # int64 [n_rounds + 1]
    kd_rounds: int = 0

    @property
    def n_rounds(self) -> int:
        return len(self.round_ptr) - 1

    @property
    def n_messages(self) -> int:
        return int(self.src.size)

    @property
    def total_bytes(self) -> float:
        return float(self.nbytes.sum())

    def round_arrays(self, r: int) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
        lo, hi = int(self.round_ptr[r]), int(self.round_ptr[r + 1])
        return self.src[lo:hi], self.dst[lo:hi], self.nbytes[lo:hi]

    # -- lossless conversion -------------------------------------------
    @classmethod
    def from_plan(cls, mplan: MessagePlan) -> "ArrayMessagePlan":
        counts = [len(r) for r in mplan.rounds]
        ptr = np.zeros(len(counts) + 1, np.int64)
        np.cumsum(counts, out=ptr[1:])
        n = int(ptr[-1])
        src = np.empty(n, np.int64)
        dst = np.empty(n, np.int64)
        nb = np.empty(n, np.float64)
        i = 0
        for r in mplan.rounds:
            for m in r:
                src[i], dst[i], nb[i] = m.src, m.dst, m.nbytes
                i += 1
        return cls(mplan.technique, mplan.n_peers, mplan.n_nodes,
                   src, dst, nb, ptr, kd_rounds=mplan.kd_rounds)

    def to_plan(self) -> MessagePlan:
        rounds = tuple(
            tuple(Message(int(s), int(d), float(b))
                  for s, d, b in zip(*self.round_arrays(r)))
            for r in range(self.n_rounds))
        return MessagePlan(self.technique, self.n_peers, self.n_nodes,
                           rounds, kd_rounds=self.kd_rounds)


def _concat_rounds(technique: str, n_peers: int, n_nodes: int,
                   rounds: List[Tuple[np.ndarray, np.ndarray,
                                      np.ndarray]],
                   kd_rounds: int = 0) -> ArrayMessagePlan:
    counts = [r[0].size for r in rounds]
    ptr = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    if rounds:
        src = np.concatenate([r[0] for r in rounds])
        dst = np.concatenate([r[1] for r in rounds])
        nb = np.concatenate([r[2] for r in rounds])
    else:
        src = np.empty(0, np.int64)
        dst = np.empty(0, np.int64)
        nb = np.empty(0, np.float64)
    return ArrayMessagePlan(technique, n_peers, n_nodes,
                            src.astype(np.int64), dst.astype(np.int64),
                            nb.astype(np.float64), ptr,
                            kd_rounds=kd_rounds)


def _group_rows(plan: GridPlan, rnd: int) -> np.ndarray:
    """[n_groups, m] peer ids of round ``rnd``'s groups, rows in
    ``groups_for_round`` order, members in within-group order."""
    peers = np.arange(plan.capacity)
    keys = plan.group_key(peers, rnd)
    order = np.argsort(keys, kind="stable")
    return order.reshape(-1, plan.dims[rnd])


def _valid_slots(plan: GridPlan, active: np.ndarray) -> np.ndarray:
    """Boolean over grid slots: real peer and active under the mask."""
    valid = np.zeros(plan.capacity, bool)
    valid[active] = True
    return valid


def _mar_round_arrays(rows: np.ndarray, vrows: np.ndarray,
                      model_bytes: float
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All active intra-group pairs of one MAR round, flattened
    group-major then sender-major — the list planner's order."""
    g, m = rows.shape
    pair_ok = vrows[:, :, None] & vrows[:, None, :]
    pair_ok &= ~np.eye(m, dtype=bool)[None]
    src = np.broadcast_to(rows[:, :, None], (g, m, m))[pair_ok]
    dst = np.broadcast_to(rows[:, None, :], (g, m, m))[pair_ok]
    return (src, dst, np.full(src.size, float(model_bytes)))


def mar_plan_arrays(plan: GridPlan, mask: Optional[np.ndarray],
                    model_bytes: float,
                    num_rounds: Optional[int] = None) -> ArrayMessagePlan:
    """Vectorized :func:`mar_plan` (``naive`` mode) — identical message
    order without materializing ``Message`` objects."""
    rounds = plan.depth if num_rounds is None else num_rounds
    active = _active_ids(mask, plan.n_peers)
    valid = _valid_slots(plan, active)
    out = []
    for g in range(rounds):
        rows = _group_rows(plan, g % plan.depth)
        out.append(_mar_round_arrays(rows, valid[rows], model_bytes))
    return _concat_rounds("mar", plan.n_peers, plan.n_peers, out)


def fedavg_plan_arrays(plan: GridPlan, mask: Optional[np.ndarray],
                       model_bytes: float) -> ArrayMessagePlan:
    n = plan.n_peers
    active = _active_ids(mask, n).astype(np.int64)
    server = np.full(active.size, n, np.int64)
    nb = np.full(active.size, float(model_bytes))
    return _concat_rounds("fedavg", n, n + 1,
                          [(active, server, nb), (server, active, nb)])


def ar_plan_arrays(plan: GridPlan, mask: Optional[np.ndarray],
                   model_bytes: float) -> ArrayMessagePlan:
    n = plan.n_peers
    active = _active_ids(mask, n).astype(np.int64)
    k = active.size
    off_diag = ~np.eye(k, dtype=bool)
    src = np.broadcast_to(active[:, None], (k, k))[off_diag]
    dst = np.broadcast_to(active[None, :], (k, k))[off_diag]
    return _concat_rounds(
        "ar", n, n, [(src, dst, np.full(src.size, float(model_bytes)))])


def rdfl_plan_arrays(plan: GridPlan, mask: Optional[np.ndarray],
                     model_bytes: float) -> ArrayMessagePlan:
    n = plan.n_peers
    active = _active_ids(mask, n).astype(np.int64)
    k = active.size
    if k < 2:
        return _concat_rounds("rdfl", n, n, [])
    dst = np.roll(active, -1)
    nb = np.full(k, float(model_bytes))
    return _concat_rounds("rdfl", n, n,
                          [(active, dst, nb)] * (k - 1))


def gossip_plan_arrays(plan: GridPlan, mask: Optional[np.ndarray],
                       model_bytes: float,
                       num_rounds: Optional[int] = None
                       ) -> ArrayMessagePlan:
    n = plan.n_peers
    if num_rounds is None:
        num_rounds = max(1, int(math.ceil(math.log2(max(n, 2)))))
    active = _active_ids(mask, n).astype(np.int64)
    nb = np.full(active.size, float(model_bytes))
    out = [(active, (active + (1 << r)) % n, nb)
           for r in range(num_rounds)]
    return _concat_rounds("gossip", n, n, out)


def _leaf_groups(plan: GridPlan, active: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rows, vrows, leaders) of the last-round groups: member matrix,
    validity, and each group's first active member (leaders only
    meaningful where a group has any active member)."""
    rows = _group_rows(plan, plan.depth - 1)
    vrows = _valid_slots(plan, active)[rows]
    first_pos = np.argmax(vrows, axis=1)
    leaders = rows[np.arange(rows.shape[0]), first_pos]
    return rows, vrows, leaders


def hierarchical_plan_arrays(plan: GridPlan, mask: Optional[np.ndarray],
                             model_bytes: float) -> ArrayMessagePlan:
    n = plan.n_peers
    rendezvous = n
    active = _active_ids(mask, n)
    rows, vrows, leaders = _leaf_groups(plan, active)
    nonempty = vrows.any(axis=1)
    # member-matrix flattening is group-major then member-major — the
    # list planner's nested-loop order; empty groups drop out of the
    # boolean mask naturally
    members = rows[vrows]
    member_lead = np.broadcast_to(leaders[:, None], rows.shape)[vrows]
    glead = leaders[nonempty]
    nb_m = np.full(members.size, float(model_bytes))
    nb_g = np.full(glead.size, float(model_bytes))
    rv = np.full(glead.size, rendezvous, np.int64)
    return _concat_rounds(
        "hierarchical", n, n + 1,
        [(members, member_lead, nb_m), (glead, rv, nb_g),
         (rv, glead, nb_g), (member_lead, members, nb_m)])


def mkd_round_arrays(plan: GridPlan, mask: Optional[np.ndarray],
                     model_bytes: float, kd_logit_bytes: float,
                     num_rounds: Optional[int] = None
                     ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Vectorized :func:`mkd_message_rounds`: per group, the teacher
    pulls (all active pairs at half state) then the logit messages
    (first active mate -> student, loopback for singleton groups),
    blocks interleaved per group exactly like the list builder."""
    rounds = plan.depth if num_rounds is None else num_rounds
    half = model_bytes // 2
    active = _active_ids(mask, plan.n_peers)
    valid = _valid_slots(plan, active)
    out = []
    for g in range(rounds):
        rows = _group_rows(plan, g % plan.depth)
        vrows = valid[rows]
        ng, m = rows.shape
        p_src, p_dst, _ = _mar_round_arrays(rows, vrows, half)
        k = vrows.sum(axis=1)                      # active per group
        # logit messages: student s <- its group's first active member
        # (second if s *is* the first; itself when alone)
        first_pos = np.argmax(vrows, axis=1)
        first = rows[np.arange(ng), first_pos]
        v2 = vrows.copy()
        v2[np.arange(ng), first_pos] = False
        second_pos = np.argmax(v2, axis=1)
        second = rows[np.arange(ng), second_pos]
        students = rows[vrows]
        gid_l = np.broadcast_to(np.arange(ng)[:, None], rows.shape)[vrows]
        mate = np.where(students == first[gid_l], second[gid_l],
                        first[gid_l])
        mate = np.where(k[gid_l] < 2, students, mate)
        # interleave per group: [pulls_g, logits_g] blocks in group order
        p_cnt = k * (k - 1)
        tot = p_cnt + k
        goff = np.zeros(ng + 1, np.int64)
        np.cumsum(tot, out=goff[1:])
        gid_p = np.broadcast_to(
            np.arange(ng)[:, None, None], (ng, m, m))[
                vrows[:, :, None] & vrows[:, None, :]
                & ~np.eye(m, dtype=bool)[None]]
        poff = np.zeros(ng + 1, np.int64)
        np.cumsum(p_cnt, out=poff[1:])
        idx_p = goff[gid_p] + (np.arange(p_src.size) - poff[gid_p])
        loff = np.zeros(ng + 1, np.int64)
        np.cumsum(k, out=loff[1:])
        idx_l = goff[gid_l] + p_cnt[gid_l] + \
            (np.arange(students.size) - loff[gid_l])
        n_msg = int(tot.sum())
        src = np.empty(n_msg, np.int64)
        dst = np.empty(n_msg, np.int64)
        nb = np.empty(n_msg, np.float64)
        src[idx_p], dst[idx_p], nb[idx_p] = p_src, p_dst, float(half)
        src[idx_l], dst[idx_l], nb[idx_l] = \
            mate, students, float(kd_logit_bytes)
        out.append((src, dst, nb))
    return out


def with_mkd_traffic_arrays(aplan: ArrayMessagePlan, plan: GridPlan,
                            mask: Optional[np.ndarray],
                            model_bytes: float, kd_logit_bytes: float,
                            num_rounds: Optional[int] = None
                            ) -> ArrayMessagePlan:
    """Array-form :func:`with_mkd_traffic`: prepend the MKD rounds."""
    kd = mkd_round_arrays(plan, mask, model_bytes, kd_logit_bytes,
                          num_rounds=num_rounds)
    agg = [aplan.round_arrays(r) for r in range(aplan.n_rounds)]
    return _concat_rounds(aplan.technique, aplan.n_peers, aplan.n_nodes,
                          kd + agg, kd_rounds=len(kd))


_ARRAY_PLANNERS = {
    "mar": mar_plan_arrays,
    "fedavg": fedavg_plan_arrays,
    "ar": ar_plan_arrays,
    "rdfl": rdfl_plan_arrays,
    "gossip": gossip_plan_arrays,
    "hierarchical": hierarchical_plan_arrays,
}


def build_array_plan(technique: str, plan: GridPlan,
                     mask: Optional[np.ndarray], model_bytes: float,
                     num_rounds: Optional[int] = None,
                     mode: str = "naive") -> ArrayMessagePlan:
    """Array-native :func:`build_message_plan` — same messages, same
    order, no per-message Python objects. ``mar`` ``butterfly`` mode
    falls back to converting the list plan (its variable-length chunk
    hops aren't on the large-N hot path)."""
    if technique not in _ARRAY_PLANNERS:
        raise ValueError(
            f"no array message planner for technique {technique!r}; "
            f"known: {sorted(_ARRAY_PLANNERS)}")
    if technique == "mar":
        if mode != "naive":
            return ArrayMessagePlan.from_plan(
                mar_plan(plan, mask, model_bytes, num_rounds, mode))
        return mar_plan_arrays(plan, mask, model_bytes, num_rounds)
    if technique == "gossip":
        return gossip_plan_arrays(plan, mask, model_bytes, num_rounds)
    return _ARRAY_PLANNERS[technique](plan, mask, model_bytes)


# ---------------------------------------------------------------------------
# symbolic superpeer plans (the N=10^6 tier)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class SuperMessagePlan:
    """One FL iteration's traffic as a *recipe*, not messages.

    Where :class:`ArrayMessagePlan` materializes every ``(src, dst,
    nbytes)`` tuple, this plan stores only what generated them — the
    technique, the grid (with placement), the active mask and the byte
    sizes — O(N) state independent of message count. The superpeer
    engine (``runtime/super_network.py``) walks the same per-technique
    round structure the array planners would emit, timing structured
    rounds with the closed-form recurrences of
    ``runtime/vector_network.py`` and materializing only the rounds
    that need the full vector path (pairwise WAN terms, loss). Because
    the recipe *determines* the array plan, :meth:`to_array_plan`
    rebuilds the exact messages on demand — the engine's fallback, and
    the parity tests' oracle.

    ``use_kd`` prepends the MKD prefix rounds at ``raw_model_bytes``
    (distillation rides uncompressed state, as
    ``AggregationPipeline.message_plan`` bills it) with
    ``kd_logit_bytes`` logits.
    """

    technique: str
    plan: GridPlan
    model_bytes: float                   # wire bytes per agg message
    mask: Optional[np.ndarray] = None
    num_rounds: Optional[int] = None
    mode: str = "naive"
    use_kd: bool = False
    raw_model_bytes: float = 0.0
    kd_logit_bytes: float = 0.0

    @property
    def n_peers(self) -> int:
        return self.plan.n_peers

    @property
    def n_nodes(self) -> int:
        return self.plan.n_peers + (
            1 if self.technique in ("fedavg", "hierarchical") else 0)

    @property
    def kd_rounds(self) -> int:
        if not self.use_kd:
            return 0
        return (self.plan.depth if self.num_rounds is None
                else self.num_rounds)

    def n_messages_estimate(self) -> int:
        """Upper-ish bound on materialized message count — the
        engine's per-link-tracking budget check."""
        n = self.plan.n_peers
        k = _active_ids(self.mask, n).size
        depth = self.plan.depth
        rounds = depth if self.num_rounds is None else self.num_rounds
        m = max(self.plan.dims)
        est = {
            "mar": rounds * k * (m - 1),
            "gossip": rounds * k,
            "fedavg": 2 * k,
            "hierarchical": 2 * k + 2 * (k // max(
                self.plan.dims[-1], 1) + 1),
            "ar": k * (k - 1),
            "rdfl": k * (k - 1),
        }.get(self.technique, k * rounds)
        if self.use_kd:
            est += self.kd_rounds * k * m
        return int(est)

    def to_array_plan(self) -> ArrayMessagePlan:
        """Materialize the exact messages this recipe stands for."""
        aplan = build_array_plan(self.technique, self.plan, self.mask,
                                 self.model_bytes,
                                 num_rounds=self.num_rounds,
                                 mode=self.mode)
        if self.use_kd:
            aplan = with_mkd_traffic_arrays(
                aplan, self.plan, self.mask, self.raw_model_bytes,
                self.kd_logit_bytes, num_rounds=self.num_rounds)
        return aplan


def build_super_plan(technique: str, plan: GridPlan,
                     mask: Optional[np.ndarray], model_bytes: float,
                     num_rounds: Optional[int] = None,
                     mode: str = "naive",
                     use_kd: bool = False,
                     raw_model_bytes: float = 0.0,
                     kd_logit_bytes: float = 0.0) -> SuperMessagePlan:
    """Symbolic counterpart of :func:`build_array_plan` — validates the
    technique and freezes the recipe; no messages are materialized."""
    if technique not in _ARRAY_PLANNERS:
        raise ValueError(
            f"no superpeer plan recipe for technique {technique!r}; "
            f"known: {sorted(_ARRAY_PLANNERS)}")
    if mask is not None:
        mask = np.asarray(mask).copy()
        mask.setflags(write=False)
    return SuperMessagePlan(technique, plan, float(model_bytes),
                            mask=mask, num_rounds=num_rounds, mode=mode,
                            use_kd=use_kd,
                            raw_model_bytes=float(raw_model_bytes),
                            kd_logit_bytes=float(kd_logit_bytes))
