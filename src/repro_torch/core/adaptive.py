"""Adaptive group sizing from measured round times (ROADMAP "Adaptive M").

MAR-FL's O(N log N) communication hinges on the group size M, but the
grid was factorized once up front (``plan_grid``) and never revisited —
even though the transport layer now *measures* exactly the signal
needed to tune it: per-iteration :class:`~repro_torch.runtime.transport_base.
Transcript` objects carry per-round completion times (``round_s``) and
per-peer finish times (``peer_finish_s``) for both the discrete-event
simulator and the real socket transport. The wireless-FL literature
(PAPERS.md: Zhou et al. "Towards Scalable Wireless Federated Learning";
Chen et al. "CFL") argues group/cluster structure must track
heterogeneous, time-varying conditions rather than stay static; this
module is that feedback loop:

* :class:`GroupSizeController` — a registry of controllers, each
  consuming one backend-agnostic transcript per FL iteration
  (``observe(t, transcript, plan)``) and proposing a new
  :class:`~repro_torch.core.moshpit.GridPlan` for the *same* peer count (or
  ``None`` to keep the grid). Built-ins:

  - ``static`` — never regroups; the fixed-M baseline as a controller,
    so ``adaptive_m="static"`` exercises the full hook path with zero
    behavioral effect.
  - ``tail_aware`` — shrinks M when the slowest peer's finish time
    dominates the iteration (a slow uplink serializes ``(M-1)`` sends
    per round, so smaller groups cut the tail's airtime and the number
    of peers blocked behind it), and grows M back toward the planner's
    traffic-optimal factorization when the tail clears (fewer rounds,
    fewer latency barriers). It never exceeds the initial plan: past
    the planner's choice, larger M only adds per-round sends.
  - ``schedule`` — scripted ``(iteration, dims)`` regroups for tests
    and ablations.

* The *regroup* the proposals trigger is membership-preserving: the
  federation swaps grid dims mid-run via the same elastic machinery
  permanent join/leave uses (pipeline rebuild + per-``WireStage``
  ``resize_state`` with ``old_n == new_n``), so peer state passes
  through bit-exact — ``Federation.regroup`` (sim) and the
  ``--adaptive-m`` path of ``launch/train.py`` (device backend, which
  needs ``exact_only`` grids: capacity == N).

Controllers read only the Transcript contract
(``runtime/transport_base.py``), so the same controller tunes M over
modeled links and over real loopback TCP.

A copy of the JAX package's ``repro/core/adaptive.py`` (numpy) with its imports
rewritten; tests hold it equal to the reference.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np

from repro_torch.core.moshpit import GridPlan, plan_grid

CONTROLLERS: Dict[str, Type["GroupSizeController"]] = {}


def register_controller(cls: Type["GroupSizeController"]
                        ) -> Type["GroupSizeController"]:
    CONTROLLERS[cls.name] = cls
    return cls


def build_controller(name: str, plan: GridPlan,
                     **params: Any) -> "GroupSizeController":
    """Build a registered group-size controller by name."""
    if name not in CONTROLLERS:
        raise ValueError(f"unknown group-size controller {name!r}; "
                         f"registered: {sorted(CONTROLLERS)}")
    return CONTROLLERS[name](plan, **params)


def candidate_grids(n_peers: int, m_min: int = 2, m_max: int = 8,
                    exact_only: bool = False,
                    max_waste: float = 2.0) -> List[GridPlan]:
    """The uniform-M grid ladder for ``n_peers``, ordered by group size.

    One plan per distinct ``dims`` for M in ``[m_min, m_max]``, each the
    shallowest uniform grid with capacity >= N. ``exact_only`` keeps
    only ``M^d == N`` factorizations (the device backend's constraint —
    ``mar_aggregate_device`` asserts capacity == N); otherwise plans
    whose virtual padding exceeds ``max_waste * n_peers`` capacity are
    dropped (mask machinery handles padding, but a mostly-virtual grid
    wastes schedule rounds). Falls back to ``plan_grid(n_peers)`` when
    nothing qualifies.
    """
    out: List[GridPlan] = []
    seen = set()
    for m in range(m_min, max(min(m_max, n_peers), m_min) + 1):
        p = plan_grid(n_peers, group_size=m)
        if exact_only and not p.is_exact:
            continue
        if not exact_only and p.capacity > max_waste * n_peers:
            continue
        if p.dims in seen:
            continue
        seen.add(p.dims)
        out.append(p)
    if not out:
        out = [plan_grid(n_peers)]
    return out


def carry_placement(old: GridPlan, new: GridPlan) -> GridPlan:
    """Carry the live plan's peer ordering onto a proposed grid.

    A dims proposal is built placement-blind, so applying it would
    scatter a clustered permutation until the placement policy's next
    observe — one iteration of re-mixed regions, which also costs the
    superpeer engine its closed-form (region-pure) intra-cluster tiers
    right when the fleet regroups. Slots don't transfer across dims,
    but the peer *order* does: peers are re-packed into the new grid
    in their old slot order, so contiguous clusters stay contiguous
    through the regroup. Identity placements pass through untouched
    (``with_placement`` normalizes the identity permutation away, so
    this cannot turn an unplaced plan into a placed one)."""
    if old.placement is None or new.placement is not None:
        return new
    n = old.n_peers
    order = np.argsort(old.slot_of(np.arange(n)), kind="stable")
    perm = np.empty(n, np.int64)
    perm[order] = np.arange(n)
    return new.with_placement(perm)


def validate_proposal(plan: GridPlan, n_peers: int,
                      exact_only: bool = False) -> GridPlan:
    """Reject proposals the runtime cannot execute: wrong peer count,
    capacity below N, or (device backend) padded grids."""
    if plan.n_peers != n_peers:
        raise ValueError(
            f"group-size controllers regroup, they do not resize: "
            f"proposed plan is for {plan.n_peers} peers, fleet has "
            f"{n_peers} (permanent join/leave goes through the "
            f"lifecycle/Federation.resize)")
    if plan.capacity < n_peers:
        raise ValueError(f"proposed grid {plan.dims} has capacity "
                         f"{plan.capacity} < {n_peers} peers")
    if exact_only and not plan.is_exact:
        raise ValueError(f"the device backend needs exact grids: "
                         f"{plan.dims} has capacity {plan.capacity} "
                         f"!= {n_peers} peers")
    return plan


def observe_regroups(t: int, transcript: Any, plan: GridPlan,
                     controller: Optional["GroupSizeController"] = None,
                     placement_policy: Any = None
                     ) -> List[Tuple[GridPlan, str, Tuple]]:
    """One iteration's same-N regroups, in the order the runtime applies
    them: the controller's proposal first (on a new grid the placement
    policy re-binds and re-emits its permutation for it), then the
    placement policy's target over the plan in force after that. Each
    entry is ``(new_plan, log, entry)``: ``("regroup", (t, old_dims,
    new_dims))`` or ``("placement", (t, peers_moved))``. The one policy
    behind ``Federation`` (sim backend) and ``launch/train.py`` (device
    backend)."""
    out: List[Tuple[GridPlan, str, Tuple]] = []
    if controller is not None:
        proposal = controller.observe(t, transcript, plan)
        if proposal is not None and proposal != plan:
            out.append((proposal, "regroup",
                        (t, tuple(plan.dims), tuple(proposal.dims))))
            plan = proposal
            if placement_policy is not None:
                placement_policy.rebind(plan)
    if placement_policy is not None:
        target = placement_policy.observe(t, transcript, plan)
        if target is not None and target != plan:
            peers = np.arange(plan.n_peers)
            moved = int(np.sum(plan.slot_of(peers) != target.slot_of(peers)))
            out.append((target, "placement", (t, moved)))
    return out


class GroupSizeController:
    """One M-tuning policy over measured transcripts.

    Contract: ``observe(t, transcript, plan)`` is called once per FL
    iteration with the iteration index, the backend-agnostic transcript
    of the traffic that just ran (controllers read only ``round_s`` /
    ``peer_finish_s`` / ``lost_senders`` — the shared
    :class:`~repro_torch.runtime.transport_base.Transcript` fields, so sim
    and socket transports feed the same policy), and the
    :class:`GridPlan` that produced it. It returns a new plan for the
    *same* peer count (the runtime regroups in place before the next
    iteration) or ``None`` to keep the grid. ``rebind(plan)``
    re-anchors the controller after an externally-driven change
    (elastic membership resize).
    """

    name: str = "?"

    def __init__(self, plan: GridPlan, exact_only: bool = False):
        self.plan = plan
        #: the device backend regroups only onto exact factorizations
        self.exact_only = exact_only

    def observe(self, t: int, transcript: Any,
                plan: GridPlan) -> Optional[GridPlan]:
        raise NotImplementedError

    def rebind(self, plan: GridPlan) -> None:
        """Re-anchor after a membership change (new N, fresh ladder)."""
        self.plan = plan


@register_controller
class StaticController(GroupSizeController):
    """Never regroups — the fixed-M baseline behind the same hook."""

    name = "static"

    def observe(self, t, transcript, plan):
        return None


@register_controller
class TailAwareController(GroupSizeController):
    """Shrink/grow M from the measured finish-time tail.

    Signal: per iteration, the *tail ratio* ``max(peer_finish_s) /
    median(peer_finish_s)`` over peers that moved traffic. A dominant
    tail (ratio above ``hi``, averaged over ``window`` iterations)
    means the slowest peer's uplink chain bounds the iteration —
    shrinking M cuts both its per-round sends (``M-1`` serialized over
    its uplink) and the group waiting on it. A flat distribution
    (ratio below ``lo``) means round barriers/latency dominate — grow
    M back toward the planner's choice (fewer rounds), but never past
    it: on a flat profile the controller therefore converges to (and
    stays at) the static ``plan_grid`` behavior. ``cooldown``
    iterations are skipped after each regroup so the new grid's
    transcripts, not the old grid's tail, drive the next decision.
    Churn couples in through the transcript itself: a demoted peer
    (lost sends) moves no traffic and drops out of the finish-time
    statistics, so a churn-thinned tail reads as flat and lets M grow
    back.
    """

    name = "tail_aware"

    def __init__(self, plan: GridPlan, exact_only: bool = False,
                 window: int = 4, hi: float = 1.6, lo: float = 1.15,
                 cooldown: int = 2, m_min: int = 2, m_max: int = 8):
        super().__init__(plan, exact_only=exact_only)
        if not window >= 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if not hi > lo:
            raise ValueError(f"need hi > lo, got hi={hi} lo={lo}")
        self.window = window
        self.hi = hi
        self.lo = lo
        self.cooldown = cooldown
        self.m_min = m_min
        self.m_max = m_max
        self._ratios: List[float] = []
        self._cool = 0
        self._build_ladder(plan)

    def _build_ladder(self, plan: GridPlan) -> None:
        self.candidates = candidate_grids(
            plan.n_peers, m_min=self.m_min, m_max=self.m_max,
            exact_only=self.exact_only)
        self._home = self._index(plan)
        self._ratios.clear()
        self._cool = 0

    def _index(self, plan: GridPlan) -> int:
        """Ladder position of ``plan`` (nearest by group size when the
        dims are not on the ladder, e.g. heterogeneous mesh grids)."""
        for i, c in enumerate(self.candidates):
            if c.dims == plan.dims:
                return i
        m = max(plan.dims)
        return int(np.argmin([abs(c.dims[0] - m) for c in self.candidates]))

    @staticmethod
    def tail_ratio(transcript: Any) -> Optional[float]:
        """max/median of positive per-peer finish times
        (``Transcript.tail_stats`` is the canonical computation); None
        when fewer than two peers moved traffic — no tail to measure."""
        f = np.asarray(transcript.peer_finish_s, float)
        if int((f > 0).sum()) < 2:
            return None
        med, mx = transcript.tail_stats()
        return mx / max(med, 1e-12)

    def observe(self, t, transcript, plan):
        if plan.n_peers != self.plan.n_peers:
            self.rebind(plan)
        self.plan = plan
        r = self.tail_ratio(transcript)
        if r is not None:
            self._ratios.append(r)
        if self._cool > 0:
            self._cool -= 1
            return None
        if len(self._ratios) < self.window:
            return None
        mean_ratio = float(np.mean(self._ratios[-self.window:]))
        self._ratios.clear()
        i = self._index(plan)
        if mean_ratio > self.hi and i > 0:
            j = i - 1                      # tail dominates: shrink M
        elif mean_ratio < self.lo and i < self._home:
            j = i + 1                      # tail cleared: grow toward home
        else:
            return None
        self._cool = self.cooldown
        return validate_proposal(
            carry_placement(plan, self.candidates[j]), plan.n_peers,
            exact_only=self.exact_only)

    def rebind(self, plan):
        super().rebind(plan)
        self._build_ladder(plan)


@register_controller
class ScheduleController(GroupSizeController):
    """Scripted regroups: ``schedule = ((iteration, dims), ...)``.

    After iteration ``t`` completes, the grid regroups to ``dims``
    (applied before iteration ``t + 1``). Deterministic by
    construction — the test/ablation controller.
    """

    name = "schedule"

    def __init__(self, plan: GridPlan, exact_only: bool = False,
                 schedule: Sequence[Tuple[int, Sequence[int]]] = ()):
        super().__init__(plan, exact_only=exact_only)
        self.schedule: Dict[int, Tuple[int, ...]] = {
            int(t): tuple(int(d) for d in dims) for t, dims in schedule}

    def observe(self, t, transcript, plan):
        dims = self.schedule.get(t)
        if dims is None or dims == tuple(plan.dims):
            return None
        return validate_proposal(
            carry_placement(plan, GridPlan(plan.n_peers, dims)),
            plan.n_peers, exact_only=self.exact_only)
