"""Aggregation: the Aggregator registry, the CommLedger and the pipeline.

Port of the JAX package's ``repro/core/aggregation.py``, without wire
stages so far:

* :class:`Aggregator` — *what* consensus is computed. A registry maps
  technique names (``mar``, ``fedavg``, ``ar``, ``rdfl``, ``gossip``,
  ``hierarchical``) to callables ``(state, mask) -> state`` over
  peer-stacked trees of tensors (sim backend, ``mar_allreduce.py``).
* :class:`CommLedger` — *how many bytes (and simulated seconds)* moved.
  Every aggregator unrolls itself into a per-round message plan
  (``core/transport.py``); the network simulator
  (``runtime/network.py``) times it and the transcript feeds the ledger
  (:meth:`AggregationPipeline.record_transcript`). The closed forms in
  ``topology.py`` stay as cross-checked oracles.
* :class:`AggregationPipeline` — the aggregator the federation calls.
  The reference wraps it in wire stages (int8 error feedback, DP,
  staleness-1 async); those wait for ROADMAP.md Queue 1 item 7, and
  :func:`build_pipeline` raises on any stage flag.

Canonical aggregation state is a dict ``{"p": params, "m": momentum}``
with peers on the leading axis of every leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.core import topology
from repro_torch.core.moshpit import GridPlan
from repro_torch.tree import Tree

# ---------------------------------------------------------------------------
# the shared masked-mean core
# ---------------------------------------------------------------------------

def finalize_masked_mean(num: torch.Tensor, den: torch.Tensor,
                         own: torch.Tensor,
                         floor: float = 1.0) -> torch.Tensor:
    """Shared epilogue of every masked group mean in the system.

    ``num`` — masked sum (f32), ``den`` — masked contributor count (or
    push-sum weight), ``own`` — the value a peer keeps when its whole
    group dropped (churn semantics, paper §3.1). Broadcasts, so ``num``/
    ``den`` may carry keepdims group axes against a full-shape ``own``.
    ``floor`` guards the division — 1.0 for integer counts, small eps
    for fractional push-sum weights.
    """
    mean = num / torch.clamp(den, min=floor)
    empty = (den == 0.0).float()
    return mean * (1.0 - empty) + own.float() * empty


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CommLedger:
    """Per-source communication accounting: bytes by source plus the
    simulated seconds of every transport transcript."""

    total_bytes: float = 0.0
    total_seconds: float = 0.0
    by_source: Dict[str, float] = dataclasses.field(default_factory=dict)

    def record(self, source: str, nbytes: float) -> None:
        self.total_bytes += nbytes
        self.by_source[source] = self.by_source.get(source, 0.0) + nbytes

    def record_time(self, seconds: float) -> None:
        self.total_seconds += seconds

    def reset(self) -> None:
        self.total_bytes = 0.0
        self.total_seconds = 0.0
        self.by_source.clear()


# ---------------------------------------------------------------------------
# strategy layer: aggregators + registry
# ---------------------------------------------------------------------------

AGGREGATORS: Dict[str, Type["Aggregator"]] = {}


def register_aggregator(cls: Type["Aggregator"]) -> Type["Aggregator"]:
    AGGREGATORS[cls.name] = cls
    return cls


def make_aggregator(name: str, plan: GridPlan, **kwargs: Any) -> "Aggregator":
    if name not in AGGREGATORS:
        raise ValueError(
            f"unknown aggregation technique {name!r}; "
            f"registered: {sorted(AGGREGATORS)}")
    return AGGREGATORS[name](plan, **kwargs)


class Aggregator:
    """A consensus strategy: ``(state, mask) -> state`` plus its
    analytic byte cost. Subclasses set ``name`` (the registry key)."""

    name: str = "?"

    def __init__(self, plan: GridPlan, num_rounds: Optional[int] = None,
                 use_kernel: bool = False):
        self.plan = plan
        self.num_rounds = num_rounds
        self.use_kernel = use_kernel

    def __call__(self, state: Tree, mask: torch.Tensor) -> Tree:
        raise NotImplementedError

    def iteration_bytes(self, n_active: int, model_bytes: int,
                        mask: Optional[Any] = None) -> float:
        """Analytic data-plane bytes for one aggregation (topology.py) —
        the oracle the measured transcript is checked against."""
        return topology.iteration_bytes(
            self.name, n_active, model_bytes, self.plan,
            num_rounds=self.num_rounds, mask=mask)

    def message_plan(self, mask: Optional[Any], model_bytes: float) -> Any:
        """Unroll one aggregation into per-round ``(src, dst, nbytes)``
        messages (``core/transport.py``) — who sends what to whom, the
        input the network simulator times and drops."""
        from repro_torch.core import transport
        return transport.build_message_plan(
            self.name, self.plan, mask, model_bytes,
            num_rounds=self.num_rounds)


@register_aggregator
class MarAggregator(Aggregator):
    """Moshpit All-Reduce over a :class:`GridPlan` (the paper): masked
    segment means over the stacked peer axis, one per round."""

    name = "mar"

    def __call__(self, state: Tree, mask: torch.Tensor) -> Tree:
        from repro_torch.core import mar_allreduce as mar
        return mar.mar_aggregate_sim(state, self.plan, mask,
                                     num_rounds=self.num_rounds,
                                     use_kernel=self.use_kernel)


class _GlobalMeanAggregator(Aggregator):
    """Strategies whose fixed point is the masked global mean; they
    differ only in cost/latency models (topology.py) and churn story."""

    def __call__(self, state: Tree, mask: torch.Tensor) -> Tree:
        from repro_torch.core import mar_allreduce as mar
        return mar.allreduce_all_to_all_sim(state, mask)


@register_aggregator
class FedAvgAggregator(_GlobalMeanAggregator):
    """Client-server mean over participating peers: O(N) bytes, but a
    central rendezvous (the baseline MAR-FL removes)."""
    name = "fedavg"


@register_aggregator
class AllToAllAggregator(_GlobalMeanAggregator):
    """Naive all-to-all All-Reduce FL: O(N^2) bytes, 1 round."""
    name = "ar"


@register_aggregator
class RingAggregator(_GlobalMeanAggregator):
    """RDFL-style ring circulation: O(N^2) bytes, N-1 sequential hops."""
    name = "rdfl"


@register_aggregator
class HierarchicalAggregator(_GlobalMeanAggregator):
    """Two-tier FedAvg (beyond-paper): peers average within their leaf
    MAR group via a group leader, leaders average among themselves, and
    the result is broadcast back down. The fixed point equals the global
    masked mean; the cost model (2(N + #groups) model-units, 4 rounds)
    sits between fedavg and mar — see ``topology.py``."""
    name = "hierarchical"


@register_aggregator
class GossipAggregator(Aggregator):
    """Push-sum ring gossip with doubling shifts (beyond-paper).

    Round r averages each peer's (value, weight) pair with the peer
    ``2^r`` positions behind it on a fixed ring; ``num_rounds`` defaults
    to ceil(log2 N), after which every window covers the ring — exact
    global mean for power-of-two N under full participation, a
    weight-corrected approximation otherwise."""
    name = "gossip"

    def __init__(self, plan: GridPlan, num_rounds: Optional[int] = None,
                 **kwargs: Any):
        if num_rounds is None:
            # pin the default here so execution and byte accounting use
            # the same count: the ring covers all peers, active or not,
            # so rounds depend on total N (not on n_active under churn)
            num_rounds = max(1, int(np.ceil(np.log2(max(plan.n_peers,
                                                        2)))))
        super().__init__(plan, num_rounds=num_rounds, **kwargs)

    def __call__(self, state: Tree, mask: torch.Tensor) -> Tree:
        from repro_torch.core import mar_allreduce as mar
        return mar.gossip_aggregate_sim(state, mask,
                                        rounds=self.num_rounds)


#: registry-backed technique list (import-stable name for configs/tests)
TECHNIQUES: Tuple[str, ...] = tuple(AGGREGATORS)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

class AggregationPipeline:
    """The aggregator a federation runs, with its byte accounting.

    ``pipeline(state, mask)`` returns the aggregated state. The
    reference also threads wire-stage state through here; with no
    stages ported, the wire size of a state transfer is the model size.
    """

    def __init__(self, aggregator: Aggregator):
        self.aggregator = aggregator

    def __call__(self, state: Tree, mask: torch.Tensor) -> Tree:
        return self.aggregator(state, mask)

    def message_plan(self, mask: Optional[Any], model_bytes: float) -> Any:
        """The aggregator's message plan at wire sizes."""
        return self.aggregator.message_plan(mask, model_bytes)

    def record_transcript(self, ledger: CommLedger,
                          transcript: Any) -> float:
        """Record one FL iteration from a measured transport transcript
        (``runtime/transport_base.py``) — bytes as transmitted (lost
        messages consumed airtime and are billed) plus seconds."""
        ledger.record(f"agg/{self.aggregator.name}", transcript.total_bytes)
        ledger.record_time(transcript.iteration_s)
        return transcript.total_bytes


def build_pipeline(technique: str, plan: GridPlan, *,
                   num_rounds: Optional[int] = None,
                   use_kernel: bool = False,
                   async_aggregation: bool = False,
                   use_dp: bool = False,
                   use_secagg: bool = False,
                   compress: Optional[str] = None) -> AggregationPipeline:
    """Config-driven pipeline assembly. The stage flags keep the
    reference's names and raise until the stages are ported."""
    stages = {"async_aggregation": async_aggregation, "use_dp": use_dp,
              "use_secagg": use_secagg, "compress": compress is not None}
    asked = [k for k, v in stages.items() if v]
    if asked:
        raise NotImplementedError(
            f"wire stages {asked} are not ported yet "
            f"(ROADMAP.md, Queue 1 item 7)")
    return AggregationPipeline(make_aggregator(
        technique, plan, num_rounds=num_rounds, use_kernel=use_kernel))
