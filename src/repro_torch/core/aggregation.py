"""Aggregation: the Aggregator registry, wire stages, the CommLedger and
the pipeline.

Port of the JAX package's ``repro/core/aggregation.py`` (sim backend):

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
* :class:`WireStage` — *how* the exchanged tensors are transformed on
  the wire. Stages wrap any aggregator (or another stage): int8
  error-feedback delta compression (:class:`Int8EFStage`), decentralized
  DP with adaptive clipping and optional secure aggregation of the
  clipping indicator (:class:`DPStage`), and staleness-1 delayed
  application (:class:`AsyncStage`). Stage state (EF residuals, DP clip
  bounds, pending aggregates) threads through the pipeline as one dict.
* :class:`AggregationPipeline` — the aggregator and its stages, the one
  thing the federation calls. Stage order is outermost-first:
  ``[async, dp, int8_ef]`` means the staleness-1 schedule wraps DP
  privatization, which wraps quantized exchange.

Canonical aggregation state is a dict ``{"p": params, "m": momentum}``
with peers on the leading axis of every leaf; stages may grow it with
extra keys (DP adds the smoothed delta ``"sd"`` and the clipping
indicator ``"b"``) that are averaged alongside and stripped before
returning.

Where the reference hands stage ``i`` the key ``fold_in(rng, i)``, the
port hands each stage its own draws (:meth:`WireStage.draw`), made from
the federation's aggregation generator or injected by a caller.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from repro_torch.core import topology
from repro_torch.core.moshpit import GridPlan
from repro_torch.core.replan import resize_state_tree
from repro_torch.tree import Tree, tree_leaves, tree_map

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

    def kd_bytes(self, n_active: int, model_bytes: int,
                 kd_logit_bytes: int) -> float:
        """Extra bytes a KD-enabled iteration adds on this topology."""
        full = topology.iteration_bytes(
            self.name, n_active, model_bytes, self.plan,
            num_rounds=self.num_rounds, use_kd=True,
            kd_logit_bytes=kd_logit_bytes)
        return full - self.iteration_bytes(n_active, model_bytes)


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
# wire-stage layer
# ---------------------------------------------------------------------------

#: the wrapped pipeline a stage calls: ``(state, pipe_state) ->
#: (state, pipe_state)``
InnerFn = Callable[[Tree, Dict[str, Any]], Tuple[Tree, Dict[str, Any]]]

WIRE_STAGES: Dict[str, Type["WireStage"]] = {}


def register_stage(cls: Type["WireStage"]) -> Type["WireStage"]:
    WIRE_STAGES[cls.name] = cls
    return cls


class WireStage:
    """A composable transform around an aggregator (or another stage).

    ``apply`` receives the canonical agg state, the *whole* pipeline
    state dict (its own slice under ``self.name``), the participation
    mask and its own draws (what :meth:`draw` made, or what a caller
    handed in); it must call ``inner`` exactly once and return
    (agg_state, pipe_state) with its own slice updated.
    ``transform_bytes`` maps the wrapped pipeline's wire bytes to this
    stage's (e.g. a compression ratio); identity by default.
    """

    name: str = "?"

    def init(self, template: Tree) -> Optional[Tree]:
        """Initial stage state for an agg-state template; None if
        stateless."""
        return None

    def draw(self, state: Tree, gen: torch.Generator,
             given: Optional[Dict[str, Any]] = None) -> Optional[Any]:
        """This iteration's random draws for ``state`` from ``gen``; the
        entries of ``given`` are taken as they are. None if the stage
        draws nothing."""
        return None

    def apply(self, inner: InnerFn, state: Tree,
              pipe_state: Dict[str, Any], mask: torch.Tensor,
              draws: Any) -> Tuple[Tree, Dict[str, Any]]:
        raise NotImplementedError

    def transform_bytes(self, inner_bytes: float, n_active: int,
                        model_bytes: int) -> float:
        return inner_bytes

    def resize_state(self, own: Tree, old_n: int, new_n: int) -> Tree:
        """Elastic membership: remap this stage's state to a new peer
        count (mean-bootstrap by default; stages whose state must start
        empty for new peers name those keys)."""
        return resize_state_tree(own, old_n, new_n)

    def with_plan(self, new_plan: GridPlan) -> "WireStage":
        """Same stage bound to a new grid. Most stages are
        grid-agnostic; plan-holding stages override."""
        return self


@register_stage
class Int8EFStage(WireStage):
    """int8 error-feedback delta compression (core/compression.py).

    Quantizes each peer's delta against the shared reference point,
    aggregates the dequantized deltas through the wrapped pipeline, and
    re-anchors: ref' = ref + agg(delta). The per-peer quantization
    residual carries into the next iteration (EF-SGD), so the bias
    cancels over time. Only the ``"p"`` entry is compressed; momentum
    (and any stage-added keys) travel exact in sim to isolate the theta
    quantization error; accounting discounts all wire bytes uniformly.
    """

    name = "int8_ef"

    def init(self, template: Tree) -> Tree:
        ref = tree_map(lambda x: x.float().clone(), template["p"])
        return {"ref": ref, "err": tree_map(torch.zeros_like, ref)}

    def apply(self, inner, state, pipe_state, mask, draws):
        from repro_torch.core.compression import compress_tree
        own = pipe_state[self.name]
        ref = own["ref"]
        delta = tree_map(lambda p, r: p.float() - r, state["p"], ref)
        deq, new_err = compress_tree(delta, own["err"])
        out, pipe_state = inner({**state, "p": deq}, pipe_state)
        new_ref = tree_map(lambda r, d: r + d, ref, out["p"])
        new_p = tree_map(lambda nr, p: nr.to(p.dtype), new_ref, state["p"])
        return ({**out, "p": new_p},
                {**pipe_state, self.name: {"ref": new_ref, "err": new_err}})

    def transform_bytes(self, inner_bytes, n_active, model_bytes):
        from repro_torch.core.compression import INT8_RATIO
        return inner_bytes / INT8_RATIO

    def resize_state(self, own, old_n, new_n):
        # a grown peer anchors at the mean reference but must not
        # inherit another peer's quantization residual
        return resize_state_tree(own, old_n, new_n, zero_keys=("err",))


@register_stage
class DPStage(WireStage):
    """Decentralized DP with adaptive clipping (paper Alg. 4; core/dp.py).

    Clips and noises each peer's local delta, lets the wrapped pipeline
    average the privatized models (plus the smoothed delta and, unless
    ``use_secagg`` routes it through pairwise-masked secure aggregation,
    the clipping indicator), then updates the shared clipping bound.
    Wire bytes are unchanged versus the plain path. Its draws: unit
    normals shaped like theta's leaves (``"delta"``), one scalar
    (``"b"``) and an int64 root key for secagg (``"root"``).
    """

    name = "dp"

    def __init__(self, plan: GridPlan, noise_multiplier: float = 0.3,
                 clip_init: float = 1.0, use_secagg: bool = False):
        self.plan = plan
        self.noise_multiplier = noise_multiplier
        self.clip_init = clip_init
        self.use_secagg = use_secagg

    def init(self, template: Tree) -> Tree:
        from repro_torch.core.dp import dp_init
        return dp_init(template["p"], self.clip_init)

    def draw(self, state, gen, given=None):
        given = dict(given or {})
        dev = tree_leaves(state["p"])[0].device
        if "delta" not in given:
            given["delta"] = [
                torch.randn(x.shape, generator=gen, device=dev)
                for x in tree_leaves(state["p"])]
        if "b" not in given:
            given["b"] = torch.randn((), generator=gen, device=dev)
        if "root" not in given:     # drawn with or without secagg, so
            # turning secagg on leaves every later noise draw as it was
            given["root"] = torch.randint(
                -(1 << 62), 1 << 62, (), generator=gen, device=dev)
        return given

    def apply(self, inner, state, pipe_state, mask, draws):
        from repro_torch.core.dp import dp_transform
        carried: Dict[str, Any] = {}

        def aggregate_fn(agg_state):
            out, carried["pipe"] = inner(agg_state, pipe_state)
            return out

        out_state, new_dp = dp_transform(
            aggregate_fn, state, pipe_state[self.name], mask, draws,
            noise_multiplier=self.noise_multiplier, plan=self.plan,
            use_secagg=self.use_secagg, secagg_root=draws.get("root"))
        return out_state, {**carried["pipe"], self.name: new_dp}

    def resize_state(self, own, old_n, new_n):
        # has_delta is a bot marker: a new peer has no smoothed delta yet
        return resize_state_tree(own, old_n, new_n,
                                 zero_keys=("has_delta",))

    def with_plan(self, new_plan):
        # secagg pairwise masks pair within MAR groups: re-bind the grid
        return DPStage(new_plan, noise_multiplier=self.noise_multiplier,
                       clip_init=self.clip_init,
                       use_secagg=self.use_secagg)


@register_stage
class AsyncStage(WireStage):
    """Staleness-1 delayed application (beyond-paper).

    The aggregate launched for iteration t's snapshot is *applied* at
    t+1 with a local-progress correction,
    ``x_{t+1} = agg(y_{t-1}) + (y_t - y_{t-1})``, so on real hardware
    the collective overlaps the next iteration's compute instead of
    blocking. Wraps any inner pipeline: whatever the wrapped stages
    produce for snapshot t is what gets applied at t+1."""

    name = "async"

    def init(self, template: Tree) -> Tree:
        # zeros placeholders and a has-pending flag keep the stage state's
        # structure the same on every iteration
        zeros = tree_map(torch.zeros_like, template)
        return {"pending": {"agg": zeros, "snap": zeros},
                "has": torch.zeros((), dtype=torch.float32,
                                   device=tree_leaves(template)[0].device)}

    def apply(self, inner, state, pipe_state, mask, draws):
        agg_out, pipe_state = inner(state, pipe_state)
        own = pipe_state[self.name]
        pending = own["pending"]
        # first iteration (has=0): no pending aggregate — pass through
        out = tree_map(
            lambda ag, y, sn: torch.where(
                own["has"] > 0,
                (ag + (y.to(ag.dtype) - sn.to(ag.dtype))).to(y.dtype), y),
            pending["agg"], state, pending["snap"])
        new_own = {"pending": {"agg": agg_out, "snap": state},
                   "has": torch.ones_like(own["has"])}
        return out, {**pipe_state, self.name: new_own}


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

class AggregationPipeline:
    """An aggregator wrapped by zero or more wire stages.

    ``pipeline(state, pipe_state, mask, draws)`` returns the aggregated
    state plus updated stage states; ``draws`` holds each stage's draws
    under its name (:meth:`draw`). Stage order is outermost-first. Byte
    accounting mirrors the execution nesting: the aggregator's analytic
    bytes pass inner-to-outer through each stage's ``transform_bytes``.
    """

    def __init__(self, aggregator: Aggregator,
                 stages: Sequence[WireStage] = ()):
        self.aggregator = aggregator
        self.stages = tuple(stages)
        names = [s.name for s in self.stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate wire stages: {names}")

    @property
    def stage_names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.stages)

    def init_state(self, template: Tree) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for stage in self.stages:
            st = stage.init(template)
            if st is not None:
                out[stage.name] = st
        return out

    def resize_state(self, pipe_state: Dict[str, Any], old_n: int,
                     new_n: int) -> Dict[str, Any]:
        """Elastic membership: each stage remaps its own state slice."""
        out = dict(pipe_state)
        for stage in self.stages:
            if stage.name in out:
                out[stage.name] = stage.resize_state(out[stage.name],
                                                     old_n, new_n)
        return out

    def with_plan(self, new_plan: GridPlan) -> "AggregationPipeline":
        """Same pipeline over a new grid: the aggregator is rebuilt for
        the new dims with its configuration kept; stages re-bind where
        they hold the plan (DP/secagg pairing)."""
        a = self.aggregator
        agg = type(a)(new_plan, num_rounds=a.num_rounds,
                      use_kernel=a.use_kernel)
        return AggregationPipeline(
            agg, [s.with_plan(new_plan) for s in self.stages])

    def draw(self, state: Tree, gen: torch.Generator,
             given: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Every stage's draws for this iteration, by stage name, from
        ``gen`` in stage order; ``given[name]`` entries are kept."""
        given = given or {}
        out: Dict[str, Any] = {}
        for stage in self.stages:
            d = stage.draw(state, gen, given.get(stage.name))
            if d is not None:
                out[stage.name] = d
        return out

    def __call__(self, state: Tree, pipe_state: Dict[str, Any],
                 mask: torch.Tensor, draws: Optional[Dict[str, Any]] = None
                 ) -> Tuple[Tree, Dict[str, Any]]:
        draws = draws or {}

        def run(i: int, state: Tree, pipe_state: Dict[str, Any]):
            if i == len(self.stages):
                return self.aggregator(state, mask), pipe_state
            stage = self.stages[i]
            inner = lambda s, ps: run(i + 1, s, ps)  # noqa: E731
            return stage.apply(inner, state, pipe_state, mask,
                               draws.get(stage.name))
        return run(0, state, pipe_state)

    # -- accounting -----------------------------------------------------
    def iteration_bytes(self, n_active: int, model_bytes: int,
                        mask: Optional[Any] = None) -> float:
        """Wire bytes of one aggregation after all stage transforms."""
        b = self.aggregator.iteration_bytes(n_active, model_bytes, mask)
        for stage in reversed(self.stages):      # inner-to-outer
            b = stage.transform_bytes(b, n_active, model_bytes)
        return b

    def wire_model_bytes(self, model_bytes: float,
                         n_active: int) -> float:
        """Per-message wire size of one state transfer after stage
        transforms (e.g. / ``INT8_RATIO``): the ``nbytes`` messages
        carry in a transport plan, so compression shrinks simulated
        transfer *time*, not just the ledger's byte total."""
        b = float(model_bytes)
        for stage in reversed(self.stages):      # inner-to-outer
            b = stage.transform_bytes(b, n_active, model_bytes)
        return b

    def message_plan(self, mask: Optional[Any], model_bytes: float,
                     n_active: int, use_kd: bool = False,
                     kd_logit_bytes: float = 0) -> Any:
        """The aggregator's message plan at post-stage wire sizes.

        With ``use_kd`` the iteration's MKD rounds (teacher pulls +
        logit exchanges over the same MAR groups) are prepended at
        *raw* sizes: distillation doesn't ride the compressed delta
        wire format.
        """
        mp = self.aggregator.message_plan(
            mask, self.wire_model_bytes(model_bytes, n_active))
        if use_kd and self.aggregator.name == "mar":
            from repro_torch.core import transport
            mp = transport.with_mkd_traffic(
                mp, self.aggregator.plan, mask, model_bytes,
                kd_logit_bytes, num_rounds=self.aggregator.num_rounds)
        return mp

    def record_transcript(self, ledger: CommLedger, transcript: Any,
                          n_active: int, model_bytes: int,
                          use_kd: bool = False,
                          kd_logit_bytes: int = 0) -> float:
        """Record one FL iteration from a measured transport transcript
        (``runtime/transport_base.py``): bytes as transmitted (lost
        messages consumed airtime and are billed) plus seconds. KD
        traffic is split out of the transcript via the plan's MKD
        prefix rounds (``Transcript.kd_bytes``); the analytic KD add-on
        remains only for transcripts of plans built without
        :meth:`message_plan`'s ``use_kd`` path."""
        kd_measured = getattr(transcript, "kd_bytes", 0.0)
        ledger.record(f"agg/{self.aggregator.name}",
                      transcript.total_bytes - kd_measured)
        ledger.record_time(transcript.iteration_s)
        total = transcript.total_bytes
        if kd_measured:
            ledger.record("kd", kd_measured)
        elif use_kd:
            kd = self.aggregator.kd_bytes(n_active, model_bytes,
                                          kd_logit_bytes)
            if kd:
                ledger.record("kd", kd)
                total += kd
        return total

    def record_iteration(self, ledger: CommLedger, n_active: int,
                         model_bytes: int, use_kd: bool = False,
                         kd_logit_bytes: int = 0,
                         mask: Optional[Any] = None) -> float:
        """Record one FL iteration's *analytic* bytes (for callers
        without a network sim); returns the total recorded. KD traffic
        is recorded separately and untransformed."""
        data = self.iteration_bytes(n_active, model_bytes, mask)
        ledger.record(f"agg/{self.aggregator.name}", data)
        total = data
        if use_kd:
            kd = self.aggregator.kd_bytes(n_active, model_bytes,
                                          kd_logit_bytes)
            if kd:
                ledger.record("kd", kd)
                total += kd
        return total


def build_pipeline(technique: str, plan: GridPlan, *,
                   num_rounds: Optional[int] = None,
                   use_kernel: bool = False,
                   async_aggregation: bool = False,
                   use_dp: bool = False,
                   noise_multiplier: float = 0.3,
                   dp_clip_init: float = 1.0,
                   use_secagg: bool = False,
                   compress: Optional[str] = None) -> AggregationPipeline:
    """Config-driven pipeline assembly (the one place that fixes stage
    order): async wraps DP wraps compression wraps the aggregator, so
    noising precedes quantization and both ride the delayed schedule.

    The sim backend only: the reference's ``backend``, ``one_shot`` and
    ``comm_dtype`` belong to the device backend (ROADMAP.md, Queue 1
    item 11)."""
    aggregator = make_aggregator(technique, plan, num_rounds=num_rounds,
                                 use_kernel=use_kernel)
    stages: List[WireStage] = []
    if async_aggregation:
        stages.append(AsyncStage())
    if use_dp:
        stages.append(DPStage(plan, noise_multiplier=noise_multiplier,
                              clip_init=dp_clip_init,
                              use_secagg=use_secagg))
    if compress is not None:
        if compress != "int8_ef":
            raise ValueError(f"unknown compression {compress!r}")
        stages.append(Int8EFStage())
    return AggregationPipeline(aggregator, stages)
