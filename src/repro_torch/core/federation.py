"""The MAR-FL training loop (Alg. 1) and its baselines (sim backend).

Port of the JAX package's ``repro/core/federation.py``. Peers are the
leading axis of every state leaf; the local update is damped momentum
SGD over all peers at once; aggregation runs through the
:class:`~repro_torch.core.aggregation.AggregationPipeline`, whose
technique picks the aggregator from the registry — ``mar`` (the paper),
``fedavg``, ``rdfl``, ``ar``, plus beyond-paper ``gossip`` and
``hierarchical``.

Wire stages compose around the aggregator from config flags:
staleness-1 async application, DP privatization (with optional secure
aggregation of the clipping indicator), int8 error-feedback delta
compression. With ``use_kd`` the first ``kd_iterations`` iterations run
Moshpit-KD (``core/mkd.py``) between the local update and aggregation,
and its traffic rides the same message plan.

Partial participation and dropout follow §3.1: U_t peers run local
updates; A_t = U_t minus dropouts joins aggregation; non-participants
carry state forward (Alg. 1 line 5). Both masks come from the
:class:`~repro_torch.runtime.lifecycle.PeerLifecycle`; a permanent
join/leave it asks for (``cfg.resize_schedule`` or a trace) becomes a
:class:`~repro_torch.core.replan.MembershipChange` through
:meth:`Federation.apply_membership`, mid-run. Every step unrolls the
aggregation into a message plan and runs it through the ``"sim"``
transport; the transcript feeds the ledger, and lost sends demote their
peer to receiver-only for the iteration.

Where the reference draws from ``jax.random`` keys, the port draws from
``torch.Generator``s on the federation's device: the initial parameters
from ``cfg.seed``, and per step the minibatch indices
(``cfg.seed + 7``), the MKD distillation rows (``cfg.seed + 8``) and the
wire stages' draws, DP's unit normals and the secagg root
(``cfg.seed + 9``). The values differ from the reference's;
``Federation.init_state(params=)`` and ``Federation.step(batch_indices=,
draws=)`` take the reference's own so the two packages can be run step
for step. Everything numpy-seeded (data, partition, masks, links, the
ledger) is bit-identical.

Adaptive group sizing, placement and same-N regroups wait for a later
slice; they raise ``NotImplementedError`` naming the ROADMAP.md item
that ports them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import topology
from repro_torch.core.aggregation import (TECHNIQUES, AggregationPipeline,
                                          CommLedger, build_pipeline)
from repro_torch.core.mkd import mkd_rounds
from repro_torch.core.moshpit import GridPlan, plan_grid
from repro_torch.core.replan import (MembershipChange,
                                     plan_membership_change,
                                     regroup_change, select_survivors)
from repro_torch.data.partition import dirichlet_partition, iid_partition
from repro_torch.data.synthetic import classification_task
from repro_torch.models.small import build_peer_model
from repro_torch.optim.sgdm import momentum_sgd_init, momentum_sgd_step
from repro_torch.runtime.lifecycle import PeerLifecycle, build_lifecycle
from repro_torch.runtime.transport_base import (UNPORTED_TRANSPORTS,
                                                build_transport,
                                                demote_lost_senders)
from repro_torch.tree import Tree, tree_leaves, tree_map

#: ``torch.profiler`` labels of the layers one ``Federation.step`` runs:
#: transport (lifecycle tick, any membership change, message plan,
#: network sim, masks to the device), local update (SGD steps and the
#: participation select), MKD (the distillation rounds, only in steps
#: that run them), aggregation (the pipeline and the ledger). Only a
#: profiler reads them.
SPAN_TRANSPORT = "federation.transport"
SPAN_LOCAL_UPDATE = "federation.local_update"
SPAN_MKD = "federation.mkd"
SPAN_AGGREGATE = "federation.aggregate"

#: seed offsets of the step's generators (the reference splits one key)
_SEED_BATCH, _SEED_KD, _SEED_AGG = 7, 8, 9

#: (field, value that means "off", ROADMAP.md item that ports it)
_UNPORTED_FIELDS = (
    ("adaptive_m", None, "Queue 1 item 13 (adaptive group sizing)"),
    ("placement", None, "Queue 1 item 13 (topology-aware placement)"),
)


@dataclasses.dataclass(frozen=True)
class FederationConfig:
    """The reference's config, field for field, so one config means the
    same run in both packages (see its docstrings for each field)."""

    n_peers: int = 125
    technique: str = "mar"
    task: str = "text"               # vision | text
    # MAR grid: default plan_grid(n_peers) -> e.g. 125 = 5^3
    group_size: Optional[int] = None
    mar_rounds: Optional[int] = None  # None -> grid depth (exact)
    # local update (paper §3.1)
    local_batches: int = 1            # B in Alg. 1
    batch_size: int = 16              # 64 for vision, 16 for text per paper
    lr: float = 0.1
    momentum: float = 0.9
    # participation / churn — a lifecycle scenario name from
    # runtime/lifecycle.py; None keeps i.i.d. Bernoulli masks
    participation_rate: float = 1.0
    dropout_rate: float = 0.0
    churn: Optional[str] = None
    churn_params: Optional[Dict[str, Any]] = None
    resize_schedule: Tuple[Tuple[int, int], ...] = ()
    adaptive_m: Optional[str] = None
    adaptive_m_params: Optional[Dict[str, Any]] = None
    placement: Optional[str] = None
    placement_params: Optional[Dict[str, Any]] = None
    # route the sim MAR masked group mean through the hand-written CUDA
    # kernel (kernels/group_mean.py) instead of the grouped segment sums;
    # the reference's field is ``pallas_group_mean``
    kernel_group_mean: bool = False
    # data heterogeneity
    alpha: Optional[float] = 1.0      # Dirichlet; None -> iid
    # KD (Alg. 2/3)
    use_kd: bool = False
    kd_iterations: int = 6            # K
    kd_temperature: float = 3.0       # tau
    kd_selection_ratio: float = 0.4   # rho_l
    kd_epochs: int = 1                # E
    # DP wire stage (Alg. 4)
    use_dp: bool = False
    noise_multiplier: float = 0.3     # sigma_mult
    dp_clip_init: float = 1.0         # C_0
    use_secagg: bool = False
    async_aggregation: bool = False
    compress: Optional[str] = None    # None | "int8_ef"
    # discrete-event network layer (runtime/network.py); None -> the
    # lossless "uniform" profile
    link_profile: Optional[str] = None
    link_params: Optional[Dict[str, Any]] = None
    transport: str = "sim"
    seed: int = 0

    def __post_init__(self):
        for name, off, item in _UNPORTED_FIELDS:
            if getattr(self, name) != off:
                raise NotImplementedError(
                    f"FederationConfig.{name} is not ported yet "
                    f"(ROADMAP.md, {item})")
        if self.transport in UNPORTED_TRANSPORTS:
            raise NotImplementedError(
                f"transport {self.transport!r} is not ported yet "
                f"(ROADMAP.md, {UNPORTED_TRANSPORTS[self.transport]}); "
                f"use 'sim'")

    def grid(self) -> GridPlan:
        return plan_grid(self.n_peers, self.group_size)


@dataclasses.dataclass
class FederationState:
    params: Tree                      # [N, ...] stacked peer params
    momentum: Tree                    # [N, ...]
    iteration: int
    # draws the minibatch indices of steps that are not handed any; it
    # advances in place, so stepping one state twice draws new indices
    rng: torch.Generator
    # the same for the MKD distillation rows and the wire stages' draws
    kd_rng: torch.Generator
    agg_rng: torch.Generator
    # wire-stage state keyed by stage name: "dp" (clip bound, smoothed
    # deltas), "async" (pending aggregate), "int8_ef" (ref + EF residual)
    pipe: Dict[str, Any] = dataclasses.field(default_factory=dict)
    kd_lambda: float = 1.0

    # -- legacy accessors (the reference's pre-pipeline field names) ----
    @property
    def dp(self) -> Optional[Dict[str, Any]]:
        return self.pipe.get("dp")

    @property
    def pending(self) -> Optional[Tree]:
        a = self.pipe.get("async")
        return a["pending"] if a else None

    @property
    def ref(self) -> Optional[Tree]:
        c = self.pipe.get("int8_ef")
        return c["ref"] if c else None

    @property
    def ef_error(self) -> Optional[Tree]:
        c = self.pipe.get("int8_ef")
        return c["err"] if c else None


def _resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "Federation runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class Federation:
    """Owns the task data, the aggregation pipeline, the transport
    backend and the comm ledger, on one ``torch.device``.

    ``device=None`` means CUDA, and raises where there is none; pass
    ``device="cpu"`` to run on the CPU.
    """

    def __init__(self, cfg: FederationConfig,
                 device: Union[None, str, torch.device] = None,
                 lifecycle: Optional[PeerLifecycle] = None):
        if cfg.technique not in TECHNIQUES:
            raise ValueError(cfg.technique)
        self.device = _resolve_device(device)
        self.cfg = cfg
        self.plan = cfg.grid()
        self.pipeline = self._build_pipeline(cfg, self.plan)
        self.ledger = CommLedger()
        self.network = build_transport(cfg.transport, cfg.n_peers,
                                       profile=cfg.link_profile,
                                       seed=cfg.seed,
                                       link_params=cfg.link_params)
        self.last_transcript = None
        # message plans by (mask, KD shape): identical steps reuse them
        self._plan_cache: Dict[Tuple, Any] = {}
        # (iteration, old_dims, new_dims) of every adaptive regroup and
        # (iteration, peers_moved) of every placement regroup: empty until
        # adaptive_m and placement are ported (ROADMAP.md Queue 1 item 13)
        self.regroup_log: List[Tuple[int, Tuple[int, ...],
                                     Tuple[int, ...]]] = []
        self.placement_log: List[Tuple[int, int]] = []
        self.lifecycle = lifecycle if lifecycle is not None else \
            build_lifecycle(cfg.churn, cfg.n_peers, seed=cfg.seed,
                            participation_rate=cfg.participation_rate,
                            dropout_rate=cfg.dropout_rate,
                            churn_params=cfg.churn_params,
                            schedule=cfg.resize_schedule)
        spec, train, test = classification_task(cfg.task, seed=cfg.seed)
        self.spec = spec
        self._train = train
        self.test = {"x": torch.as_tensor(test["x"], device=self.device),
                     "y": torch.as_tensor(test["y"], dtype=torch.int64,
                                          device=self.device)}
        self.init_fn, self.apply_fn = build_peer_model(
            cfg.task, spec.feature_dim, spec.num_classes)

        # --- federated partition (rectangular per-peer arrays) ----------
        xs, ys = self._peer_shards(range(cfg.n_peers), cfg.n_peers)
        self.data_x = torch.as_tensor(np.stack(xs), device=self.device)
        self.data_y = torch.as_tensor(np.stack(ys), dtype=torch.int64,
                                      device=self.device)   # [N, P]
        self._peer_rows = torch.arange(cfg.n_peers,
                                       device=self.device)[:, None]

        self.model_bytes = topology.pytree_bytes(
            self.init_fn(torch.Generator().manual_seed(0))) * 2  # theta + m

    @staticmethod
    def _build_pipeline(cfg: FederationConfig,
                        plan: GridPlan) -> AggregationPipeline:
        return build_pipeline(
            cfg.technique, plan, num_rounds=cfg.mar_rounds,
            use_kernel=cfg.kernel_group_mean,
            async_aggregation=cfg.async_aggregation,
            use_dp=cfg.use_dp, noise_multiplier=cfg.noise_multiplier,
            dp_clip_init=cfg.dp_clip_init, use_secagg=cfg.use_secagg,
            compress=cfg.compress)

    def _peer_shards(self, peers, n_peers: int,
                     per_peer: Optional[int] = None):
        """Data rows for the given peer ids out of an ``n_peers``-way
        partition of the training set. Shard *membership* is
        deterministic in (cfg.seed, n_peers); the per-peer row
        subsample is seeded but consumes the rng in loop order, so a
        mid-run joiner's rows differ from the rows it would have drawn
        in a fresh run at the same size (the shard itself matches)."""
        cfg = self.cfg
        if cfg.alpha is None:
            shards = iid_partition(len(self._train["y"]), n_peers,
                                   seed=cfg.seed)
        else:
            shards = dirichlet_partition(self._train["y"], n_peers,
                                         alpha=cfg.alpha, seed=cfg.seed)
        rng = np.random.default_rng(cfg.seed + 1)
        if per_peer is None:
            per_peer = max(cfg.batch_size,
                           int(np.median([len(s) for s in shards])))
        xs, ys = [], []
        for i in peers:
            s = shards[i]
            take = rng.choice(s, size=per_peer, replace=len(s) < per_peer)
            xs.append(self._train["x"][take])
            ys.append(self._train["y"][take])
        return xs, ys

    @property
    def comm_bytes(self) -> float:
        """Total data-plane bytes so far (CommLedger-backed)."""
        return self.ledger.total_bytes

    @property
    def sim_seconds(self) -> float:
        """Cumulative simulated communication seconds."""
        return self.network.clock

    # ------------------------------------------------------------------
    def init_state(self, params: Optional[Tree] = None) -> FederationState:
        """theta^0 for every peer (Alg. 1), zero momentum.

        ``params`` is one peer's theta^0 (a tree of tensors, e.g. from
        :func:`repro_torch.convert.params_from_numpy`); without it the
        draw comes from a ``torch.Generator`` seeded with ``cfg.seed``.
        """
        if params is None:
            params = self.init_fn(torch.Generator().manual_seed(self.cfg.seed))
        n = self.cfg.n_peers
        stacked = tree_map(
            lambda x: x.to(self.device, torch.float32).unsqueeze(0)
            .expand((n,) + tuple(x.shape)).contiguous(), params)
        mom = momentum_sgd_init(stacked)
        pipe = self.pipeline.init_state({"p": stacked, "m": mom})
        return FederationState(params=stacked, momentum=mom, iteration=0,
                               rng=self._generator(_SEED_BATCH),
                               kd_rng=self._generator(_SEED_KD),
                               agg_rng=self._generator(_SEED_AGG),
                               pipe=pipe)

    def _generator(self, offset: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.cfg.seed + offset)
        return gen

    # ------------------------------------------------------------------
    # elastic membership (mid-run, no checkpoint/restart)
    # ------------------------------------------------------------------
    def apply_membership(self, state: FederationState,
                         change: MembershipChange) -> FederationState:
        """The membership entry point: every layer's reaction to one
        :class:`~repro_torch.core.replan.MembershipChange`.

        A different-N change (permanent join/leave): survivors'
        params, momentum and pipe state map through the change
        bit-exact, joiners bootstrap from the f32 mean (per-stage zero
        rules for wire state), the data shards follow the survivor map
        (joiners draw theirs from a new-N partition), the pipeline is
        rebuilt for ``change.new_plan``, and the lifecycle and the
        transport links re-bind to the new fleet. A same-N change (an
        adaptive-M or placement regroup) waits for
        ``core/adaptive.validate_proposal`` (ROADMAP.md, Queue 1 item
        13) and raises.
        """
        if change.old_n != self.cfg.n_peers:
            raise ValueError(
                f"change was planned for {change.old_n} peers, fleet "
                f"has {self.cfg.n_peers}")
        if change.same_n:
            raise NotImplementedError(
                "same-N membership changes (adaptive-M and placement "
                "regroups) need core/adaptive.validate_proposal, which "
                "is not ported yet (ROADMAP.md, Queue 1 item 13)")

        old_n, new_n = change.old_n, change.new_n
        k = len(change.survivors)
        params = change.apply_to_tree(state.params)
        momentum = change.apply_to_tree(state.momentum)
        # pipe state: survivor gather is a pure reindex; the joiner
        # bootstrap routes through the per-stage hooks (EF residuals
        # start at zero, DP bot markers reset)
        pipe = select_survivors(state.pipe, old_n, change.survivors)
        pipe = self.pipeline.resize_state(pipe, k, new_n)

        # per-peer data: survivors keep their shard; joiners draw theirs
        # from a new_n-way partition of the same training set
        self.data_x = select_survivors(self.data_x, old_n,
                                       change.survivors)
        self.data_y = select_survivors(self.data_y, old_n,
                                       change.survivors)
        if new_n > k:
            xs, ys = self._peer_shards(range(k, new_n), new_n,
                                       per_peer=self.data_x.shape[1])
            self.data_x = torch.cat([self.data_x, torch.as_tensor(
                np.stack(xs), device=self.device)])
            self.data_y = torch.cat([self.data_y, torch.as_tensor(
                np.stack(ys), dtype=torch.int64, device=self.device)])
        self._peer_rows = torch.arange(new_n, device=self.device)[:, None]

        self.cfg = dataclasses.replace(self.cfg, n_peers=new_n)
        self.plan = change.new_plan
        self._plan_cache.clear()
        self.pipeline = self._build_pipeline(self.cfg, change.new_plan)
        if self.lifecycle.n_peers != new_n:
            self.lifecycle.resize(new_n)
        # survivors keep their modeled links; joiners draw fresh ones
        self.network.resize(new_n)
        return dataclasses.replace(state, params=params,
                                   momentum=momentum, pipe=pipe)

    def resize(self, state: FederationState,
               new_n: int) -> FederationState:
        """Permanent join/leave: plans the :class:`MembershipChange`
        (``elastic_replan`` grid, contiguous survivor prefix) and routes
        it through :meth:`apply_membership`. Surviving peers' state is
        untouched (bit-exact); joining peers bootstrap from the mean."""
        if new_n == self.cfg.n_peers:
            return state
        return self.apply_membership(
            state, plan_membership_change(self.plan, new_n,
                                          iteration=state.iteration))

    def regroup(self, state: FederationState,
                new_plan: GridPlan) -> FederationState:
        """Swap the MAR grid mid-run without touching membership: a
        same-N :class:`MembershipChange` through :meth:`apply_membership`
        (raises until ROADMAP.md Queue 1 item 13 lands)."""
        return self.apply_membership(
            state, regroup_change(self.plan, new_plan,
                                  iteration=state.iteration))

    # ------------------------------------------------------------------
    # local update: damped momentum SGD over B minibatches, all peers
    # ------------------------------------------------------------------
    def _local_update(self, params: Tree, momentum: Tree,
                      batch_indices: torch.Tensor) -> Tuple[Tree, Tree]:
        """One forward over the stacked [N, ...] parameters and one
        backward of the *sum* of the per-peer mean losses: the peers'
        parameters are disjoint, so each gets exactly its own gradient
        (the reference vmaps ``grad`` over peers instead)."""
        cfg = self.cfg
        for j in range(cfg.local_batches):
            idx = batch_indices[:, j]                    # [N, B]
            bx = self.data_x[self._peer_rows, idx]       # [N, B, F]
            by = self.data_y[self._peer_rows, idx]       # [N, B]
            leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
            with torch.enable_grad():
                logp = torch.log_softmax(self.apply_fn(leaves, bx), dim=-1)
                nll = -logp.gather(-1, by.unsqueeze(-1)).squeeze(-1)
                grads = iter(torch.autograd.grad(nll.mean(dim=1).sum(),
                                                 tree_leaves(leaves)))
            grads = tree_map(lambda _: next(grads), leaves)
            params, momentum = momentum_sgd_step(params, momentum, grads,
                                                 cfg.lr, cfg.momentum)
        return params, momentum

    def _draw_batch_indices(self, state: FederationState) -> torch.Tensor:
        cfg = self.cfg
        return torch.randint(
            0, self.data_x.shape[1],
            (cfg.n_peers, cfg.local_batches, cfg.batch_size),
            generator=state.rng, device=self.device)

    def _check_indices(self, idx: Any, want: Tuple[int, ...], what: str,
                       axes: str) -> torch.Tensor:
        """``idx`` as int64 on the device, if it has shape ``want`` and
        every entry is a row of a peer's shard."""
        idx = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        if tuple(idx.shape) != want:
            raise ValueError(f"{what} must be {want} [{axes}]; got "
                             f"{tuple(idx.shape)}")
        if idx.numel() and (int(idx.min()) < 0
                            or int(idx.max()) >= self.data_x.shape[1]):
            raise ValueError(f"{what} must lie in "
                             f"[0, {self.data_x.shape[1]})")
        return idx

    def _build_plan(self, a: np.ndarray, n_active: int, use_kd: bool,
                    kd_logit_bytes: float) -> Any:
        """This iteration's message plan, memoized on (mask, KD shape):
        within a stable membership every step rebuilds the identical
        plan. A membership change clears the cache."""
        key = (a.tobytes(), use_kd)
        plan = self._plan_cache.get(key)
        if plan is None:
            if len(self._plan_cache) >= 8:
                self._plan_cache.clear()
            plan = self.pipeline.message_plan(
                a, self.model_bytes, n_active, use_kd=use_kd,
                kd_logit_bytes=kd_logit_bytes)
            self._plan_cache[key] = plan
        return plan

    def _kd_logit_bytes(self) -> int:
        # per teacher<->student exchange: logits on B local minibatches
        return (self.cfg.local_batches * self.cfg.batch_size
                * self.spec.num_classes * 4)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self, state: FederationState,
             masks: Optional[Tuple[np.ndarray, np.ndarray]] = None,
             batch_indices: Optional[Any] = None,
             draws: Optional[Dict[str, Any]] = None) -> FederationState:
        """One FL iteration: local updates, MKD (in its first
        ``kd_iterations`` iterations), then aggregation.

        ``masks`` — (U_t, A_t) float masks over peers; from the lifecycle
        when omitted, which may also resize the fleet first.
        ``batch_indices`` — ``[N, local_batches, batch_size]`` int64 rows
        of each peer's shard; drawn from ``state.rng`` when omitted.
        ``draws`` — the step's other random inputs, each drawn from its
        generator when absent: ``"kd_indices"``, ``[N, local_batches *
        batch_size]`` distillation rows (``state.kd_rng``), and
        ``"dp_noise"``, DP's unit normals ``{"delta": [one tensor per
        theta leaf, leaf order], "b": scalar}`` (``state.agg_rng``,
        which also draws the secagg root). N is the fleet size after any
        resize this step makes.
        """
        draws = draws or {}
        with record_function(SPAN_TRANSPORT):
            if masks is not None:
                u, a = masks
            else:
                tick = self.lifecycle.tick(state.iteration)
                if tick.resize_to is not None:
                    # permanent join/leave: one MembershipChange through
                    # the entry point, then run the iteration with the
                    # already-resized masks
                    state = self.apply_membership(
                        state, plan_membership_change(
                            self.plan, tick.resize_to,
                            iteration=state.iteration))
                u, a = tick.u, tick.a
            cfg = self.cfg
            use_kd = cfg.use_kd and state.iteration < cfg.kd_iterations
            kd_lambda = max(0.0, 1.0 - state.iteration
                            / max(cfg.kd_iterations, 1))
            kd_logit_bytes = self._kd_logit_bytes() if use_kd else 0
            u = np.asarray(u, np.float32)
            a = np.asarray(a, np.float32)
            n_active = int(a.sum())
            # run this iteration's traffic *before* aggregating: under
            # loss, peers whose sends were dropped mid-round are demoted
            # to receiver-only (paper §3.1 — they rejoin with the mean).
            # MKD rounds ride the same plan.
            transcript = self.network.run(
                self._build_plan(a, n_active, use_kd, kd_logit_bytes))
            self.last_transcript = transcript
            a = demote_lost_senders(a, u, transcript)
            # the masks cross to the device once per step, not per leaf
            u_t = torch.as_tensor(u, dtype=torch.float32).to(self.device)
            a_t = torch.as_tensor(a, dtype=torch.float32).to(self.device)

        idx = (self._draw_batch_indices(state) if batch_indices is None
               else self._check_indices(
                   batch_indices,
                   (cfg.n_peers, cfg.local_batches, cfg.batch_size),
                   "batch_indices", "peers, local_batches, batch_size"))
        with record_function(SPAN_LOCAL_UPDATE):
            new_p, new_m = self._local_update(state.params, state.momentum,
                                              idx)
            # Alg. 1 line 5: non-participants keep previous state
            keep = lambda new, old: torch.where(  # noqa: E731
                u_t.reshape((-1,) + (1,) * (new.dim() - 1)) > 0, new, old)
            params = tree_map(keep, new_p, state.params)
            momentum = tree_map(keep, new_m, state.momentum)

        if use_kd:
            with record_function(SPAN_MKD):
                want = (cfg.n_peers, cfg.local_batches * cfg.batch_size)
                kd_idx = (self._check_indices(
                    draws["kd_indices"], want, "draws['kd_indices']",
                    "peers, local_batches * batch_size")
                    if "kd_indices" in draws
                    else torch.randint(0, self.data_x.shape[1], want,
                                       generator=state.kd_rng,
                                       device=self.device))
                params, momentum = mkd_rounds(self, params, momentum, a_t,
                                              kd_idx, kd_lambda)

        with record_function(SPAN_AGGREGATE):
            agg_state = {"p": params, "m": momentum}
            given = ({"dp": draws["dp_noise"]} if "dp_noise" in draws
                     else None)
            stage_draws = self.pipeline.draw(agg_state, state.agg_rng,
                                             given)
            out, pipe = self.pipeline(agg_state, state.pipe, a_t,
                                      stage_draws)
            self.pipeline.record_transcript(
                self.ledger, transcript, n_active, self.model_bytes,
                use_kd=use_kd, kd_logit_bytes=kd_logit_bytes)
        return dataclasses.replace(
            state, params=out["p"], momentum=out["m"],
            iteration=state.iteration + 1, pipe=pipe, kd_lambda=kd_lambda)

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _accuracy(self, params: Tree) -> float:
        """Test accuracy of one model (leaves with a peer axis of 1)."""
        logits = self.apply_fn(params, self.test["x"].unsqueeze(0))[0]
        return float((logits.argmax(-1) == self.test["y"]).float().mean())

    def evaluate(self, state: FederationState, peer: int = 0) -> float:
        """Test accuracy of one peer's model (post-aggregation they agree
        under full participation)."""
        return self._accuracy(
            tree_map(lambda x: x[peer:peer + 1], state.params))

    def evaluate_mean_model(self, state: FederationState) -> float:
        return self._accuracy(
            tree_map(lambda x: x.mean(0, keepdim=True), state.params))

    @torch.no_grad()
    def peer_disagreement(self, state: FederationState) -> float:
        """Per-parameter mean squared distance of peers to the global
        mean (Eq. 1 LHS): sum_i ||theta_i - theta-bar||^2 / (N * P)."""
        total, count = 0.0, 0
        for x in tree_leaves(state.params):
            total += float(torch.sum(torch.square(
                x - x.mean(0, keepdim=True))))
            count += x[0].numel()
        return total / max(self.cfg.n_peers * count, 1)


def run_federation(cfg: FederationConfig, iterations: int,
                   eval_every: int = 5, verbose: bool = False,
                   device: Union[None, str, torch.device] = None,
                   lifecycle: Optional[PeerLifecycle] = None,
                   step_seconds: Optional[List[float]] = None
                   ) -> Dict[str, List[float]]:
    """Train and return the (accuracy, comm) history.

    Churn scenarios (``cfg.churn``) and mid-run elastic resizes
    (``cfg.resize_schedule``) run through the peer lifecycle inside
    ``Federation.step``; the history tracks the live peer count and the
    cumulative membership-event count beside the paper's metrics.
    ``step_seconds``, when given, receives each step's wall time (the
    device synchronized after the step).
    """
    fed = Federation(cfg, device=device, lifecycle=lifecycle)
    state = fed.init_state()
    hist: Dict[str, List[Any]] = {
        "iteration": [], "accuracy": [], "comm_bytes": [], "sim_s": [],
        "disagreement": [], "n_peers": [], "events": [], "grid": [],
        "regroups": [], "placements": []}
    for t in range(iterations):
        t0 = time.perf_counter()
        state = fed.step(state)
        if step_seconds is not None:
            if fed.device.type == "cuda":
                torch.cuda.synchronize(fed.device)
            step_seconds.append(time.perf_counter() - t0)
        if (t + 1) % eval_every == 0 or t == iterations - 1:
            acc = fed.evaluate(state)
            hist["iteration"].append(t + 1)
            hist["accuracy"].append(acc)
            hist["comm_bytes"].append(fed.comm_bytes)
            hist["sim_s"].append(fed.sim_seconds)
            hist["disagreement"].append(fed.peer_disagreement(state))
            hist["n_peers"].append(fed.cfg.n_peers)
            hist["events"].append(len(fed.lifecycle.event_log))
            hist["grid"].append(tuple(fed.plan.dims))
            hist["regroups"].append(len(fed.regroup_log))
            hist["placements"].append(len(fed.placement_log))
            if verbose:
                print(f"  it={t+1:4d} acc={acc:.4f} "
                      f"comm={fed.comm_bytes/1e6:.1f}MB "
                      f"sim={fed.sim_seconds:.2f}s "
                      f"peers={fed.cfg.n_peers} "
                      f"grid={fed.plan.dims}")
    return hist
