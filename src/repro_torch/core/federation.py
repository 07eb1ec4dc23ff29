"""The MAR-FL training loop (Alg. 1) and its baselines (sim backend).

Port of the JAX package's ``repro/core/federation.py``. Peers are the
leading axis of every state leaf; the local update is damped momentum
SGD over all peers at once; aggregation runs through the
:class:`~repro_torch.core.aggregation.AggregationPipeline`, whose
technique picks the aggregator from the registry — ``mar`` (the paper),
``fedavg``, ``rdfl``, ``ar``, plus beyond-paper ``gossip`` and
``hierarchical``.

Partial participation and dropout follow §3.1: U_t peers run local
updates; A_t = U_t minus dropouts joins aggregation; non-participants
carry state forward (Alg. 1 line 5). Both masks come from the
:class:`~repro_torch.runtime.lifecycle.PeerLifecycle`. Every step
unrolls the aggregation into a message plan and runs it through the
``"sim"`` transport; the transcript feeds the ledger, and lost sends
demote their peer to receiver-only for the iteration.

Where the reference draws from ``jax.random`` keys, the port draws from
``torch.Generator``s with the same seeds: the initial parameters from
``cfg.seed`` and the minibatch indices from ``cfg.seed + 7``. The
values differ from the reference's; ``Federation.init_state(params=)``
and ``Federation.step(batch_indices=)`` take the reference's own so the
two packages can be run step for step. Everything numpy-seeded (data,
partition, masks, links, the ledger) is bit-identical.

The reference's extensions wait for later slices; the config fields
that select them raise ``NotImplementedError`` naming the ROADMAP.md
item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import topology
from repro_torch.core.aggregation import (TECHNIQUES, AggregationPipeline,
                                          CommLedger, build_pipeline)
from repro_torch.core.moshpit import GridPlan, plan_grid
from repro_torch.data.partition import dirichlet_partition, iid_partition
from repro_torch.data.synthetic import classification_task
from repro_torch.models.small import build_peer_model
from repro_torch.optim.sgdm import momentum_sgd_init, momentum_sgd_step
from repro_torch.runtime.lifecycle import PeerLifecycle, build_lifecycle
from repro_torch.runtime.transport_base import (UNPORTED_TRANSPORTS,
                                                build_transport,
                                                demote_lost_senders)
from repro_torch.tree import Tree, tree_leaves, tree_map

#: ``torch.profiler`` labels of the three layers one ``Federation.step``
#: runs: transport (lifecycle tick, message plan, network sim, masks to
#: the device), local update (SGD steps and the participation select),
#: aggregation (the pipeline and the ledger). Only a profiler reads them.
SPAN_TRANSPORT = "federation.transport"
SPAN_LOCAL_UPDATE = "federation.local_update"
SPAN_AGGREGATE = "federation.aggregate"

#: (field, value that means "off", ROADMAP.md item that ports it)
_UNPORTED_FIELDS = (
    ("use_kd", False, "Queue 1 item 6 (MKD)"),
    ("use_dp", False, "Queue 1 item 7 (wire stages)"),
    ("use_secagg", False, "Queue 1 item 7 (wire stages)"),
    ("async_aggregation", False, "Queue 1 item 7 (wire stages)"),
    ("compress", None, "Queue 1 item 7 (wire stages)"),
    ("resize_schedule", (), "Queue 1 item 8 (elastic membership)"),
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
    # kernel (kernels/group_mean.py) instead of index_add_ segment sums;
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
        self.pipeline: AggregationPipeline = build_pipeline(
            cfg.technique, self.plan, num_rounds=cfg.mar_rounds,
            use_kernel=cfg.kernel_group_mean)
        self.ledger = CommLedger()
        self.network = build_transport(cfg.transport, cfg.n_peers,
                                       profile=cfg.link_profile,
                                       seed=cfg.seed,
                                       link_params=cfg.link_params)
        self.last_transcript = None
        # message plans by aggregation mask: identical steps reuse them
        self._plan_cache: Dict[bytes, Any] = {}
        self.lifecycle = lifecycle if lifecycle is not None else \
            build_lifecycle(cfg.churn, cfg.n_peers, seed=cfg.seed,
                            participation_rate=cfg.participation_rate,
                            dropout_rate=cfg.dropout_rate,
                            churn_params=cfg.churn_params)
        spec, train, test = classification_task(cfg.task, seed=cfg.seed)
        self.spec = spec
        self._train = train
        self.test = {"x": torch.as_tensor(test["x"], device=self.device),
                     "y": torch.as_tensor(test["y"], dtype=torch.int64,
                                          device=self.device)}
        self.init_fn, self.apply_fn = build_peer_model(
            cfg.task, spec.feature_dim, spec.num_classes)

        # --- federated partition (rectangular per-peer arrays) ----------
        xs, ys = self._peer_shards()
        self.data_x = torch.as_tensor(np.stack(xs), device=self.device)
        self.data_y = torch.as_tensor(np.stack(ys), dtype=torch.int64,
                                      device=self.device)   # [N, P]
        self._peer_rows = torch.arange(cfg.n_peers,
                                       device=self.device)[:, None]

        self.model_bytes = topology.pytree_bytes(
            self.init_fn(torch.Generator().manual_seed(0))) * 2  # theta + m

    def _peer_shards(self):
        """Each peer's data rows out of an ``n_peers``-way partition of
        the training set (deterministic in cfg.seed), subsampled to one
        rectangular size."""
        cfg = self.cfg
        if cfg.alpha is None:
            shards = iid_partition(len(self._train["y"]), cfg.n_peers,
                                   seed=cfg.seed)
        else:
            shards = dirichlet_partition(self._train["y"], cfg.n_peers,
                                         alpha=cfg.alpha, seed=cfg.seed)
        rng = np.random.default_rng(cfg.seed + 1)
        per_peer = max(cfg.batch_size,
                       int(np.median([len(s) for s in shards])))
        xs, ys = [], []
        for s in shards:
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
        rng = torch.Generator(device=self.device)
        rng.manual_seed(self.cfg.seed + 7)
        return FederationState(params=stacked,
                               momentum=momentum_sgd_init(stacked),
                               iteration=0, rng=rng)

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

    def _check_batch_indices(self, batch_indices: Any) -> torch.Tensor:
        cfg = self.cfg
        idx = torch.as_tensor(batch_indices, dtype=torch.int64,
                              device=self.device)
        want = (cfg.n_peers, cfg.local_batches, cfg.batch_size)
        if tuple(idx.shape) != want:
            raise ValueError(f"batch_indices must be {want} "
                             f"[peers, local_batches, batch_size]; got "
                             f"{tuple(idx.shape)}")
        if idx.numel() and (int(idx.min()) < 0
                            or int(idx.max()) >= self.data_x.shape[1]):
            raise ValueError(f"batch_indices must lie in "
                             f"[0, {self.data_x.shape[1]})")
        return idx

    def _build_plan(self, a: np.ndarray) -> Any:
        """This iteration's message plan, memoized on the mask: within a
        stable membership every step rebuilds the identical plan."""
        key = a.tobytes()
        plan = self._plan_cache.get(key)
        if plan is None:
            if len(self._plan_cache) >= 8:
                self._plan_cache.clear()
            plan = self.pipeline.message_plan(a, self.model_bytes)
            self._plan_cache[key] = plan
        return plan

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self, state: FederationState,
             masks: Optional[Tuple[np.ndarray, np.ndarray]] = None,
             batch_indices: Optional[Any] = None) -> FederationState:
        """One FL iteration: local updates, then aggregation.

        ``masks`` — (U_t, A_t) float masks over peers; from the lifecycle
        when omitted. ``batch_indices`` — ``[N, local_batches,
        batch_size]`` int64 rows of each peer's shard; drawn from
        ``state.rng`` when omitted.
        """
        idx = (self._draw_batch_indices(state) if batch_indices is None
               else self._check_batch_indices(batch_indices))
        with record_function(SPAN_TRANSPORT):
            if masks is not None:
                u, a = masks
            else:
                tick = self.lifecycle.tick(state.iteration)
                if tick.resize_to is not None:
                    raise NotImplementedError(
                        f"the lifecycle asked to resize the fleet to "
                        f"{tick.resize_to} peers at iteration "
                        f"{state.iteration}; elastic membership is not "
                        f"ported yet (ROADMAP.md, Queue 1 item 8)")
                u, a = tick.u, tick.a
            u = np.asarray(u, np.float32)
            a = np.asarray(a, np.float32)
            # run this iteration's traffic *before* aggregating: under
            # loss, peers whose sends were dropped mid-round are demoted
            # to receiver-only (paper §3.1 — they rejoin with the mean)
            transcript = self.network.run(self._build_plan(a))
            self.last_transcript = transcript
            a = demote_lost_senders(a, u, transcript)
            # the masks cross to the device once per step, not per leaf
            u_t = torch.as_tensor(u, dtype=torch.float32).to(self.device)
            a_t = torch.as_tensor(a, dtype=torch.float32).to(self.device)

        with record_function(SPAN_LOCAL_UPDATE):
            new_p, new_m = self._local_update(state.params, state.momentum,
                                              idx)
            # Alg. 1 line 5: non-participants keep previous state
            keep = lambda new, old: torch.where(  # noqa: E731
                u_t.reshape((-1,) + (1,) * (new.dim() - 1)) > 0, new, old)
            params = tree_map(keep, new_p, state.params)
            momentum = tree_map(keep, new_m, state.momentum)

        with record_function(SPAN_AGGREGATE):
            out = self.pipeline({"p": params, "m": momentum}, a_t)
            self.pipeline.record_transcript(self.ledger, transcript)
        return FederationState(params=out["p"], momentum=out["m"],
                               iteration=state.iteration + 1, rng=state.rng)

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
                   lifecycle: Optional[PeerLifecycle] = None
                   ) -> Dict[str, List[float]]:
    """Train and return the (accuracy, comm) history."""
    fed = Federation(cfg, device=device, lifecycle=lifecycle)
    state = fed.init_state()
    hist: Dict[str, List[Any]] = {
        "iteration": [], "accuracy": [], "comm_bytes": [], "sim_s": [],
        "disagreement": [], "n_peers": [], "events": [], "grid": []}
    for t in range(iterations):
        state = fed.step(state)
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
            if verbose:
                print(f"  it={t+1:4d} acc={acc:.4f} "
                      f"comm={fed.comm_bytes/1e6:.1f}MB "
                      f"sim={fed.sim_seconds:.2f}s "
                      f"peers={fed.cfg.n_peers} "
                      f"grid={fed.plan.dims}")
    return hist
