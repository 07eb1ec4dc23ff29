"""Device-backend MAR-FL: the paper's protocol on the LM architectures,
every peer stacked on one card.

Port of the JAX package's ``repro/core/fl_device.py``: every state leaf
carries a leading peer axis ``[P, ...]``, and each MAR round is a
masked mean over one axis of the grid reshape
(``core/mar_allreduce.mar_round_device``). The state may lie on one
card as plain tensors, or on a device mesh as DTensors laid out by
``runtime/sharding.py``: the peer dim sharded over the peer mesh axes
(a contiguous block of peers a rank), the other dims over the TP and
FSDP axes. On a mesh each rank runs the local update of its own peers
on its own shards: a peer's TP/FSDP-sharded leaves are gathered when
the loss uses them, and the rank writes back only its shard of theta
and m. The MAR rounds then cross ranks only on the grid axes the peer
mesh axes carry, and the ``loss`` metric is all-reduced to the mean
over all peers.

One FL iteration (Alg. 1, device form):

  1. ``local_steps`` Momentum-SGD steps per peer, each accumulating
     f32 gradients over ``n_micro`` microbatches. The peers run one
     after another, each reading and writing its own slice of the
     stacked leaves (the reference's ``vmap`` in value): one peer's
     gradients are alive at a time.
  2. Aggregation of (theta, m) through the same composable
     :class:`~repro_torch.core.aggregation.AggregationPipeline` as the
     sim backend: device MAR (``one_shot`` fuses the rounds into one
     global mean), optionally wrapped in wire stages (int8 EF, DP,
     async), with participation masks for churn.

The one departure from the reference: ``fl_train_step`` updates the
state in place (the local update writes each peer's slice, the device
aggregator writes each leaf) and returns it. The reference's functional
step holds the old and the new state together; at full width
(musicgen-medium, 4 peers: 14.5 GB of bf16 theta and 29.1 GB of f32
momentum) that would not fit on an 80 GB card. The two halves of the
step carry ``torch.profiler`` labels, ``train.local_update`` and
``train.aggregate``.

``make_serve_step``, ``make_prefill_step`` and ``make_paged_serve_step``
cover the inference shapes (no aggregation — MAR is a training-time
protocol).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch.core import mar_allreduce as mar
from repro_torch.core.aggregation import AggregationPipeline, MarAggregator
from repro_torch.core.moshpit import GridPlan
from repro_torch.core.replan import (MembershipChange, resize_peer_axis,
                                     select_survivors)
from repro_torch.models.model import Device, Model, resolve_device
from repro_torch.optim.sgdm import momentum_sgd_step
from repro_torch.tree import Tree, tree_leaves, tree_map, tree_unflatten

#: profiler labels of the two halves of ``fl_train_step``
SPAN_LOCAL = "train.local_update"
SPAN_AGGREGATE = "train.aggregate"


def init_fl_state(model: Model, n_peers: int, seed: int = 0,
                  device: Device = None,
                  pipeline: Optional[AggregationPipeline] = None,
                  params: Optional[Tree] = None) -> Dict[str, Any]:
    """Peer-stacked (params, momentum) — every peer starts from the same
    theta^0 (Alg. 1), materialized per peer, with f32 momentum and a
    step counter. ``params`` injects theta^0 (e.g. the reference's,
    through ``repro_torch.convert``), else ``model.init(seed)``. With a
    ``pipeline``, its wire-stage state (EF residuals etc.) is
    initialized under ``"pipe"``."""
    if params is None:
        dev = resolve_device(device)
        params = model.init(seed, device=dev)
    else:
        dev = (tree_leaves(params)[0].device if device is None
               else torch.device(device))
        params = tree_map(lambda x: x.to(dev), params)
    params = tree_map(
        lambda x: x.unsqueeze(0).repeat(n_peers, *([1] * x.dim())), params)
    momentum = tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=dev),
        params)
    state = {"params": params, "momentum": momentum,
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if pipeline is not None:
        state["pipe"] = pipeline.init_state({"p": params, "m": momentum})
    return state


def _n_peers(state: Dict[str, Any]) -> int:
    return tree_leaves(state["params"])[0].shape[0]


def resize_fl_state(state: Dict[str, Any], new_n: int,
                    pipeline: Optional[AggregationPipeline] = None
                    ) -> Dict[str, Any]:
    """Elastic membership for the FL state dict: shrink or grow the
    stacked peer axis of params and momentum (and, through the
    pipeline's per-stage hooks, the wire-stage state under ``"pipe"``).
    Survivors are bit-exact, joiners bootstrap from the group mean. The
    caller re-plans the grid and rebuilds the train step."""
    old_n = _n_peers(state)
    if new_n == old_n:
        return state
    out = dict(state)
    out["params"] = resize_peer_axis(state["params"], old_n, new_n)
    out["momentum"] = resize_peer_axis(state["momentum"], old_n, new_n)
    if "pipe" in state:
        if pipeline is not None:
            out["pipe"] = pipeline.resize_state(state["pipe"], old_n, new_n)
        else:
            out["pipe"] = resize_peer_axis(state["pipe"], old_n, new_n)
    return out


def apply_membership(state: Dict[str, Any], change: MembershipChange,
                     pipeline: Optional[AggregationPipeline] = None
                     ) -> Tuple[Dict[str, Any],
                                Optional[AggregationPipeline]]:
    """Apply one :class:`~repro_torch.core.replan.MembershipChange` to
    the FL state dict and re-bind the pipeline to ``change.new_plan``.

    Survivors' params, momentum and pipe state map through the change
    bit-exact; joiners bootstrap from the group mean, with the
    per-``WireStage`` zero rules for wire state (EF residuals, DP bot
    markers). Returns ``(state, pipeline)``; the caller rebuilds the
    train step for ``change.new_plan`` (the device aggregator needs an
    exact grid: plan the change with ``exact_only=True``).
    """
    old_n = _n_peers(state)
    if old_n != change.old_n:
        raise ValueError(f"change was planned for {change.old_n} "
                         f"peers, state has {old_n}")
    new_pipeline = pipeline.with_plan(change.new_plan) \
        if pipeline is not None else None
    if change.same_n:
        return dict(state), new_pipeline
    k = len(change.survivors)
    out = dict(state)
    out["params"] = change.apply_to_tree(state["params"])
    out["momentum"] = change.apply_to_tree(state["momentum"])
    if "pipe" in state:
        # survivor gather is a pure reindex; the joiner bootstrap
        # routes through the per-stage hooks
        pipe = select_survivors(state["pipe"], old_n, change.survivors)
        if pipeline is not None:
            out["pipe"] = pipeline.resize_state(pipe, k, change.new_n)
        else:
            out["pipe"] = resize_peer_axis(pipe, k, change.new_n)
    return out, new_pipeline


def fl_state_shape(model: Model, n_peers: int,
                   momentum_dtype: torch.dtype = torch.float32
                   ) -> Dict[str, Any]:
    """The FL state's leaves as tensors on the ``meta`` device: shapes
    and dtypes without allocating (the reference returns
    ShapeDtypeStructs)."""
    params = tree_map(
        lambda x: torch.empty((n_peers, *x.shape), dtype=x.dtype,
                              device="meta"), model.init_shape())
    mom = tree_map(lambda p: torch.empty(p.shape, dtype=momentum_dtype,
                                         device="meta"), params)
    return {"params": params, "momentum": mom,
            "step": torch.empty((), dtype=torch.int32, device="meta")}


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def make_fl_train_step(model: Model, grid: GridPlan, lr: float = 0.1,
                       mu: float = 0.9, one_shot: bool = False,
                       aggregate: bool = True,
                       comm_dtype: Optional[str] = None,
                       pipeline: Optional[AggregationPipeline] = None
                       ) -> Callable:
    """Returns ``fl_train_step(state, batch, mask=None, agg_mask=None,
    generator=None) -> (state, metrics)``; ``state`` is updated in place
    and returned.

    batch: {"tokens": [P, B, n_micro, mb, s], "labels": ..., optional
    "prefix_embeds" and "loss_mask"} — P peers, B local steps,
    grad-accumulated microbatches; it may lie on the CPU (each peer's
    slice moves to the state's device).

    ``pipeline`` runs the same composable aggregation as the sim backend
    (device MAR plus wire stages, e.g. ``int8_ef``); without one, a
    plain device-MAR pipeline is built from ``one_shot`` /
    ``comm_dtype``. ``mask`` ([P] 0/1 float) is the participation mask
    U_t: masked peers keep their previous state (their local update is
    computed for the loss metric, as in the reference, and dropped),
    contribute nothing to their group means, but receive them.
    ``agg_mask`` (default: ``mask``) is the aggregation mask A_t — peers
    in U_t but not A_t keep their local update yet miss aggregation.
    ``generator`` feeds the wire stages' draws (DP noise); by default a
    generator seeded with the step, where the reference hands the stages
    ``fold_in(PRNGKey(0), step)``. The metric ``loss`` is the mean over
    peers of each peer's mean over its local steps.
    """
    if pipeline is None and aggregate:
        pipeline = AggregationPipeline(MarAggregator(
            grid, backend="device", one_shot=one_shot,
            comm_dtype=comm_dtype))

    def peer_local_update(p: List[torch.Tensor], m: List[torch.Tensor],
                          like: Tree, peer_batch: Dict[str, torch.Tensor],
                          shards: Optional[List["_LeafShards"]] = None
                          ) -> torch.Tensor:
        """One peer: B sequential Momentum-SGD steps, writing ``p`` and
        ``m`` in place. Returns the mean loss over the steps. With
        ``shards`` (a sharded state), ``p`` and ``m`` are this rank's
        shards: the loss reads the gathered leaves, and each update
        takes this rank's part of the gradient."""
        n_steps, n_micro = peer_batch["tokens"].shape[:2]
        dev = p[0].device
        losses = []
        for b in range(n_steps):
            gsum: List[Optional[torch.Tensor]] = [None] * len(p)
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            # the peer's whole leaves, gathered once a local step
            full = p if shards is None else [
                s.full(x) for s, x in zip(shards, p)]
            for u in range(n_micro):
                mb = {k: v[b, u].to(dev) for k, v in peer_batch.items()}
                leaves = [x.detach().requires_grad_() for x in full]
                loss = model.loss(tree_unflatten(like, leaves), mb)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                del leaves
                for j, g in enumerate(grads):
                    if g is None:        # unused (e.g. frontend_norm
                        continue         # without prefix embeddings): 0
                    if shards is not None:
                        g = shards[j].own(g)
                    gsum[j] = g.float() if gsum[j] is None else gsum[j] + g
                del grads
                lsum = lsum + loss.detach().float()
            del full
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            for j, (pj, mj) in enumerate(zip(p, m)):
                g = zero if gsum[j] is None else gsum[j] / n_micro
                gsum[j] = None
                new_p, new_m = momentum_sgd_step(pj, mj, g, lr, mu)
                pj.copy_(new_p)
                mj.copy_(new_m)
                del new_p, new_m, g
            losses.append(lsum / n_micro)
        return torch.stack(losses).mean()

    def fl_train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor],
                      mask: Optional[torch.Tensor] = None,
                      agg_mask: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        params, momentum = state["params"], state["momentum"]
        p_leaves, m_leaves = tree_leaves(params), tree_leaves(momentum)
        n, dev = p_leaves[0].shape[0], p_leaves[0].device
        keep = ([True] * n if mask is None
                else (torch.as_tensor(mask) > 0).tolist())
        sharded = mar.is_sharded(p_leaves[0])
        if sharded and aggregate and pipeline.stages:
            raise ValueError("wire stages run on a state on one card; a "
                             "sharded state aggregates through plain MAR")
        if sharded:
            # this rank's peers, on its shards of their leaves
            lay = mar.state_layout(p_leaves + m_leaves)
            shards = [_LeafShards(x) for x in p_leaves]
            p_loc = [x.to_local() for x in p_leaves]
            m_loc = [x.to_local() for x in m_leaves]
            first, n_local, like = lay.first, lay.n_local, params
        else:
            shards, p_loc, m_loc, first, n_local = None, p_leaves, \
                m_leaves, 0, n
            like = tree_map(lambda x: x[0], params)
        peer_losses = []
        with record_function(SPAN_LOCAL):
            for i in range(n_local):
                p_i = [x[i] for x in p_loc]
                m_i = [x[i] for x in m_loc]
                if not keep[first + i]:
                    # U_t = 0: computed for the loss metric, then dropped
                    p_i = [x.clone() for x in p_i]
                    m_i = [x.clone() for x in m_i]
                peer_batch = {k: v[first + i] for k, v in batch.items()}
                peer_losses.append(
                    peer_local_update(p_i, m_i, like, peer_batch, shards))
                del p_i, m_i
        state["step"] = state["step"] + 1
        if aggregate:
            if pipeline.stages and "pipe" not in state:
                raise ValueError(
                    "pipeline has wire stages; build the state with "
                    "init_fl_state(..., pipeline=pipeline)")
            with record_function(SPAN_AGGREGATE), torch.no_grad():
                a = agg_mask if agg_mask is not None else mask
                a = (torch.ones(grid.capacity, dtype=torch.float32,
                                device=dev) if a is None
                     else torch.as_tensor(a).to(dev, torch.float32))
                gen = generator
                if gen is None and pipeline.stages:
                    gen = torch.Generator(device=dev).manual_seed(
                        int(state["step"]) - 1)
                agg_state = {"p": params, "m": momentum}
                draws = pipeline.draw(agg_state, gen)
                out, pipe = pipeline(agg_state, state.get("pipe", {}), a,
                                     draws)
                for dst, src in zip(p_leaves + m_leaves,
                                    tree_leaves(out["p"])
                                    + tree_leaves(out["m"])):
                    if src is not dst:
                        dst.copy_(src)
                del out
                if "pipe" in state:
                    state["pipe"] = pipe
        if sharded:
            return state, {"loss": _mean_over_peers(peer_losses, lay)}
        return state, {"loss": torch.stack(peer_losses).mean()}

    return fl_train_step


class _LeafShards:
    """One peer's slice of a DTensor leaf: how to gather the full tensor
    from this rank's shard over the non-peer mesh dims, and which part
    of a full-size tensor is this rank's shard."""

    def __init__(self, x):
        from torch.distributed.tensor import Shard
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset

        mesh = x.device_mesh
        names = mesh.mesh_dim_names
        rest = [i for i, pl in enumerate(x.placements)
                if not (isinstance(pl, Shard) and pl.dim == 0)]
        self.shape = tuple(x.shape[1:])
        self.stride = torch.empty(self.shape, device="meta").stride()
        self.placements = [Shard(pl.dim - 1) if isinstance(pl, Shard)
                           else pl for pl in (x.placements[i]
                                              for i in rest)]
        self.split = any(isinstance(pl, Shard) for pl in self.placements)
        self.slices = []
        if self.split:
            if names is None:
                raise ValueError("a leaf sharded inside a peer needs a "
                                 "mesh with named dims")
            self.mesh = mesh[tuple(names[i] for i in rest)]
            local, offset = compute_local_shape_and_global_offset(
                self.shape, self.mesh, self.placements)
            self.slices = [(d, o, n) for d, (o, n, full) in
                           enumerate(zip(offset, local, self.shape))
                           if n != full]

    def full(self, shard: torch.Tensor) -> torch.Tensor:
        """The peer's whole leaf from this rank's ``shard`` of it."""
        if not self.split:
            return shard
        from torch.distributed.tensor import DTensor

        with torch.no_grad():
            return DTensor.from_local(
                shard, self.mesh, self.placements, run_check=False,
                shape=self.shape, stride=self.stride).full_tensor()

    def own(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a full-size tensor of the leaf's shape."""
        for d, o, n in self.slices:
            full = full.narrow(d, o, n)
        return full


def _mean_over_peers(peer_losses, lay) -> torch.Tensor:
    """Mean over all P peers of the per-peer losses, from this rank's
    own peers: one all_reduce over the peer ranks."""
    import torch.distributed as dist

    total = torch.stack(peer_losses).sum()
    group = mar.peer_group(lay, (lay.n_peers,), 0)
    if group is not None:
        dist.all_reduce(total, group=group)
    return total / lay.n_peers


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def make_serve_step(model: Model) -> Callable:
    """One greedy decode step over a request batch (no aggregation)."""

    @torch.no_grad()
    def serve_step(params, cache, token):
        logits, cache = model.decode_step(params, cache, token)
        return logits.argmax(dim=-1).to(torch.int32), cache

    return serve_step


def make_prefill_step(model: Model, max_len: Optional[int] = None
                      ) -> Callable:
    """Prefill: forward over the full prompt, emit last-token logits and
    the populated cache (single pass; see transformer.forward).

    With ``max_len`` the cache is returned *decode-ready* — converted to
    the exact ``init_cache(cfg, b, max_len)`` layout via
    ``prefill_cache_to_decode`` — so ``serve_step`` continues from
    position ``s`` directly, with no token-by-token prompt replay."""

    @torch.no_grad()
    def prefill_step(params, batch):
        tokens = batch["tokens"]
        logits, _, cache = model.forward(
            params, tokens, prefix_embeds=batch.get("prefix_embeds"),
            collect_cache=True)
        if max_len is not None:
            cache = model.prefill_cache_to_decode(cache, max_len,
                                                  tokens.shape[1])
        return logits[:, -1], cache

    return prefill_step


def make_paged_serve_step(model: Model) -> Callable:
    """One greedy decode step over the paged serving pool.

    ``paged_serve_step(params, pages, block_tables, pos, token) ->
    (next_token, logits, pages)`` — logits are exposed so the engine can
    apply per-session sampling and stops host-side."""

    @torch.no_grad()
    def paged_serve_step(params, pages, block_tables, pos, token):
        logits, pages = model.paged_decode_step(params, pages, block_tables,
                                                pos, token)
        return logits.argmax(dim=-1).to(torch.int32), logits, pages

    return paged_serve_step
