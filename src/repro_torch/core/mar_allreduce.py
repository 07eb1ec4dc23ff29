"""Moshpit All-Reduce execution, sim backend: group means over the grid.

Peers are stacked on a leading axis ``[N, ...]`` of every tree leaf; one
MAR round is a masked segment mean over that axis grouped by the round's
group key. Supports arbitrary N, per-peer participation masks (churn)
and virtual grid slots (capacity > N).

Churn semantics (paper §3.1): a dropped peer contributes neither to the
numerator nor to the denominator of its group mean, but *receives* the
group mean (it rejoins with the averaged model next iteration). An empty
group keeps its previous state.

Port of the sim half of the JAX package's ``repro/core/mar_allreduce.py``.
``use_kernel`` routes each round through the masked group-mean kernel
(``kernels/group_mean.py``); otherwise ``_segment_mean`` sums each
group's rows (``index_add_`` on the CPU, a grouped sum on the card,
where ``index_add_``'s atomics add in another order on every run). The
device backend (``mar_round_device``) waits for its
own slice (ROADMAP.md, Queue 1 item 11).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.aggregation import finalize_masked_mean
from repro_torch.core.moshpit import GridPlan
from repro_torch.tree import Tree, tree_leaves, tree_map


class RoundIndex(NamedTuple):
    """What round ``rnd`` of a plan fixes, on one device."""
    seg: torch.Tensor       # [cap] each slot's group id
    order: torch.Tensor     # [cap] the slots sorted by group
    inv: torch.Tensor       # [cap] the inverse permutation of ``order``
    partners: torch.Tensor  # [N, M] each peer's group slots, virtual as 0
    real: torch.Tensor      # [N, M] f32: 1 where the slot is another peer


@functools.lru_cache(maxsize=64)
def round_index(plan: GridPlan, rnd: int, device: torch.device
                ) -> RoundIndex:
    """The tables of round ``rnd`` over the grid's capacity, on
    ``device``, for the MAR rounds here, the secure group sums
    (``core/secagg.py``) and MKD's teacher candidates (``core/mkd.py``).

    Built once per (plan, round, device) and kept: the reference built
    them from numpy at trace time, so rebuilding them per leaf per step
    would add host-to-device copies it never paid. GridPlan is frozen
    and hashable; the cache is bounded.
    """
    n = plan.n_peers
    keys = plan.group_key(np.arange(plan.capacity), rnd)
    order = np.argsort(keys, kind="stable")          # [cap] slots by group
    inv = np.argsort(order)
    partners = np.asarray(plan.partner_matrix(rnd))[:n]      # [N, M]
    virtual = partners >= n
    real = ~virtual & (partners != np.arange(n)[:, None])
    as_t = lambda a, dt=torch.int64: torch.as_tensor(a, dtype=dt).to(device)  # noqa: E731
    return RoundIndex(as_t(keys), as_t(order), as_t(inv),
                      as_t(np.where(virtual, 0, partners)),
                      as_t(real, torch.float32))


def _ones_mask(state: Tree) -> torch.Tensor:
    lead = tree_leaves(state)[0]
    return torch.ones(lead.shape[0], dtype=torch.float32, device=lead.device)


def _pad(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with ``rows`` zero rows appended on the peer axis."""
    if rows == 0:
        return x
    return torch.cat([x, x.new_zeros((rows,) + tuple(x.shape[1:]))])


def _group_sums(x: torch.Tensor, order: torch.Tensor,
                num_groups: int) -> torch.Tensor:
    """[num_groups, ...]: the rows of each group summed, the groups'
    rows listed by ``order`` group by group (equal sizes). No atomics:
    the same inputs give the same bits on every run."""
    return x[order].reshape((num_groups, -1) + tuple(x.shape[1:])) \
        .sum(dim=1)


def _segment_mean(x: torch.Tensor, seg_ids: torch.Tensor, num_groups: int,
                  mask: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Masked per-group mean, scattered back to peers.

    x: [N, ...]; seg_ids: [N] int64 group ids; mask: [N] (0/1 float);
    order: [N] the rows group by group, every group the same size, each
    group's rows ascending (``round_index(...).order``). Returns [N, ...]
    where peer i holds mean over its group's active peers (or its own
    value if the whole group dropped).

    Each group's rows add in ascending row order, from zero, in f32. On
    the CPU that is ``index_add_``; on the card ``index_add_`` adds
    through atomics in an order that changes from run to run, so the
    rows are gathered by ``order`` and summed per group instead, which
    is exact from run to run.
    """
    mshape = (-1,) + (1,) * (x.dim() - 1)
    m = mask.reshape(mshape).float()
    xm = x.float() * m
    if x.device.type == "cpu":
        sums = torch.zeros((num_groups,) + tuple(x.shape[1:]),
                           dtype=torch.float32, device=x.device)
        sums.index_add_(0, seg_ids, xm)
        cnts = torch.zeros(num_groups, dtype=torch.float32, device=x.device)
        cnts.index_add_(0, seg_ids, mask.float())
    else:
        sums = _group_sums(xm, order, num_groups)
        cnts = _group_sums(mask.float(), order, num_groups)
    cnt_per_peer = cnts[seg_ids].reshape(mshape)
    return finalize_masked_mean(sums[seg_ids], cnt_per_peer, x).to(x.dtype)


def _kernel_round(state: Tree, plan: GridPlan, rnd: int,
                  mask: torch.Tensor) -> Tree:
    """The group-mean kernel path for one MAR round.

    Flattens each leaf to an ``[N, D]`` view and hands the leaves, the
    round's slot order and the peer mask to the round kernel
    (``kernels/group_mean.py``): one launch per dtype (and per
    ``MAX_LEAVES`` leaves) reads each peer's row by the order and writes
    each peer's row of a fresh output, so there is no padding, no
    gathered copy and no mask gather here. The order lives on the device
    (``round_index``).
    """
    from repro_torch.kernels import group_mean as gm

    n, m = plan.n_peers, plan.dims[rnd]
    order = round_index(plan, rnd, mask.device).order
    mask = mask.float()
    leaves = tree_leaves(state)
    flat = [x.reshape(n, -1).contiguous() for x in leaves]
    out = [None] * len(flat)
    for idx in gm.batches(flat):
        ys = gm.group_mean_round([flat[i] for i in idx], order, mask, m)
        for i, y in zip(idx, ys):
            out[i] = y.reshape(leaves[i].shape)
    it = iter(out)
    return tree_map(lambda _: next(it), state)


def mar_round_sim(state: Tree, plan: GridPlan, rnd: int,
                  mask: Optional[torch.Tensor] = None,
                  use_kernel: bool = False) -> Tree:
    """One MAR round over the leading peer axis (sim backend).

    ``state`` leaves: [N, ...] with N == plan.n_peers. Virtual slots
    (capacity > N) are handled by embedding into capacity internally.
    ``use_kernel`` routes the masked group mean through the group-mean
    kernel (``_segment_mean`` otherwise — identical semantics).
    """
    n, cap = plan.n_peers, plan.capacity
    if mask is None:
        mask = _ones_mask(state)
    if use_kernel:
        return _kernel_round(state, plan, rnd, mask)
    idx = round_index(plan, rnd, mask.device)
    num_groups = cap // plan.dims[rnd]
    # pad with virtual always-dropped slots
    pad_mask = _pad(mask, cap - n)
    return tree_map(
        lambda x: _segment_mean(_pad(x, cap - n), idx.seg, num_groups,
                                pad_mask, idx.order)[:n], state)


def mar_aggregate_sim(state: Tree, plan: GridPlan,
                      mask: Optional[torch.Tensor] = None,
                      num_rounds: Optional[int] = None,
                      use_kernel: bool = False) -> Tree:
    """Full MAR schedule: ``num_rounds`` (default depth) rounds in order.

    With full participation and an exact grid this returns the exact
    global mean in every slot (paper §2.3).
    """
    rounds = plan.depth if num_rounds is None else num_rounds
    for g in range(rounds):
        state = mar_round_sim(state, plan, g % plan.depth, mask,
                              use_kernel=use_kernel)
    return state


def allreduce_all_to_all_sim(state: Tree,
                             mask: Optional[torch.Tensor] = None) -> Tree:
    """AR-FL baseline: every peer averages over all active peers."""
    if mask is None:
        mask = _ones_mask(state)
    seg = torch.zeros(mask.shape[0], dtype=torch.int64, device=mask.device)
    order = torch.arange(mask.shape[0], device=mask.device)
    return tree_map(lambda x: _segment_mean(x, seg, 1, mask, order), state)


def gossip_aggregate_sim(state: Tree, mask: Optional[torch.Tensor] = None,
                         rounds: Optional[int] = None) -> Tree:
    """Push-sum ring gossip with doubling shifts (beyond-paper).

    In round ``r`` every peer averages its (value, weight) pair with the
    peer ``2^r`` positions behind it on a fixed ring; after
    ``ceil(log2 N)`` rounds (the default) each peer's window covers the
    whole ring. For power-of-two N under full participation this is the
    exact global mean; otherwise overlapping windows double-count some
    peers and the push-sum weights turn the result into a consistent
    weighted approximation. A peer whose whole window dropped keeps its
    own state (same churn semantics as MAR).
    """
    if mask is None:
        mask = _ones_mask(state)
    n = mask.shape[0]
    if rounds is None:
        rounds = max(1, int(np.ceil(np.log2(max(n, 2)))))

    w = mask.float()
    for r in range(rounds):
        w = 0.5 * (w + torch.roll(w, 1 << r, dims=0))

    def leaf(x):
        mshape = (-1,) + (1,) * (x.dim() - 1)
        num = x.float() * mask.reshape(mshape)
        for r in range(rounds):
            num = 0.5 * (num + torch.roll(num, 1 << r, dims=0))
        return finalize_masked_mean(num, w.reshape(mshape), x,
                                    floor=1e-12).to(x.dtype)

    return tree_map(leaf, state)


def ring_allreduce_sim(state: Tree,
                       mask: Optional[torch.Tensor] = None) -> Tree:
    """RDFL-style ring: global average via the closed ring.

    RDFL circulates models around a ring so every peer ends with the
    global average; mathematically the fixed point equals the all-to-all
    mean, so this reuses the masked global mean. Its *cost* model lives
    in ``topology.py``.
    """
    return allreduce_all_to_all_sim(state, mask)
