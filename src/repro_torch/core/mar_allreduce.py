"""Moshpit All-Reduce execution: group means over the grid.

Peers are stacked on a leading axis ``[N, ...]`` of every tree leaf; one
MAR round is a masked mean over that axis within the round's groups.

* sim backend (``mar_round_sim``): a masked segment mean grouped by the
  round's group key; arbitrary N, per-peer participation masks (churn)
  and virtual grid slots (capacity > N).
* device backend (``mar_round_device``): the reference's grid reshape
  ``[P, ...] -> [*dims, ...]`` and a masked mean over the round's axis,
  for exact grids (capacity == N). It writes each leaf in place, one
  block of columns at a time, so only one block's temporaries are
  alive: at full width the old and new state would not fit together.
  ``comm_dtype`` sets the dtype of the cross-peer sum (the wire
  format); ``one_shot`` is one global masked mean. When the leaves are
  DTensors whose peer dim is sharded over mesh dims (the peers spread
  over ranks, a contiguous block of peers a rank), a round takes each
  rank's masked partial sums over its own peers, then one
  ``all_reduce(SUM)`` per bucket of blocks over the ranks whose grid
  coordinates differ only on the round's axis (the rank grid's mesh
  dim, ``peer_group``); a grid axis that lies inside one rank issues no
  collective. The counts come from the replicated mask, so only the
  sums cross. On one rank this is the single-card backend, bit for bit.

Churn semantics (paper §3.1): a dropped peer contributes neither to the
numerator nor to the denominator of its group mean, but *receives* the
group mean (it rejoins with the averaged model next iteration). An empty
group keeps its previous state.

Port of the JAX package's ``repro/core/mar_allreduce.py``. On the sim
backend ``use_kernel`` routes each round through the masked group-mean
kernel (``kernels/group_mean.py``); otherwise ``_segment_mean`` sums
each group's rows (``index_add_`` on the CPU, a grouped sum on the
card, where ``index_add_``'s atomics add in another order on every
run). The device backend is the reference's reshape mean, which is no
Pallas kernel there and no kernel here.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.aggregation import finalize_masked_mean
from repro_torch.core.moshpit import GridPlan
from repro_torch.tree import Tree, tree_leaves, tree_map, tree_unflatten


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
    return tree_unflatten(state, out)


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


# ---------------------------------------------------------------------------
# device backend (every peer on one card, exact grids)
# ---------------------------------------------------------------------------

#: elements (over all peers) of one column block of the device backend:
#: 256 MB in f32, so a block's temporaries stay near 1 GB
DEVICE_BLOCK_ELEMS = 1 << 26


def _acc_dtype(comm_dtype) -> torch.dtype:
    if comm_dtype is None:
        return torch.float32
    if isinstance(comm_dtype, torch.dtype):
        return comm_dtype
    return getattr(torch, str(comm_dtype))


def _grid_reshape_mean(x: torch.Tensor, dims: Sequence[int], axis: int,
                       mask: torch.Tensor, comm_dtype=None) -> torch.Tensor:
    """Masked mean over grid axis ``axis`` of the leading peer dim; a
    fresh ``[P, ...]`` tensor in x's dtype.

    ``comm_dtype`` (e.g. bf16) sets the dtype of the cross-peer sum —
    the collective's wire format. The group mean still divides in f32.
    """
    grid = tuple(dims)
    acc = _acc_dtype(comm_dtype)
    xg = x.reshape(grid + tuple(x.shape[1:]))
    mg = mask.reshape(grid + (1,) * (x.dim() - 1))
    num = (xg.to(acc) * mg.to(acc)).sum(dim=axis, keepdim=True).float()
    den = mg.float().sum(dim=axis, keepdim=True)
    # keepdims mean + the full-shape own value: every group member
    # receives the mean
    out = finalize_masked_mean(num, den, xg)
    return out.to(x.dtype).reshape(x.shape)


def _blocks(x: torch.Tensor) -> List[torch.Tensor]:
    """``x`` ([L, ...], contiguous) as column blocks of its ``[L, -1]``
    view, each at most ``DEVICE_BLOCK_ELEMS`` elements."""
    flat = x.view(x.shape[0], -1)
    cols = max(1, DEVICE_BLOCK_ELEMS // x.shape[0])
    return [flat[:, c0:c0 + cols] for c0 in range(0, flat.shape[1], cols)]


def _mean_into_(x: torch.Tensor, dims: Sequence[int], axis: int,
                mask: torch.Tensor, comm_dtype) -> None:
    """Write :func:`_grid_reshape_mean` of ``x`` into ``x``, one block of
    columns at a time (the mean is columnwise, so the blocks are
    independent)."""
    if not x.is_contiguous() or x.dim() < 2:
        x.copy_(_grid_reshape_mean(x, dims, axis, mask, comm_dtype))
        return
    for blk in _blocks(x):
        blk.copy_(_grid_reshape_mean(blk, dims, axis, mask, comm_dtype))


# ---------------------------------------------------------------------------
# device backend over ranks (DTensor leaves, the peer dim sharded)
# ---------------------------------------------------------------------------

class PeerLayout(NamedTuple):
    """How a DTensor leaf spreads its peer dim (dim 0) over ranks."""
    mesh: object                 # the leaf's DeviceMesh
    peer_dims: Tuple[int, ...]   # mesh dims that shard dim 0, in order
    n_peers: int                 # P, the global peer count
    n_local: int                 # peers on this rank (a contiguous block)
    first: int                   # global index of this rank's first peer


def is_sharded(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def peer_layout(x) -> PeerLayout:
    """The peer layout of DTensor ``x``: its peer dim is split evenly
    over the mesh dims that place ``Shard(0)``, major to minor."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh = x.device_mesh
    peer_dims = tuple(i for i, pl in enumerate(x.placements)
                      if isinstance(pl, Shard) and pl.dim == 0)
    ranks = int(np.prod([mesh.size(i) for i in peer_dims]))
    n = x.shape[0]
    if n % ranks:
        raise ValueError(f"{n} peers do not split evenly over {ranks} "
                         f"ranks")
    local, offset = compute_local_shape_and_global_offset(
        tuple(x.shape), mesh, list(x.placements))
    return PeerLayout(mesh, peer_dims, n, local[0], offset[0])


def state_layout(leaves) -> PeerLayout:
    """The one peer layout every leaf of a sharded state shares."""
    lay = peer_layout(leaves[0])
    for x in leaves[1:]:
        other = peer_layout(x)
        if other.mesh is not lay.mesh and other.mesh != lay.mesh \
                or other[1:] != lay[1:]:
            raise ValueError("the state's leaves spread their peers over "
                             "ranks in different ways")
    return lay


def split_grid(dims: Sequence[int], n_local: int
               ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(local_dims, rank_dims) with ``dims[a] == local_dims[a] *
    rank_dims[a]``: a rank's contiguous block of ``n_local`` peers (row
    major over ``dims``) is a full sub-grid of the trailing axes, split
    on at most one axis; ranks are row major over ``rank_dims``."""
    local = [1] * len(dims)
    rest = n_local
    for a in range(len(dims) - 1, -1, -1):
        if rest == 1:
            break
        if rest >= dims[a]:
            if rest % dims[a]:
                raise ValueError(f"{n_local} peers a rank do not tile the "
                                 f"grid {tuple(dims)}")
            local[a] = dims[a]
            rest //= dims[a]
        else:
            if dims[a] % rest:
                raise ValueError(f"{n_local} peers a rank do not tile the "
                                 f"grid {tuple(dims)}")
            local[a] = rest
            rest = 1
    return tuple(local), tuple(d // m for d, m in zip(dims, local))


_RANK_MESHES = "_mar_rank_meshes"


def peer_group(lay: PeerLayout, dims: Sequence[int], axis: int):
    """The process group of the ranks whose coordinates on the rank grid
    of ``dims`` differ only on ``axis`` (and that hold the same shard of
    the non-peer mesh dims); None when the axis lies inside one rank.

    The ranks are laid out as a ``DeviceMesh`` of shape (non-peer ranks,
    *rank grid axes of size > 1*), whose mesh dims are exactly the
    rounds' groups; it is built once per (mesh, grid) and kept on the
    state's mesh, whose lifetime it shares."""
    from torch.distributed.device_mesh import DeviceMesh

    _, rank_dims = split_grid(dims, lay.n_local)
    if rank_dims[axis] == 1:
        return None
    key = (lay.peer_dims, tuple(rank_dims))
    cache = lay.mesh.__dict__.setdefault(_RANK_MESHES, {})
    if key not in cache:
        mesh = lay.mesh
        rest = [i for i in range(mesh.ndim) if i not in lay.peer_dims]
        crossing = [a for a, r in enumerate(rank_dims) if r > 1]
        ranks = mesh.mesh.permute(*rest, *lay.peer_dims).reshape(
            -1, *[rank_dims[a] for a in crossing])
        names = ("rest",) + tuple(f"round{a}" for a in crossing)
        cache[key] = DeviceMesh(mesh.device_type, ranks,
                                mesh_dim_names=names)
    return cache[key].get_group(f"round{axis}")


#: elements of the sums one collective carries: a round's blocks are
#: packed into buckets of this size, so a leaf costs a bounded number of
#: collectives, and small leaves share one
RANK_BUCKET_ELEMS = DEVICE_BLOCK_ELEMS


def _rank_round(leaves, dims: Sequence[int], axis: int,
                mask: torch.Tensor, comm_dtype) -> None:
    """One round (grid ``dims``, axis ``axis``) over DTensor ``leaves``,
    in place in each rank's local shards."""
    import torch.distributed as dist

    lay = state_layout(leaves)
    local_dims, _ = split_grid(dims, lay.n_local)
    mine = slice(lay.first, lay.first + lay.n_local)
    m_loc = mask[mine]
    locs = [x.to_local() for x in leaves]
    group = peer_group(lay, dims, axis)
    if group is None:                    # the round lies inside the rank
        for x in locs:
            _mean_into_(x, local_dims, axis, m_loc, comm_dtype)
        return
    acc = _acc_dtype(comm_dtype)
    # each local peer's group count, from the replicated mask: [*local
    # grid with the round's axis 1, 1]
    mg = mask.float().reshape(tuple(dims))
    den = mg.sum(dim=axis, keepdim=True).expand(tuple(dims)).reshape(-1)
    den = den[mine].reshape(local_dims).narrow(axis, 0, 1).unsqueeze(-1)
    mgl = m_loc.reshape(local_dims + (1,)).to(acc)
    work = [(x, x if x.is_contiguous() else x.contiguous()) for x in locs]
    pieces = [blk for _, c in work for blk in _blocks(c)]
    total = sum(b.numel() // local_dims[axis] for b in pieces)
    buf = torch.empty(min(total, RANK_BUCKET_ELEMS), dtype=acc,
                      device=m_loc.device)
    pending: List[Tuple[torch.Tensor, int]] = []
    used = 0

    def flush():
        dist.all_reduce(buf[:used], group=group)
        for blk, off in pending:
            xg = blk.reshape(local_dims + (blk.shape[1],))
            shape = den.shape[:-1] + (blk.shape[1],)
            num = buf[off:off + int(np.prod(shape))].view(shape).float()
            blk.copy_(finalize_masked_mean(num, den, xg)
                      .to(blk.dtype).reshape(blk.shape))
        pending.clear()

    for blk in pieces:
        xg = blk.reshape(local_dims + (blk.shape[1],))
        num = (xg.to(acc) * mgl).sum(dim=axis, keepdim=True)
        if used + num.numel() > buf.numel():
            flush()
            used = 0
        buf[used:used + num.numel()].copy_(num.reshape(-1))
        pending.append((blk, used))
        used += num.numel()
        del num
    if pending:
        flush()
    for x, c in work:
        if c is not x:
            x.copy_(c)


def mar_round_device(state: Tree, plan: GridPlan, rnd: int,
                     mask: Optional[torch.Tensor] = None,
                     comm_dtype=None) -> Tree:
    """One MAR round on the device backend, written into ``state``'s
    leaves (each ``[P, ...]`` with P == plan.capacity); returns
    ``state``. The reshape ``[P, ...] -> [*dims, ...]`` puts the round's
    groups on grid axis ``rnd``; the masked mean over that axis is the
    round (the paper's partial communication). DTensor leaves whose
    peers are spread over ranks take the round over ranks
    (``_rank_round``)."""
    assert plan.capacity == plan.n_peers, "device backend needs exact grids"
    if mask is None:
        mask = _ones_mask(state)
    leaves = tree_leaves(state)
    if is_sharded(leaves[0]):
        _rank_round(leaves, plan.dims, rnd, mask, comm_dtype)
        return state
    for x in leaves:
        _mean_into_(x, plan.dims, rnd, mask, comm_dtype)
    return state


def mar_aggregate_device(state: Tree, plan: GridPlan,
                         mask: Optional[torch.Tensor] = None,
                         one_shot: bool = False,
                         comm_dtype=None) -> Tree:
    """Full MAR schedule on the device backend, in place; returns
    ``state``.

    ``one_shot`` fuses the d rounds into a single global masked mean —
    identical under full participation (beyond-paper variant).
    """
    if one_shot:
        assert plan.capacity == plan.n_peers, \
            "device backend needs exact grids"
        if mask is None:
            mask = _ones_mask(state)
        leaves = tree_leaves(state)
        if is_sharded(leaves[0]):
            _rank_round(leaves, (plan.capacity,), 0, mask, comm_dtype)
            return state
        for x in leaves:
            _mean_into_(x, (plan.capacity,), 0, mask, comm_dtype)
        return state
    for g in range(plan.depth):
        state = mar_round_device(state, plan, g, mask, comm_dtype)
    return state
