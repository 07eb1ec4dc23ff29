"""Moshpit All-Reduce grid math and deterministic group-key schedule.

The paper (§2.2) arranges N peers on a virtual d-dimensional grid
``N = M^d``. In MAR round ``g`` a peer's *group key* is its grid
coordinate vector with coordinate ``g`` struck out, so the ``M`` peers
that differ only in coordinate ``g`` share a key and average together.
After ``d`` rounds every peer holds the exact global mean (when
``N = M^d`` and no dropouts). This module is pure index arithmetic —
the TPU-native replacement for Hivemind DHT matchmaking (DESIGN.md §2);
``mar_allreduce.py`` executes the schedule.

Also provides ``plan_grid`` for general N (elastic peer counts): picks
(M, d) with M^d >= N and minimal per-iteration traffic, padding virtual
slots with a participation mask (the same mask mechanism that models
churn), so restarts with a different peer count re-factorize cleanly.

A copy of the JAX package's ``repro/core/moshpit.py`` (numpy) with its imports
rewritten; tests hold it equal to the reference.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """A d-dimensional MAR grid for N peers.

    ``dims`` may be heterogeneous (e.g. (2, 4, 4) for a 2-pod mesh whose
    DP axes factor as 4x4) — the paper's M^d is the uniform special case.

    ``placement`` optionally permutes peers onto grid slots:
    ``placement[peer] = slot`` over all ``capacity`` entities (real
    peers first, then virtual padding). Every coordinate/key/group query
    routes through it, so list planners, the vectorized builders, the
    analytic oracles and both sim engines see one consistent schedule —
    the hook topology-aware placement (``core/placement.py``) uses to
    park each network cluster on contiguous low-axis coordinates, the
    same way ``mesh_grid_plan`` isolates DCN traffic on the pod axis.
    ``None`` (and the identity permutation, which normalizes to
    ``None``) is bit-exact with the historical index == coordinate
    behavior.
    """

    n_peers: int               # real peers (<= capacity)
    dims: Tuple[int, ...]      # group size per round; capacity = prod(dims)
    placement: Optional[Tuple[int, ...]] = None   # entity -> slot

    def __post_init__(self):
        if self.placement is None:
            return
        cap = int(np.prod(self.dims))
        p = tuple(int(s) for s in self.placement)
        if len(p) != cap or sorted(p) != list(range(cap)):
            raise ValueError(
                f"placement must be a permutation of range({cap}) "
                f"(entity -> slot over the full grid capacity); got "
                f"length {len(p)}")
        if p == tuple(range(cap)):
            p = None               # identity is the no-placement plan
        object.__setattr__(self, "placement", p)

    @property
    def depth(self) -> int:
        return len(self.dims)

    @property
    def capacity(self) -> int:
        return int(np.prod(self.dims))

    @property
    def is_exact(self) -> bool:
        """Exact global average after ``depth`` rounds (no virtual slots)."""
        return self.capacity == self.n_peers

    # -- placement ------------------------------------------------------
    @functools.cached_property
    def _slot_of(self) -> np.ndarray:
        return np.asarray(self.placement, np.int64)

    @functools.cached_property
    def _entity_at(self) -> np.ndarray:
        inv = np.empty(self.capacity, np.int64)
        inv[self._slot_of] = np.arange(self.capacity)
        return inv

    def with_placement(self, perm) -> "GridPlan":
        """This grid with a peer→slot permutation applied.

        ``perm`` maps each real peer (length ``n_peers``) — or every
        capacity entity (length ``capacity``) — to a grid slot; with
        the short form, virtual entities fill the leftover slots in
        ascending order. ``None`` clears the placement. The identity
        permutation normalizes to ``placement=None``, so a cleared and
        an identity-placed plan compare equal.
        """
        if perm is None:
            return dataclasses.replace(self, placement=None)
        perm = np.asarray(perm, np.int64)
        cap = self.capacity
        if perm.shape == (cap,):
            full = perm
        elif perm.shape == (self.n_peers,):
            full = np.empty(cap, np.int64)
            full[:self.n_peers] = perm
            used = np.zeros(cap, bool)
            used[perm] = True
            full[self.n_peers:] = np.flatnonzero(~used)
        else:
            raise ValueError(
                f"placement permutation must cover the {self.n_peers} "
                f"real peers or all {cap} capacity slots; got shape "
                f"{perm.shape}")
        return dataclasses.replace(
            self, placement=tuple(int(s) for s in full))

    def slot_of(self, peer: np.ndarray | int) -> np.ndarray:
        """Grid slot of each entity (identity without a placement)."""
        peer = np.asarray(peer)
        return peer if self.placement is None else self._slot_of[peer]

    # -- coordinates ----------------------------------------------------
    def coords(self, peer: np.ndarray | int) -> np.ndarray:
        """Mixed-radix coordinates of peer index; last dim fastest."""
        peer = np.asarray(peer)
        if self.placement is not None:
            peer = self._slot_of[peer]
        out = np.empty(peer.shape + (self.depth,), np.int64)
        rem = peer
        for axis in range(self.depth - 1, -1, -1):
            out[..., axis] = rem % self.dims[axis]
            rem = rem // self.dims[axis]
        return out

    def index(self, coords: np.ndarray) -> np.ndarray:
        """Inverse of :meth:`coords`."""
        coords = np.asarray(coords)
        idx = np.zeros(coords.shape[:-1], np.int64)
        for axis in range(self.depth):
            idx = idx * self.dims[axis] + coords[..., axis]
        if self.placement is not None:
            idx = self._entity_at[idx]
        return idx

    # -- the group-key schedule ------------------------------------------
    def group_key(self, peer: np.ndarray | int, rnd: int) -> np.ndarray:
        """Round-``rnd`` group key: coordinates with axis ``rnd`` struck out.

        Peers sharing a key form one group of size ``dims[rnd]``. Keys are
        flattened to a scalar id so they can double as replica-group labels.
        This reproduces the paper's "group key initialization and updates
        that leverage chunk indices from d-1 previous MAR rounds": a peer's
        chunk index in round r *is* its coordinate on axis r, and striking
        a different axis every round guarantees no pair is revisited within
        one FL iteration.
        """
        if not 0 <= rnd < self.depth:
            raise ValueError(f"round {rnd} out of range for depth {self.depth}")
        c = self.coords(peer)
        key = np.zeros(c.shape[:-1], np.int64)
        for axis in range(self.depth):
            if axis == rnd:
                continue
            key = key * self.dims[axis] + c[..., axis]
        return key

    def groups_for_round(self, rnd: int) -> List[np.ndarray]:
        """All replica groups (lists of peer ids) for MAR round ``rnd``."""
        peers = np.arange(self.capacity)
        keys = self.group_key(peers, rnd)
        order = np.argsort(keys, kind="stable")
        m = self.dims[rnd]
        return [order[i * m:(i + 1) * m] for i in range(self.capacity // m)]

    def partner_matrix(self, rnd: int) -> np.ndarray:
        """[capacity, M] peer ids of each peer's round-``rnd`` group
        (including itself), ordered by the struck-out coordinate."""
        peers = np.arange(self.capacity)
        c = self.coords(peers)                       # [P, d]
        m = self.dims[rnd]
        reps = np.repeat(c[:, None, :], m, axis=1)   # [P, M, d]
        reps[:, :, rnd] = np.arange(m)[None, :]
        return self.index(reps)


def plan_grid(n_peers: int, group_size: int | None = None,
              depth: int | None = None) -> GridPlan:
    """Choose a grid for ``n_peers``.

    Priority: (1) honor explicit (group_size, depth) — and *honor*
    means honor: a (g, d) whose capacity ``g**d`` cannot hold N peers
    is a ValueError, never a silently deepened grid; (2) find uniform
    M^d == N exactly with M <= 8 (paper's optimal setup, e.g.
    125 = 5^3; 65536 = 2^16); (3) near-balanced mixed-radix grid: for
    each depth take M = ceil(N^(1/d)) and demote trailing rounds to
    M-1 while capacity still covers N, then keep the (capacity, cost,
    depth)-minimal candidate — e.g. 10 -> (3, 2, 2), 100 -> (5, 5, 4).
    The winner provably pads by less than one grid row; a clear
    ValueError (not a degenerate deep grid) is raised otherwise.
    """
    if depth is not None and depth < 1:
        # 0 is an explicit (invalid) request, not "unset"
        raise ValueError(f"depth must be >= 1, got {depth}")
    if group_size is not None:
        if depth is not None:
            if group_size ** depth < n_peers:
                raise ValueError(
                    f"explicit grid (group_size={group_size}, "
                    f"depth={depth}) has capacity "
                    f"{group_size ** depth} < {n_peers} peers; pass a "
                    f"deeper/wider grid or omit depth to auto-size")
            return GridPlan(n_peers, (group_size,) * depth)
        d = max(1, round(math.log(max(n_peers, 2), group_size)))
        while group_size ** d < n_peers:
            d += 1
        return GridPlan(n_peers, (group_size,) * d)
    if depth is not None:
        m = max(2, math.ceil(n_peers ** (1.0 / depth)))
        return GridPlan(n_peers, (m,) * depth)
    if n_peers < 2:
        return GridPlan(n_peers, (2,))
    # exact factorization M^d == N, prefer smaller M (less per-round traffic)
    for m in range(2, min(n_peers, 8) + 1):
        d = round(math.log(n_peers, m))
        for dd in (d, d + 1):
            if dd >= 1 and m ** dd == n_peers:
                return GridPlan(n_peers, (m,) * dd)
    # no exact power with M <= 8: near-balanced mixed-radix grid.  For
    # each depth d take the smallest M with M^d >= N and demote as many
    # trailing rounds as possible from M to M-1 while capacity still
    # covers N; rank candidates by (capacity, pairwise-exchange cost,
    # depth).  Because M was minimal, at least one round keeps M, so
    # padding < capacity / M — never a full grid row of virtual slots.
    best: GridPlan | None = None
    best_key = None
    for d in range(2, max(2, math.ceil(math.log2(n_peers))) + 1):
        m = 2
        while m ** d < n_peers:
            m += 1
        if m > 8:
            continue
        dims = [m] * d
        if m > 2:
            for k in range(1, d):
                cand = [m] * (d - k) + [m - 1] * k
                if int(np.prod(cand)) < n_peers:
                    break
                dims = cand
        cap = int(np.prod(dims))
        key = (cap, cap * sum(g - 1 for g in dims), d)
        if best_key is None or key < best_key:
            best, best_key = GridPlan(n_peers, tuple(dims)), key
    if best is None or (best.capacity - n_peers
                        >= best.capacity // best.dims[0]):
        raise ValueError(
            f"no auto-sized grid for N={n_peers} pads by less than one "
            f"grid row; pass an explicit (group_size, depth)")
    return best


def mesh_grid_plan(dp_axis_sizes: Sequence[int],
                   factor_hints: dict | None = None) -> GridPlan:
    """Map physical mesh DP axes onto a MAR grid (DESIGN.md §2).

    Each DP mesh axis contributes its factors as MAR rounds; e.g.
    data=16 -> (4, 4); multi-pod (pod=2, data=16) -> (2, 4, 4) with the
    pod axis as the *outermost* round so DCN-crossing traffic happens in
    exactly one of the d rounds.
    """
    factor_hints = factor_hints or {}
    dims: List[int] = []
    for i, size in enumerate(dp_axis_sizes):
        fac = factor_hints.get(i)
        if fac:
            assert int(np.prod(fac)) == size, (fac, size)
            dims.extend(fac)
        else:
            dims.extend(_balanced_factors(size))
    n = int(np.prod(dp_axis_sizes))
    return GridPlan(n, tuple(dims))


def _balanced_factors(n: int) -> List[int]:
    """Factor n into near-equal factors in [2..8], e.g. 16 -> [4, 4]."""
    if n == 1:
        return []
    if n <= 8:
        return [n]
    for m in (4, 5, 6, 7, 8, 3, 2):
        if n % m == 0:
            return [m] + _balanced_factors(n // m)
    return [n]  # prime > 8: single round


# ---------------------------------------------------------------------------
# Communication accounting (per paper §2.2)
# ---------------------------------------------------------------------------

def exchanges_per_iteration(plan: GridPlan) -> int:
    """Total pairwise model exchanges in one FL iteration: each of the
    capacity slots talks to (M_g - 1) peers in round g."""
    return int(sum(plan.capacity * (m - 1) for m in plan.dims))


def bytes_per_iteration(plan: GridPlan, model_bytes: int,
                        allreduce: str = "butterfly") -> int:
    """Data-plane bytes moved per FL iteration.

    ``butterfly``: within a group of M peers, reduce-scatter + all-gather
    moves 2*(M-1)/M * model_bytes per peer per round (bandwidth-optimal,
    what Moshpit/Hivemind does inside a group). ``naive``: every peer
    sends its full model to M-1 peers.
    """
    total = 0
    for m in plan.dims:
        if allreduce == "butterfly":
            per_peer = 2.0 * (m - 1) / m * model_bytes
        else:
            per_peer = (m - 1) * model_bytes
        total += int(plan.capacity * per_peer)
    return total
