"""The elastic-membership contract: one event every layer applies.

A :class:`MembershipChange` carries everything any layer needs to react
to a permanent join or leave: the old and new fleet sizes, the survivor
index map and the re-planned :class:`~repro_torch.core.moshpit.GridPlan`.
The sim federation applies it in :meth:`Federation.apply_membership`:

* **survivors are bit-exact**: their state leaves are gathered (a pure
  reindex; the contiguous-prefix default is a slice);
* **joiners bootstrap from the group mean** (MAR's mixing makes any
  subset representative), with per-stage exceptions routed through
  :func:`resize_state_tree` (EF residuals and DP bot-markers start at
  zero);
* the grid re-factorizes via ``runtime.fault.elastic_replan`` and the
  plan-holding layers (pipeline, transport, lifecycle) re-bind to
  ``change.new_plan``.

A same-N change (``old_n == new_n``, different dims or placement) is the
adaptive-M / placement *regroup*: the same contract with an identity
survivor map.

Port of the JAX package's ``repro/core/replan.py`` over nested dicts of
tensors (``tree.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.moshpit import GridPlan
from repro_torch.tree import Tree, tree_map


def resize_peer_axis(tree: Tree, old_n: int, new_n: int,
                     fill: str = "mean") -> Tree:
    """Grow or shrink the stacked peer axis of a tree in place (no
    checkpoint round-trip).

    Leaves whose leading dim is ``old_n`` are resized; everything else
    (scalars, shared state) passes through. Shrinking slices the first
    ``new_n`` peers; survivors are bit-exact. Growing appends peers
    bootstrapped from the f32 mean over the peers (``fill="mean"``) or
    zeros (``fill="zero"``, for error-feedback residuals and indicator
    state that must start empty).
    """
    if old_n == new_n:
        return tree

    def leaf(x):
        if x.dim() == 0 or x.shape[0] != old_n:
            return x
        if new_n < old_n:
            return x[:new_n]
        shape = (new_n - old_n,) + tuple(x.shape[1:])
        if fill == "zero":
            pad = x.new_zeros(shape)
        else:
            mean = x.float().mean(dim=0, keepdim=True).to(x.dtype)
            pad = mean.expand(shape)
        return torch.cat([x, pad], dim=0)

    return tree_map(leaf, tree)


def resize_state_tree(own: Tree, old_n: int, new_n: int,
                      zero_keys: Tuple[str, ...] = ()) -> Tree:
    """The per-``WireStage`` elastic hook body: resize a stage's state
    slice, mean-bootstrapping joiners except for the named dict keys,
    which start at zero (EF residuals, DP bot-markers: state a joiner
    must not inherit). Non-dict stage state mean-bootstraps wholesale.
    """
    if old_n == new_n:
        return own
    if isinstance(own, dict):
        return {k: resize_peer_axis(v, old_n, new_n,
                                    "zero" if k in zero_keys else "mean")
                for k, v in own.items()}
    return resize_peer_axis(own, old_n, new_n, "mean")


def select_survivors(tree: Tree, old_n: int,
                     survivors: Sequence[int]) -> Tree:
    """Gather the surviving peers' slices (new order) out of an
    ``old_n``-peer tree: a pure reindex, bit-exact per survivor. The
    contiguous-prefix map (the default every shrink produces) is the
    slice ``x[:k]``."""
    idx = np.asarray(tuple(survivors), np.int64)
    k = idx.size
    if k == old_n and np.array_equal(idx, np.arange(old_n)):
        return tree
    contiguous = np.array_equal(idx, np.arange(k))

    def leaf(x):
        if x.dim() == 0 or x.shape[0] != old_n:
            return x
        if contiguous:
            return x[:k]
        return x[torch.as_tensor(idx, device=x.device)]

    return tree_map(leaf, tree)


@dataclasses.dataclass(frozen=True)
class MembershipChange:
    """One membership event, fully planned: what every layer consumes.

    ``survivors`` maps new-fleet order to old peer ids: entry ``i`` is
    the old id of new peer ``i``; new ids past ``len(survivors)`` are
    joiners. The default (built by :func:`plan_membership_change`) is
    the contiguous prefix ``range(min(old_n, new_n))``: tail peers
    leave, joiners append.
    """

    old_n: int
    new_n: int
    new_plan: GridPlan
    survivors: Tuple[int, ...]
    iteration: Optional[int] = None

    def __post_init__(self):
        if self.new_n < 1:
            raise ValueError(f"cannot resize to {self.new_n} peers")
        if self.new_plan.n_peers != self.new_n:
            raise ValueError(
                f"plan is for {self.new_plan.n_peers} peers, change "
                f"targets {self.new_n}")
        s = self.survivors
        if len(s) > min(self.old_n, self.new_n) or \
                any(not 0 <= i < self.old_n for i in s) or \
                len(set(s)) != len(s):
            raise ValueError(
                f"survivors must be <= {min(self.old_n, self.new_n)} "
                f"distinct old peer ids in [0, {self.old_n}); got {s}")

    @property
    def same_n(self) -> bool:
        """A membership-preserving regroup (adaptive-M / placement)."""
        return self.old_n == self.new_n

    @property
    def n_joiners(self) -> int:
        return self.new_n - len(self.survivors)

    @property
    def contiguous(self) -> bool:
        return self.survivors == tuple(range(len(self.survivors)))

    def apply_to_tree(self, tree: Tree, fill: str = "mean") -> Tree:
        """Map one peer-stacked tree through this change: gather
        survivors (bit-exact), then bootstrap joiners (``fill``)."""
        kept = select_survivors(tree, self.old_n, self.survivors)
        return resize_peer_axis(kept, len(self.survivors), self.new_n,
                                fill)


def plan_membership_change(old_plan: GridPlan, new_n: int, *,
                           iteration: Optional[int] = None,
                           survivors: Optional[Sequence[int]] = None,
                           exact_only: bool = False) -> MembershipChange:
    """Plan a permanent join/leave: re-factorize the grid
    (``elastic_replan`` keeps the old uniform M when it still factors
    ``new_n``) and fix the survivor map (contiguous prefix by default).
    ``exact_only`` rejects targets whose replanned grid pads virtual
    slots."""
    from repro_torch.runtime.fault import elastic_replan
    if new_n < 1:
        raise ValueError(f"cannot resize to {new_n} peers")
    old_n = old_plan.n_peers
    new_plan = old_plan if new_n == old_n else \
        elastic_replan(old_plan, new_n)
    if exact_only and not new_plan.is_exact:
        raise ValueError(
            f"no exact grid for {new_n} peers (best factorization "
            f"{new_plan.dims} has capacity {new_plan.capacity}); the "
            f"device backend needs capacity == N — target a peer count "
            f"with an exact factorization (e.g. 6, 8, 9, 12, 16)")
    if survivors is None:
        survivors = tuple(range(min(old_n, new_n)))
    return MembershipChange(old_n=old_n, new_n=new_n, new_plan=new_plan,
                            survivors=tuple(int(i) for i in survivors),
                            iteration=iteration)


def regroup_change(old_plan: GridPlan, new_plan: GridPlan,
                   iteration: Optional[int] = None) -> MembershipChange:
    """A same-N membership change: new dims and/or placement for the
    same fleet."""
    if new_plan.n_peers != old_plan.n_peers:
        raise ValueError(
            f"regroup keeps membership: old plan has "
            f"{old_plan.n_peers} peers, proposal {new_plan.n_peers} "
            f"(permanent join/leave goes through "
            f"plan_membership_change)")
    n = old_plan.n_peers
    return MembershipChange(old_n=n, new_n=n, new_plan=new_plan,
                            survivors=tuple(range(n)),
                            iteration=iteration)


def validate_membership_schedule(plan: GridPlan,
                                 planned: Sequence[Tuple[int, int]],
                                 exact_only: bool = True) -> None:
    """Pre-flight a schedule of ``(iteration, new_n)`` resizes: every
    target must admit a grid the backend can execute. Raises at launch,
    naming the offending step."""
    cur = plan
    for t, n in planned:
        try:
            cur = plan_membership_change(
                cur, n, iteration=t, exact_only=exact_only).new_plan
        except ValueError as e:
            raise ValueError(
                f"planned resize at step {t} ({cur.n_peers} -> {n} "
                f"peers) cannot run: {e}") from None
