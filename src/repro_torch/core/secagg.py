"""Secure aggregation for the DP clipping indicator (paper §A.2).

Alg. 4's clipping-bound update consumes the *average* of per-peer binary
indicators b_i = 1{||delta_i|| <= C_t}. A plain average leaks every b_i
to its group mates; the paper notes that a privacy-preserving mechanism
(e.g. Secure Aggregation) has to be deployed for the global binary
indicator. This module implements the pairwise-additive-mask
construction (Bonawitz et al., 2017) specialized to MAR groups:

For each aggregating pair (i, j) in a group, both derive a shared mask
m_ij = PRF(k_ij, t) from a pairwise key; peer i submits
``b_i + sum_{j>i} m_ij - sum_{j<i} m_ij``. Masks cancel in the group
sum, so the aggregation path learns only the sum. Dropouts: a pair's
masks are only applied when both endpoints are alive (the sim resolves
this from the shared mask table; a production deployment uses the
secret-shared mask-recovery protocol of the original paper).

Port of the JAX package's ``repro/core/secagg.py``. The reference's PRF
is a ``jax.random.fold_in`` chain, which torch cannot reproduce and the
protocol does not need: here the PRF is a vectorized splitmix64 hash of
(root, lo, hi, t) in int64 on the tensors' device, mapped to a uniform
in [-MASK_RANGE, MASK_RANGE). Each round's partners come from the MAR
round tables (``mar_allreduce.round_index``). Pairwise keys are
keyed-hash stand-ins, as in the reference; the protocol's structure
(who masks what, when masks cancel) is what this module pins down.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.mar_allreduce import round_index
from repro_torch.core.moshpit import GridPlan

MASK_RANGE = 100.0


def _i64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_GOLDEN = _i64(0x9E3779B97F4A7C15)
_MUL1 = _i64(0xBF58476D1CE4E5B9)
_MUL2 = _i64(0x94D049BB133111EB)


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits (``>>`` is arithmetic)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer over int64 tensors (wrapping arithmetic)."""
    z = x + _GOLDEN
    z = (z ^ _shr(z, 30)) * _MUL1
    z = (z ^ _shr(z, 27)) * _MUL2
    return z ^ _shr(z, 31)


def fold(root: torch.Tensor, value) -> torch.Tensor:
    """A key derived from ``root`` and an integer (or int64 tensor)."""
    return _splitmix64(_splitmix64(root) + value)


def _uniform(h: torch.Tensor) -> torch.Tensor:
    """int64 hashes -> f32 uniforms in [-MASK_RANGE, MASK_RANGE)."""
    u = _shr(h, 40).to(torch.float32) * (1.0 / (1 << 24))   # [0, 1)
    return u * (2.0 * MASK_RANGE) - MASK_RANGE


def _pair_key(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The key material of pair (lo, hi), before the round's key: the
    two ids packed into one int64 (one value per pair; the round's key
    and the hash in :func:`_pair_masks` do the mixing)."""
    return (lo << 32) + hi


def _pair_masks(pair: torch.Tensor, root: torch.Tensor,
                t: int) -> torch.Tensor:
    """PRF(k_pair, t) for pair keys from :func:`_pair_key`."""
    return _uniform(_splitmix64(pair + fold(root, t)))


def _pair_mask_table(root: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor, t: int) -> torch.Tensor:
    """Vectorized PRF(k_{lo,hi}, t) over same-shape int64 tensors:
    uniforms in [-MASK_RANGE, MASK_RANGE), f32."""
    return _pair_masks(_pair_key(lo, hi), root, t)


def masked_submissions(values: torch.Tensor, plan: GridPlan, rnd: int,
                       root: torch.Tensor, t: int,
                       alive: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Each peer's masked indicator for MAR round ``rnd``.

    values: [N] f32; returns [N] masked submissions whose *group sums*
    over alive peers equal the group sums of ``values``. ``root`` is an
    int64 scalar tensor (the round's key).
    """
    dev = values.device
    ri = round_index(plan, rnd, dev)
    i = torch.arange(plan.n_peers, device=dev).unsqueeze(1)
    j = ri.partners
    masks = _pair_masks(_pair_key(torch.minimum(i, j), torch.maximum(i, j)),
                        root.to(dev), t)
    sign = torch.where(i < j, 1.0, -1.0)
    gate = ri.real                      # real pairs only: not self, not virtual
    if alive is not None:
        alive_v = alive.float()
        gate = gate * alive_v[:, None] * alive_v[j]
    return values.float() + torch.sum(masks * sign * gate, dim=1)


def secure_group_sum(values: torch.Tensor, plan: GridPlan, rnd: int,
                     root: torch.Tensor, t: int,
                     alive: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(group sums scattered back to peers [N], alive counts [N])."""
    dev = values.device
    n, m = plan.n_peers, plan.dims[rnd]
    ri = round_index(plan, rnd, dev)
    alive_v = torch.ones(n, dtype=torch.float32, device=dev) \
        if alive is None else alive.float()
    masked = masked_submissions(values, plan, rnd, root, t, alive) * alive_v
    both = torch.stack([masked, alive_v], dim=1)                # [N, 2]
    both = torch.cat([both, both.new_zeros(plan.capacity - n, 2)])
    # each group's m slots in a row, summed in one fixed order: the
    # masks reach +-MASK_RANGE, so the order of an index_add_'s atomics
    # on CUDA would move the sums by their rounding from run to run
    sums = both[ri.order].reshape(-1, m, 2).sum(dim=1)          # [G, 2]
    per_peer = sums[ri.seg[:n]]
    return per_peer[:, 0], per_peer[:, 1]


def secure_indicator_average(values: torch.Tensor, plan: GridPlan,
                             root: torch.Tensor, t: int,
                             alive: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Full-depth secure averaging of clipping indicators: the MAR
    schedule over secure group sums; returns the per-peer global average
    (Alg. 4 line 15's b-bar) with no peer revealing its own b_i."""
    cur = values.float()
    cur_alive = alive
    for rnd in range(plan.depth):
        s, c = secure_group_sum(cur, plan, rnd, fold(root, rnd), t,
                                cur_alive)
        cur = s / torch.clamp(c, min=1.0)
        cur_alive = None   # from round 1 on, every peer carries a mean
    return cur
