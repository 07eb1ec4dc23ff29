"""Fully decentralized DP with adaptive clipping (paper Alg. 4, §A.2).

DP-FedAvg with adaptive clipping (Andrew et al., 2021) made serverless:
each peer clips and noises its *local delta* against its last-known
global model, smooths it (beta), derives a DP-safe local model, and lets
MAR average privatized models. The clipping bound tracks a target
quantile ``gamma`` of the *globally averaged* (noised) clipping
indicator.

State per peer (leading peer axis):
  last_global   — theta-bar_i^{t-1}, the peer's last aggregated model
  smooth_delta  — Delta-bar_i^{t-1}  (bot encoded as has_delta = 0)
plus the shared scalar clipping bound C_t.

Noise calibration (Alg. 4 lines 1-3, with the paper's average-vs-sum
rescales): sigma_b = n_t / 20;  z_Delta = (sigma_mult^-2 - (2 sigma_b)^-2)^-1/2;
sigma_Delta = z_Delta * C_t; per-peer delta noise has variance
sigma_Delta^2 / n_t; the averaged indicator gets N(0, sigma_b^2) / n_t.
As in the reference, z_Delta is NaN whenever n_t <= 10 sigma_mult (the
base of the power goes negative), and the run then trains to NaN.

Port of the JAX package's ``repro/core/dp.py``. The noise is unit
normals handed in by the caller (``noise``: one tensor per leaf of the
delta tree, in leaf order, plus a scalar for the indicator), scaled as
the reference scales its ``jax.random`` draws, so a test can replay the
reference's own draws.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.tree import Tree, tree_leaves, tree_map

BETA = 0.9       # delta smoothing (paper §A.2)
ETA_U = 0.1      # server-lr analogue
GAMMA = 0.5      # target clipping quantile
ETA_C = 0.2      # clipping-bound stepsize


def dp_init(params: Tree, clip_init: float) -> Dict[str, Tree]:
    lead = tree_leaves(params)[0]
    return {
        "last_global": tree_map(lambda x: x.float().clone(), params),
        "smooth_delta": tree_map(lambda x: torch.zeros(
            x.shape, dtype=torch.float32, device=x.device), params),
        "has_delta": torch.zeros(lead.shape[0], dtype=torch.float32,
                                 device=lead.device),       # bot marker
        "clip": torch.tensor(clip_init, dtype=torch.float32,
                             device=lead.device),
    }


def _global_norm(tree: Tree) -> torch.Tensor:
    """Per-peer l2 norm over all leaves (leading axis = peers)."""
    sq = [torch.sum(torch.square(x.float()), dim=tuple(range(1, x.dim())))
          for x in tree_leaves(tree)]
    return torch.sqrt(sum(sq))


def _peer_view(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def dp_transform(aggregate_fn: Callable[[Tree], Tree], state: Tree,
                 dp_state: Dict[str, Tree], a_mask: torch.Tensor,
                 noise: Dict[str, Any], *, noise_multiplier: float,
                 plan=None, use_secagg: bool = False,
                 secagg_root: Optional[torch.Tensor] = None
                 ) -> Tuple[Tree, Dict[str, Tree]]:
    """Alg. 4 as a wire transform around any aggregation.

    ``aggregate_fn`` is the wrapped pipeline's ``(agg_state) ->
    agg_state``; ``state`` is the canonical ``{"p": params, "m":
    momentum}`` dict. ``noise`` holds ``"delta"``, unit normals shaped
    like the leaves of ``state["p"]`` (leaf order), and ``"b"``, one
    unit-normal scalar. Returns the privatized, aggregated state (extra
    keys stripped) and the new DP state. ``plan`` (a :class:`GridPlan`)
    and ``secagg_root`` (an int64 key) are needed only when
    ``use_secagg`` routes the clipping indicator through pairwise-masked
    secure aggregation.
    """
    params, momentum = state["p"], state["m"]
    n_t = torch.clamp(torch.sum(a_mask), min=1.0)
    c_t = dp_state["clip"]

    # lines 1-3: noise calibration
    sigma_b = n_t / 20.0
    z_delta = (noise_multiplier ** -2 - (2.0 * sigma_b) ** -2) ** -0.5
    sigma_delta = z_delta * c_t

    # line 4: local delta vs last-known global model
    delta = tree_map(lambda p, g: p.float() - g, params,
                     dp_state["last_global"])

    # line 5: clipping indicator
    norms = _global_norm(delta)                          # [N]
    b_ind = (norms <= c_t).float()

    # line 6: clip + noise
    scale = torch.clamp(c_t / torch.clamp(norms, min=1e-12), max=1.0)
    noise_std = sigma_delta / torch.sqrt(n_t)
    units: Sequence[torch.Tensor] = noise["delta"]
    if len(units) != len(tree_leaves(delta)):
        raise ValueError(f"DP noise has {len(units)} leaves; the delta "
                         f"tree has {len(tree_leaves(delta))}")
    it = iter(units)
    tilde = tree_map(lambda x: x * _peer_view(scale, x)
                     + noise_std * next(it), delta)

    # line 7: smoothing (bot -> take tilde directly)
    has = dp_state["has_delta"]
    smooth = tree_map(
        lambda sd, td: torch.where(_peer_view(has, td) > 0,
                                   BETA * sd + td, td),
        dp_state["smooth_delta"], tilde)

    # line 8: DP-safe local model
    theta_hat = tree_map(lambda g, sd: g + ETA_U * sd,
                         dp_state["last_global"], smooth)

    # lines 10-15: aggregate (theta_hat, momentum, b, smooth_delta).
    # The binary indicator leaks whether a peer clipped, so with
    # use_secagg it travels through pairwise-masked secure aggregation
    # (core/secagg.py; paper §A.2) instead of the plain group mean.
    agg_state = {**state, "p": theta_hat, "sd": smooth}
    if use_secagg:
        from repro_torch.core.secagg import secure_indicator_average
        if plan is None or secagg_root is None:
            raise ValueError("use_secagg needs a GridPlan and a root key")
        b_bar = secure_indicator_average(b_ind, plan, secagg_root, t=0,
                                         alive=a_mask)
        agg_state = aggregate_fn(agg_state)
    else:
        agg_state["b"] = b_ind
        agg_state = aggregate_fn(agg_state)
        b_bar = agg_state["b"]                           # [N] per-peer view

    new_params = tree_map(lambda x, p: x.to(p.dtype), agg_state["p"],
                          params)
    new_m = agg_state["m"]

    # lines 16-17: noised indicator average -> clipping-bound update.
    # b_bar is already the group/global average; one more shared draw
    b_tilde = torch.mean(b_bar) + noise["b"] * sigma_b / n_t
    new_clip = c_t * torch.exp(-ETA_C * (b_tilde - GAMMA))

    # participants update their last-global / smoothed-delta records
    new_last = tree_map(
        lambda old, new: torch.where(_peer_view(a_mask, old) > 0,
                                     new.float(), old),
        dp_state["last_global"], agg_state["p"])
    new_sd = tree_map(
        lambda old, new: torch.where(_peer_view(a_mask, old) > 0, new, old),
        dp_state["smooth_delta"], agg_state["sd"])
    new_has = torch.maximum(has, a_mask)

    out = {k: v for k, v in agg_state.items() if k not in ("sd", "b")}
    out["p"], out["m"] = new_params, new_m
    return out, {"last_global": new_last, "smooth_delta": new_sd,
                 "has_delta": new_has, "clip": new_clip}


# ---------------------------------------------------------------------------
# Privacy accounting (Renyi DP, Gaussian mechanism, q = sampling rate)
# ---------------------------------------------------------------------------

def epsilon_estimate(iterations: int, noise_multiplier: float,
                     delta: float = 1e-5, sampling_rate: float = 1.0
                     ) -> float:
    """(eps, delta)-DP upper estimate via RDP composition.

    For q = 1 the Gaussian mechanism has RDP(alpha) = alpha / (2 z^2);
    for q < 1 we use the standard subsampling bound
    RDP(alpha) <= q^2 * alpha / z^2 (valid for the alpha range used).
    eps = min_alpha [ T * RDP(alpha) + log(1/delta) / (alpha - 1) ].
    """
    z = noise_multiplier
    if z <= 0:
        return float("inf")
    best = float("inf")
    for alpha in [1.5, 2, 3, 4, 6, 8, 16, 32, 64, 128, 256]:
        if sampling_rate >= 1.0:
            rdp = alpha / (2.0 * z * z)
        else:
            rdp = (sampling_rate ** 2) * alpha / (z * z)
        eps = iterations * rdp + math.log(1.0 / delta) / (alpha - 1.0)
        best = min(best, eps)
    return best
