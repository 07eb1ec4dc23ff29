"""Mixture-of-Experts FFN: top-k routing with capacity-based dispatch.

Port of the JAX package's ``repro/models/moe.py`` as plain functions on
tensors. The reference has no Pallas kernel here: its expert products
are ``jnp.einsum`` on ``[E, C, d]`` buffers, so the port's are
``torch.bmm`` on the same buffers.

* ``moe_block`` — the production path. Assignments are sorted by expert
  id (a stable sort, as ``jnp.argsort``: which assignments a full expert
  drops depends on it) into a fixed ``[E, C, d]`` buffer (GShard-style
  dropping at capacity), run through each expert's SwiGLU, and combined
  back to their tokens with the gates. The combine is deterministic:
  each token gathers its k contributions in the sorted order (ascending
  expert id) and adds them one after the other in the model's dtype,
  starting from zero, the order in which the reference's serial scatter
  adds them. No atomics.
* ``moe_block_dense_oracle`` — every expert on every token, for tests
  on tiny shapes.

Shared experts (DeepSeek-V3 / Kimi lineage) are a plain SwiGLU over all
tokens, added to the routed output. The router stays f32 in a bf16
model.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (dense_init, mlp_block, mlp_init,
                                       torch_dtype)

Tensor = torch.Tensor


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Tensor]:
    """Router [d, E] f32; experts ``wg``, ``wu`` [E, d, ff] and ``wd``
    [E, ff, d] in ``cfg.dtype``, drawn in f32 one tensor at a time and
    scaled by 1/sqrt(d); ``shared`` a SwiGLU of ``num_shared_experts *
    d_ff``."""
    dt, dev = torch_dtype(cfg), gen.device
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    scale = 1.0 / math.sqrt(d)

    def experts(shape):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return w.mul_(scale).to(dt)

    p = {"router": dense_init(gen, d, e, torch.float32),
         "wg": experts((e, d, ff)),
         "wu": experts((e, d, ff)),
         "wd": experts((e, ff, d))}
    if cfg.num_shared_experts:
        p["shared"] = mlp_init(gen, cfg, d_ff=cfg.num_shared_experts * ff)
    return p


def _route(params, x: Tensor, cfg: ModelConfig) -> Tuple[Tensor, Tensor,
                                                         Tensor]:
    """(softmax probs [T, E], top-k probs [T, k], expert ids [T, k])."""
    logits = x.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    return probs, top, idx


def router_probs(params, x: Tensor, cfg: ModelConfig) -> Tuple[Tensor,
                                                               Tensor]:
    """Top-k gates (renormalized) and expert ids. x: [T, d]."""
    _, top, idx = _route(params, x, cfg)
    return top / top.sum(dim=-1, keepdim=True), idx


def _expert_counts(ids: Tensor, num_experts: int) -> Tensor:
    """Assignments per expert (``bincount``, which has no ``meta``
    kernel for the dry run; integer adds, exact in any order)."""
    return torch.zeros(num_experts, dtype=ids.dtype,
                       device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def load_balance_loss(params, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Switch-style aux loss: E * sum(fraction_tokens * fraction_prob)."""
    probs, _, idx = _route(params, x, cfg)
    counts = _expert_counts(idx.reshape(-1), cfg.num_experts).float()
    f = counts / torch.clamp(counts.sum(), min=1.0)
    return cfg.num_experts * torch.sum(f * probs.mean(dim=0))


def capacity(t: int, cfg: ModelConfig) -> int:
    """Slots per expert: t k / E times the capacity factor, rounded up
    to a multiple of 8, at least 8."""
    cap = int(t * cfg.experts_per_token / cfg.num_experts
              * cfg.moe_capacity_factor)
    return max(8, -(-cap // 8) * 8)


def moe_block(params, x: Tensor, cfg: ModelConfig) -> Tensor:
    """x: [B, S, d] -> [B, S, d]."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.experts_per_token, cfg.num_experts
    cap = capacity(t, cfg)
    dev = x.device

    xf = x.reshape(t, d)
    gates, idx = router_probs(params, xf, cfg)            # [T, k]

    # (token, slot) assignments sorted by expert id, stably
    e_flat = idx.reshape(t * k)
    order = torch.argsort(e_flat, stable=True)
    e_sort = e_flat[order]
    t_sort = order // k                                   # token of each
    counts = _expert_counts(e_flat, e)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(t * k, device=dev) - starts[e_sort]
    keep = slot < cap
    slot_c = torch.where(keep, slot, torch.zeros_like(slot))

    # each kept assignment owns its (expert, slot), so a plain store
    # places it; a dropped one goes to the spare slot ``cap``, never read
    # (no boolean mask, so no wait for the card)
    buf = x.new_zeros((e, cap + 1, d))
    buf[e_sort, torch.where(keep, slot, cap)] = xf[t_sort]
    buf = buf[:, :cap]

    with torch.profiler.record_function("moe"):
        h = F.silu(torch.bmm(buf, params["wg"])) * torch.bmm(buf,
                                                             params["wu"])
        out_buf = torch.bmm(h, params["wd"])              # [E, C, d]

        # combine: ``pos[i]`` holds the sorted positions of token i's k
        # contributions, ascending, so ascending in expert id
        g_sort = gates.reshape(t * k)[order]
        contrib = out_buf[e_sort, slot_c] * \
            (g_sort * keep).to(x.dtype)[:, None]          # [T*k, d]
        pos = torch.empty_like(order)
        pos[order] = torch.arange(t * k, device=dev)
        pos = pos.reshape(t, k).sort(dim=1).values
        parts = contrib[pos]                              # [T, k, d]
        yf = torch.zeros((t, d), dtype=x.dtype, device=dev)
        for j in range(k):
            yf = yf + parts[:, j]

    if "shared" in params:
        yf = yf + mlp_block(params["shared"], xf)
    return yf.reshape(b, s, d)


def moe_block_dense_oracle(params, x: Tensor, cfg: ModelConfig) -> Tensor:
    """All-experts oracle (tiny shapes only): exact, no capacity drops."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    gates, idx = router_probs(params, xf, cfg)
    h = F.silu(torch.einsum("td,edf->tef", xf, params["wg"])) * \
        torch.einsum("td,edf->tef", xf, params["wu"])
    y_all = torch.einsum("tef,efd->ted", h, params["wd"])
    combine = torch.zeros((xf.shape[0], cfg.num_experts),
                          dtype=torch.float32, device=x.device)
    combine.scatter_add_(1, idx, gates)
    yf = torch.einsum("te,ted->td", combine.to(x.dtype), y_all)
    if "shared" in params:
        yf = yf + mlp_block(params["shared"], xf)
    return yf.reshape(b, s, d)
