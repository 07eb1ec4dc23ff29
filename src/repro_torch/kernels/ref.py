"""Plain PyTorch versions of the port's kernels.

Each function is the semantic ground truth at f32 precision with no
blocking. The kernel wrappers call these for tensors on the CPU, and
``chip_smoke.py`` holds each kernel against them on the card. Port of
the matching functions in the JAX package's ``repro/kernels/ref.py``,
plus the chunked scan of its ``repro/models/ssm.py`` and that scan's
VJP, :func:`ssd_scan_bwd`, the backward of the SSD-scan kernel.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch


def group_mean_ref(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked group mean (MAR aggregation hot spot).

    x [G, M, D]; mask [G, M] -> [G, M, D]: every slot receives its
    group's masked mean; empty groups keep their own values.
    """
    m = mask.unsqueeze(-1).float()
    num = (x.float() * m).sum(dim=1, keepdim=True)
    den = m.sum(dim=1, keepdim=True)
    mean = num / den.clamp(min=1.0)
    out = torch.where(den > 0, mean, x.float())
    return out.expand(x.shape).to(x.dtype)


def group_mean_round_ref(xs: Sequence[torch.Tensor], order: torch.Tensor,
                         mask: torch.Tensor, m: int) -> List[torch.Tensor]:
    """One MAR round over leaves ``xs`` (each ``[n, d]``), composed as the
    reference's ``_kernel_round`` composes it: pad to ``cap = len(order)``
    rows with zero rows of mask 0 (virtual slots), gather into group
    order, :func:`group_mean_ref` over ``[cap/m, m, d]``, gather back by
    the inverse order, drop the virtual rows."""
    n, cap = mask.shape[0], order.shape[0]
    inv = torch.argsort(order)
    mf = mask.float()
    mask_g = torch.cat([mf, mf.new_zeros(cap - n)])[order]
    out = []
    for x in xs:
        xf = torch.cat([x, x.new_zeros((cap - n, x.shape[1]))])[order]
        y = group_mean_ref(xf.reshape(cap // m, m, -1),
                           mask_g.reshape(cap // m, m))
        out.append(y.reshape(cap, -1)[inv][:n])
    return out


def mar_rounds_ref(x: torch.Tensor, dims: Sequence[int],
                   axes: Sequence[int], mask: torch.Tensor) -> torch.Tensor:
    """The device backend's MAR rounds ``axes`` over grid ``dims`` of x
    ([P, ...], peers row major over ``dims``), in order: each round the
    plain route's masked mean with an f32 sum
    (``core/mar_allreduce._grid_reshape_mean``), rounded to x's dtype.
    A fresh tensor; x is not written."""
    # imported here: the core package imports the kernels at load time
    from repro_torch.core.mar_allreduce import _grid_reshape_mean
    for axis in axes:
        x = _grid_reshape_mean(x, dims, axis, mask)
    return x


NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [b,s,h,d]; k,v [b,skv,kvh,d] -> (o [b,s,h,d], lse [b,h,s]).

    GQA (query head i reads kv head i // (h/kvh)); causal masks kv
    position j > query position i. Scores are scaled by ``scale``,
    1/sqrt(d) where it is None. o is in q's dtype, lse (the row
    log-sum-exp of the scaled scores, what the flash recurrence keeps
    for its backward) in f32. The reference's oracle returns o only.
    """
    b, s, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, d)
    sc = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    sc = sc / math.sqrt(d) if scale is None else sc * scale
    if causal:
        pos_q = torch.arange(s, device=q.device)
        pos_k = torch.arange(skv, device=q.device)
        sc = torch.where(pos_q[:, None] >= pos_k[None, :], sc, NEG_INF)
    lse = torch.logsumexp(sc, dim=-1)                     # [b,kvh,g,s]
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, s, h, d).to(q.dtype), lse.reshape(b, h, s)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q [b,h,d]; caches [b,S,kvh,d]; lengths [b] -> [b,h,d].

    Attends to positions < lengths[b] (the filled prefix of the cache).
    """
    b, h, d = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, d)
    sc = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) \
        / math.sqrt(d)
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(b, h, d).to(q.dtype)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               block_tables: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """q [b,h,d]; pages [nb,bs,kvh,d]; block_tables [b,nblk]; lengths [b].

    Gathers each session's pages into a dense [b, nblk*bs, kvh, d] cache
    (block-table order == position order) and defers to the dense decode
    oracle — the semantic ground truth for the paged kernel.
    """
    b = q.shape[0]
    bs, kvh, d = k_pages.shape[1], k_pages.shape[2], k_pages.shape[3]
    s = block_tables.shape[1] * bs
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, s, kvh, d)
    v = v_pages[bt].reshape(b, s, kvh, d)
    return decode_attention_ref(q, k, v, lengths)


def ssd_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_a: torch.Tensor, h0: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gated linear recurrence (Mamba2 SSD / mLSTM shared primitive).

    q,k [b,nh,S,dk]; v [b,nh,S,dv]; log_a [b,nh,S] (<=0);
    h0 [b,nh,dk,dv]. Sequential-scan ground truth:
        H_t = exp(a_t) H_{t-1} + k_t^T v_t;   y_t = q_t . H_t
    H is carried in f32; returns (y in v's dtype, h_final f32).
    """
    h = h0.float()
    ys = []
    for t in range(q.shape[2]):
        h = h * torch.exp(log_a[:, :, t].float())[..., None, None] + \
            torch.einsum("bhd,bhv->bhdv", k[:, :, t].float(),
                         v[:, :, t].float())
        ys.append(torch.einsum("bhd,bhdv->bhv", q[:, :, t].float(), h))
    if not ys:
        return v.clone(), h
    return torch.stack(ys, dim=2).to(v.dtype), h


def chunked_linear_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        log_a: torch.Tensor, h0: torch.Tensor,
                        chunk: int = 256
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q,k: [b, nh, S, dk]; v: [b, nh, S, dv]; log_a: [b, nh, S] (<= 0).

    The plain chunked form (intra-chunk products, a loop over chunks),
    the port of the JAX package's ``repro/models/ssm.py``
    ``chunked_linear_scan``: the XLA route of the recurrent blocks and
    the function whose VJP the reference trains through.
    Returns (y [b, nh, S, dv] in v's dtype, h_final [b, nh, dk, dv] f32).
    """
    b, nh, s, dk = q.shape
    dv = v.shape[-1]
    if s % chunk != 0:
        chunk = s  # smoke shapes
    nchunks = s // chunk
    qc = q.reshape(b, nh, nchunks, chunk, dk)
    kc = k.reshape(b, nh, nchunks, chunk, dk)
    vc = v.reshape(b, nh, nchunks, chunk, dv)
    ac = log_a.reshape(b, nh, nchunks, chunk).float()
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=q.device).tril()

    h = h0.float()
    ys = []
    for c in range(nchunks):
        qi, ki, vi = qc[:, :, c].float(), kc[:, :, c].float(), \
            vc[:, :, c].float()
        cum = ac[:, :, c].cumsum(dim=-1)              # A_i = sum_{j<=i} a_j
        total = cum[..., -1]                          # [b, nh]
        # intra-chunk: S_ij = (q_i.k_j) exp(A_i - A_j), j <= i
        qk = torch.einsum("bhid,bhjd->bhij", qi, ki)
        decay = cum[..., :, None] - cum[..., None, :]
        gate = torch.where(causal, torch.exp(torch.clamp(decay, max=0.0)),
                           0.0)
        y_intra = torch.einsum("bhij,bhjv->bhiv", qk * gate, vi)
        # inter-chunk: y_i += exp(A_i) q_i . H0
        y_inter = torch.einsum("bhid,bhdv->bhiv", qi, h) \
            * torch.exp(cum)[..., None]
        # state update: H' = exp(A_total) H0 + sum_j exp(A_total - A_j) k_j v_j
        w = torch.exp(total[..., None] - cum)         # [b, nh, chunk]
        h = h * torch.exp(total)[..., None, None] + torch.einsum(
            "bhjd,bhjv->bhdv", ki * w[..., None], vi)
        ys.append((y_intra + y_inter).to(v.dtype))
    if not ys:
        return v.clone(), h
    return torch.stack(ys, dim=2).reshape(b, nh, s, dv), h


def ssd_scan_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_a: torch.Tensor, h0: torch.Tensor,
                 dy: Optional[torch.Tensor], dh_final: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, ...]:
    """The SSD scan's backward: (dq, dk, dv, dlog_a, dh0) for the
    cotangents ``dy`` of y and ``dh_final`` of h_final (either may be
    None, a zero cotangent).

    The JAX package's Pallas scan has no backward: its training gradient
    is the VJP of the jnp ``chunked_linear_scan``. This is that VJP:
    :func:`chunked_linear_scan` recomputed on detached inputs under
    ``torch.enable_grad()`` and differentiated by ``torch.autograd.grad``
    (f32 inside, each gradient in its input's dtype and shape; an input
    broadcast at stride 0 gets the full per-position gradient, which the
    broadcast's own backward sums)."""
    xs = [x.detach().requires_grad_() for x in (q, k, v, log_a, h0)]
    with torch.enable_grad():
        y, h = chunked_linear_scan(*xs)
        pairs = [(o, g) for o, g in ((y, dy), (h, dh_final))
                 if g is not None]
        if not pairs:
            return tuple(torch.zeros_like(x) for x in xs)
        outs, cots = zip(*pairs)
        grads = torch.autograd.grad(outs, xs, cots, allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, xs))
