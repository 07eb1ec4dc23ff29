"""Core transformer layers, dense subset: norms, RoPE, GQA attention,
SwiGLU — functions on tensors.

Port of the JAX package's ``repro/models/layers.py``. Parameters are
nested dicts of tensors with the reference's keys and layouts (dense
``w`` is ``[in, out]``), in ``cfg.dtype``. ``init_*`` draw from a
``torch.Generator`` with the reference's distributions (normal / sqrt(in)
for dense weights, normal x 0.02 for the embedding, ones for norms),
drawn in f32 and cast; the numbers differ from ``jax.random``'s, so
tests carry weights across with ``repro_torch.convert``.

The decode paths update their KV caches in place (``index_put_``)
instead of returning fresh copies as JAX must; they still return the
caches so the call sites read as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype) -> Tensor:
    w = torch.randn((in_dim, out_dim), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype: torch.dtype, device) -> Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-5) -> Tensor:
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device) -> Tensor:
    """Inverse frequencies [head_dim//2], fp32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: [..., seq, heads, head_dim]; positions: broadcastable to
    [..., seq]."""
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device)
    # angles [..., seq, 1, head_dim//2]
    ang = positions[..., None, None].float() * inv_freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, causal)
# ---------------------------------------------------------------------------

def attention_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt = torch_dtype(cfg)
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": dense_init(gen, d, h * hd, dt),
            "wk": dense_init(gen, d, kvh * hd, dt),
            "wv": dense_init(gen, d, kvh * hd, dt),
            "wo": dense_init(gen, h * hd, d, dt)}


def _qkv(params: Params, x: Tensor, cfg: ModelConfig,
         positions: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(b, s, h, hd)
    k = (x @ params["wk"]).reshape(b, s, kvh, hd)
    v = (x @ params["wv"]).reshape(b, s, kvh, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa_chunk(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor],
                scale: float) -> Tensor:
    """One q-chunk of GQA attention. q:[b,qc,h,hd] k/v:[b,skv,kvh,hd];
    mask [b,qc,skv]. Scores and softmax in f32, probabilities cast to
    v's dtype for the value product."""
    b, qc, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, qc, kvh, h // kvh, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(b, qc, h, hd)


def causal_attention(q: Tensor, k: Tensor, v: Tensor, cfg: ModelConfig,
                     q_offset: int = 0) -> Tensor:
    """Chunked causal attention, the plain ``"xla"`` implementation: a
    loop over q chunks keeps peak memory at one [b, qc, skv] score
    block."""
    b, s, h, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    qc = min(cfg.attn_q_chunk, s)
    if s % qc != 0:  # fall back to single chunk for ragged smoke shapes
        qc = s
    kv_pos = torch.arange(k.shape[1], device=q.device)
    outs = []
    for start in range(0, s, qc):
        q_pos = q_offset + start + torch.arange(qc, device=q.device)
        mask = kv_pos[None, None, :] <= q_pos[None, :, None]  # [1, qc, skv]
        mask = mask.expand(b, qc, k.shape[1])
        outs.append(_sdpa_chunk(q[:, start:start + qc], k, v, mask, scale))
    return torch.cat(outs, dim=1)


def attention_impl(q: Tensor, k: Tensor, v: Tensor,
                   cfg: ModelConfig) -> Tensor:
    """Dispatch on cfg.attn_impl. ``"pallas"`` and ``"flash"`` both reach
    the flash kernel for CUDA tensors (on the TPU ``"flash"`` was the XLA
    semantics reference of the Pallas kernel; here that function has one
    implementation, the kernel); ``"xla"`` stays the plain chunked
    path."""
    if cfg.attn_impl == "pallas":
        return kops.flash_attention(q, k, v, causal=True)
    if cfg.attn_impl == "flash":
        from repro_torch.models.attention_flash import flash_attention
        return flash_attention(q, k, v, True, cfg.attn_q_chunk,
                               cfg.attn_kv_chunk)
    return causal_attention(q, k, v, cfg)


def attention_block(params: Params, x: Tensor, cfg: ModelConfig,
                    positions: Tensor) -> Tensor:
    """Causal self-attention of ``x`` [b, s, d] through ``attention_impl``,
    projected back by ``wo``."""
    q, k, v = _qkv(params, x, cfg, positions)
    out = attention_impl(q, k, v, cfg)
    b, s = x.shape[:2]
    return out.reshape(b, s, -1) @ params["wo"]


def _decode_qkv(params: Params, x: Tensor, cfg: ModelConfig,
                pos: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    b = x.shape[0]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(b, 1, h, hd)
    k = (x @ params["wk"]).reshape(b, 1, kvh, hd)
    v = (x @ params["wv"]).reshape(b, 1, kvh, hd)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    return q, k, v


def attention_decode(params: Params, x: Tensor, cfg: ModelConfig,
                     k_cache: Tensor, v_cache: Tensor, pos: Tensor,
                     window: int = 0) -> Tuple[Tensor, Tensor, Tensor]:
    """Single-token decode. x:[b,1,d]; caches [b, S_max, kvh, hd]; pos [b].

    Writes the new K/V row into the caches in place and returns (out
    [b,1,d], k_cache, v_cache). With ``window`` > 0 the cache is a ring
    buffer of that length. Attention is the plain ``_sdpa_chunk``, as in
    the reference.
    """
    b = x.shape[0]
    hd = cfg.head_dim
    q, k, v = _decode_qkv(params, x, cfg, pos)
    s_max = k_cache.shape[1]
    pos = pos.long()
    slot = pos % window if window else pos
    rows = torch.arange(b, device=x.device)
    k_cache[rows, slot] = k[:, 0]
    v_cache[rows, slot] = v[:, 0]

    kv_pos = torch.arange(s_max, device=x.device)
    if window:
        valid = kv_pos[None, :] < torch.clamp(pos + 1, max=window)[:, None]
    else:
        valid = kv_pos[None, :] <= pos[:, None]
    mask = valid[:, None, :]  # [b, 1, s_max]
    out = _sdpa_chunk(q, k_cache, v_cache, mask, 1.0 / math.sqrt(hd))
    return out.reshape(b, 1, -1) @ params["wo"], k_cache, v_cache


def attention_decode_paged(params: Params, x: Tensor, cfg: ModelConfig,
                           k_pages: Tensor, v_pages: Tensor,
                           block_tables: Tensor, pos: Tensor
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """Single-token decode against a paged KV pool (serving tier).

    x:[b,1,d]; pages [num_blocks, bs, kvh, hd] (this layer's slice of the
    pool); block_tables [b, nblk] maps each session's logical block k to
    a physical page; pos [b] = tokens already cached. The new K/V row is
    written in place into page ``block_tables[i, pos // bs]`` slot
    ``pos % bs``; attention runs through ``kernels.ops.
    paged_decode_attention`` (the CUDA split-K kernel, or its plain
    gather + dense version on the CPU). Inactive batch rows should point
    their whole table at the scratch page 0 with pos 0.

    Returns (out [b,1,d], k_pages, v_pages).
    """
    b = x.shape[0]
    bs = k_pages.shape[1]
    q, k, v = _decode_qkv(params, x, cfg, pos)
    pos = pos.long()
    blk = block_tables.long().gather(1, (pos // bs)[:, None])[:, 0]
    slot = pos % bs
    # duplicate (blk, slot) targets only occur on the scratch page 0
    # (inactive rows): the undefined winner there is never read.
    k_pages[blk, slot] = k[:, 0]
    v_pages[blk, slot] = v[:, 0]
    out = kops.paged_decode_attention(q[:, 0], k_pages, v_pages,
                                      block_tables, pos + 1)
    return out.reshape(b, 1, -1) @ params["wo"], k_pages, v_pages


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> Params:
    dt = torch_dtype(cfg)
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {"wg": dense_init(gen, d, ff, dt),
            "wu": dense_init(gen, d, ff, dt),
            "wd": dense_init(gen, ff, d, dt)}


def mlp_block(params: Params, x: Tensor) -> Tensor:
    return (F.silu(x @ params["wg"]) * (x @ params["wu"])) @ params["wd"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embedding_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt = torch_dtype(cfg)
    tok = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                      dtype=torch.float32, device=gen.device)
    p = {"tok": (tok * 0.02).to(dt)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt)
    return p


def embed(params: Params, tokens: Tensor) -> Tensor:
    return params["tok"][tokens.long()]


def unembed(params: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    w = params["tok"].T if cfg.tie_embeddings else params["unembed"]
    return (x @ w).float()
