"""Decoder stack: forward with the prefill cache, dense and paged decode.

Port of the JAX package's ``repro/models/transformer.py`` for the dense
family and the recurrent ones. Layer params are stacked along leading
axes, as in the reference, so the carry-over is the identity; the
decoder is a Python loop over the layer views ``leaf[i]`` (the
reference's ``lax.scan``). Heterogeneous families use *periodic groups*:

* dense           : one run of L attention blocks, ``blocks`` [L, ...]
* moe             : one run of L (attention + MoE-FFN) blocks,
                    ``blocks`` [L, ...] with ``moe`` in place of ``mlp``
* ssm (xlstm)     : G groups of (p-1 mLSTM + 1 sLSTM), p = slstm_every;
                    ``blocks.mlstm`` [G, p-1, ...], ``blocks.slstm``
                    [G, ...]
* hybrid (zamba2) : G groups of (p-1 Mamba2 + 1 SHARED attention block),
                    p = attn_every; ``blocks`` [G, p-1, ...] and one
                    ``shared_attn`` reused by every group

KV caches, recurrent states and the paged pool are updated in place.
The modality frontends raise ``NotImplementedError`` naming their
ROADMAP.md item.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.tree import Tree, tree_map

Tensor = torch.Tensor

#: families whose backbone is a run of attention + FFN blocks with a KV
#: cache (moe: the FFN is the MoE block)
DENSE_FAMILIES = ("dense", "vlm", "audio", "moe")
#: families whose decode state is recurrent (no pageable KV cache)
RECURRENT_FAMILIES = ("ssm", "hybrid")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not take."""
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"the {cfg.frontend} frontend ({cfg.name}) is not ported yet "
            f"(ROADMAP.md, Queue 1 item 9)")
    if cfg.family not in DENSE_FAMILIES + RECURRENT_FAMILIES:
        raise ValueError(cfg.family)


def group_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(num_groups, layers_per_group). Uniform families: (1, L)."""
    if cfg.family == "ssm" and cfg.slstm_every:
        p = cfg.slstm_every
        assert cfg.num_layers % p == 0, "num_layers must divide slstm_every"
        return cfg.num_layers // p, p
    if cfg.family == "hybrid" and cfg.attn_every:
        p = cfg.attn_every
        assert cfg.num_layers % p == 0, "num_layers must divide attn_every"
        return cfg.num_layers // p, p
    return 1, cfg.num_layers


def layer(params: Tree, i: int) -> Tree:
    """Layer ``i``'s view of a stacked ``[L, ...]`` tree (no copy)."""
    return tree_map(lambda x: x[i], params)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _stack(n: int, init_fn: Callable[[], Tree]) -> Tree:
    """Stack ``n`` draws of ``init_fn()`` on a leading axis, filling one
    preallocated tensor per leaf so the peak is one layer over the
    result."""
    first = init_fn()
    out = tree_map(lambda x: torch.empty((n, *x.shape), dtype=x.dtype,
                                         device=x.device), first)
    for i in range(n):
        draw = first if i == 0 else init_fn()
        tree_map(lambda dst, src: dst[i].copy_(src), out, draw)
    return out


def _attn_mlp_init(gen: torch.Generator, cfg: ModelConfig) -> Tree:
    dt, d, dev = L.torch_dtype(cfg), cfg.d_model, gen.device
    block = {"norm1": L.rmsnorm_init(d, dt, dev),
             "attn": L.attention_init(gen, cfg),
             "norm2": L.rmsnorm_init(d, dt, dev)}
    if cfg.family == "moe":
        block["moe"] = M.moe_init(gen, cfg)
    else:
        block["mlp"] = L.mlp_init(gen, cfg)
    return block


def _cell_init(gen: torch.Generator, cfg: ModelConfig, init_fn) -> Tree:
    return {"norm": L.rmsnorm_init(cfg.d_model, L.torch_dtype(cfg),
                                   gen.device),
            "cell": init_fn(gen, cfg)}


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Tree]:
    """Random parameters drawn from ``gen`` on its device."""
    check_supported(cfg)
    dt = L.torch_dtype(cfg)
    d, dev = cfg.d_model, gen.device
    g, p = group_layout(cfg)
    params: Dict[str, Tree] = {"embedding": L.embedding_init(gen, cfg)}
    if cfg.family == "ssm":
        params["blocks"] = _stack(g, lambda: {
            "mlstm": _stack(p - 1, lambda: _cell_init(gen, cfg,
                                                      S.mlstm_init)),
            "slstm": _cell_init(gen, cfg, S.slstm_init),
        })
    elif cfg.family == "hybrid":
        params["blocks"] = _stack(g, lambda: _stack(
            p - 1, lambda: _cell_init(gen, cfg, S.mamba_init)))
        params["shared_attn"] = _attn_mlp_init(gen, cfg)
    else:
        params["blocks"] = _stack(cfg.num_layers,
                                  lambda: _attn_mlp_init(gen, cfg))
    params["final_norm"] = L.rmsnorm_init(d, dt, dev)
    return params


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _ffn(bp: Tree, hin: Tensor, cfg: ModelConfig) -> Tensor:
    """The block's FFN: the MoE block where the block has one."""
    if "moe" in bp:
        return M.moe_block(bp["moe"], hin, cfg)
    return L.mlp_block(bp["mlp"], hin)


def _attn_mlp_block(bp: Tree, h: Tensor, cfg: ModelConfig,
                    positions: Tensor
                    ) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor]]:
    """(h, k, v, aux): aux is the MoE load-balance loss, None without
    MoE."""
    hn = L.rmsnorm(h, bp["norm1"], cfg.norm_eps)
    q, k, v = L._qkv(bp["attn"], hn, cfg, positions)
    att = L.attention_impl(q, k, v, cfg)
    b, s = h.shape[:2]
    h = h + att.reshape(b, s, -1) @ bp["attn"]["wo"]
    hin = L.rmsnorm(h, bp["norm2"], cfg.norm_eps)
    aux = M.load_balance_loss(bp["moe"], hin.reshape(-1, cfg.d_model),
                              cfg) if "moe" in bp else None
    return h + _ffn(bp, hin, cfg), k, v, aux


def _forward_ssm(params: Tree, h: Tensor, cfg: ModelConfig,
                 collect_cache: bool):
    """xLSTM groups; the cache holds mLSTM states [g, p-1, b, nh, hd,
    hd+1] and the sLSTM carry, four [g, b, d] f32 tensors."""
    g, p = group_layout(cfg)
    mstates, scarries = [], []
    for gi in range(g):
        gp = layer(params["blocks"], gi)
        ms = []
        for li in range(p - 1):
            lp = layer(gp["mlstm"], li)
            y, hf = S.mlstm_block(lp["cell"],
                                  L.rmsnorm(h, lp["norm"], cfg.norm_eps), cfg)
            h = h + y
            ms.append(hf)
        sp = gp["slstm"]
        y, carry = S.slstm_block(sp["cell"],
                                 L.rmsnorm(h, sp["norm"], cfg.norm_eps), cfg)
        h = h + y
        if collect_cache:
            mstates.append(torch.stack(ms))
            scarries.append(carry)
    cache = None
    if collect_cache:
        cache = {"mlstm": torch.stack(mstates),
                 "slstm": tuple(torch.stack(xs) for xs in zip(*scarries))}
    return h, cache


def _forward_hybrid(params: Tree, h: Tensor, cfg: ModelConfig,
                    positions: Tensor, collect_cache: bool):
    """zamba2 groups; the shared block runs full-causal and the cache
    keeps only its last ``w = min(window, s)`` K/V rows per group."""
    g, p = group_layout(cfg)
    shared = params["shared_attn"]
    w = min(cfg.shared_attn_window, h.shape[1])
    sstates, convs, ks, vs = [], [], [], []
    for gi in range(g):
        gp = layer(params["blocks"], gi)
        ss, cs = [], []
        for li in range(p - 1):
            lp = layer(gp, li)
            y, hf, ctail = S.mamba_block(
                lp["cell"], L.rmsnorm(h, lp["norm"], cfg.norm_eps), cfg)
            h = h + y
            ss.append(hf)
            cs.append(ctail)
        h, k, v, _ = _attn_mlp_block(shared, h, cfg, positions)
        if collect_cache:
            sstates.append(torch.stack(ss))
            convs.append(torch.stack(cs))
            ks.append(k[:, -w:])
            vs.append(v[:, -w:])
    cache = None
    if collect_cache:
        cache = {"ssm": torch.stack(sstates), "conv": torch.stack(convs),
                 "attn_k": torch.stack(ks), "attn_v": torch.stack(vs)}
    return h, cache


def forward(params: Tree, tokens: Tensor, cfg: ModelConfig,
            prefix_embeds: Optional[Tensor] = None,
            collect_cache: bool = False):
    """tokens: [b, s]. Returns (logits [b, s, V] f32, aux_loss, cache).

    ``aux_loss`` is the sum over layers of the MoE load-balance loss (0
    without MoE). With ``collect_cache`` the cache is, besides ``"pos":
    [b] int32``: dense and moe ``{"k", "v": [L, b, s, kvh, hd]}``; ssm
    ``{"mlstm", "slstm"}``; hybrid ``{"ssm", "conv", "attn_k",
    "attn_v"}`` (see :func:`init_cache`).
    """
    check_supported(cfg)
    if prefix_embeds is not None:
        raise NotImplementedError("prefix embeddings come with the "
                                  "frontends (ROADMAP.md, Queue 1 item 9)")
    b, s = tokens.shape
    h = L.embed(params["embedding"], tokens)
    positions = torch.arange(s, device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family == "ssm":
        h, cache = _forward_ssm(params, h, cfg, collect_cache)
    elif cfg.family == "hybrid":
        h, cache = _forward_hybrid(params, h, cfg, positions, collect_cache)
    else:
        blocks = params["blocks"]
        ks, vs = [], []
        for i in range(cfg.num_layers):
            h, k, v, a = _attn_mlp_block(layer(blocks, i), h, cfg,
                                         positions)
            if a is not None:
                aux = aux + a
            if collect_cache:
                ks.append(k)
                vs.append(v)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)} \
            if collect_cache else None
    if cache is not None:
        cache["pos"] = torch.full((b,), s, dtype=torch.int32,
                                  device=h.device)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embedding"], h, cfg)
    return logits, aux, cache


# ---------------------------------------------------------------------------
# Decode (dense cache: the sequential baseline; recurrent states)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> Tree:
    """Zeroed decode cache (family-dependent, as the reference's):

    * dense and moe: ``k``, ``v`` [L, batch, max_len, kvh, hd];
    * ssm: ``mlstm`` [g, p-1, batch, nh, hd, hd+1] f32 and ``slstm``, a
      tuple (h, c, n, m) of [g, batch, d] f32, all zeros as in the
      reference (a prefill starts its carry at m = -1e30 instead; the
      stabilizer cancels in h = o c / n, so both starts decode alike);
    * hybrid: ``conv`` [g, p-1, batch, width-1, inner+2n], ``ssm`` [g,
      p-1, batch, nh, n, 64] f32, and the shared block's ring ``attn_k``,
      ``attn_v`` [g, batch, min(window, max_len), kvh, hd];

    each with ``pos`` [batch] int32.
    """
    check_supported(cfg)
    dt = L.torch_dtype(cfg)
    g, p = group_layout(cfg)
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    pos = torch.zeros((batch,), dtype=torch.int32, device=device)
    if cfg.family == "ssm":
        _, mhd, nh = S.mlstm_dims(cfg)
        return {"mlstm": torch.zeros((g, p - 1, batch, nh, mhd, mhd + 1),
                                     **f32),
                "slstm": tuple(torch.zeros((g, batch, cfg.d_model), **f32)
                               for _ in range(4)),
                "pos": pos}
    if cfg.family == "hybrid":
        inner, mhd, nh = S.mamba_dims(cfg)
        n = cfg.ssm_state
        w = min(cfg.shared_attn_window, max_len)
        return {"conv": torch.zeros((g, p - 1, batch, cfg.ssm_conv_width - 1,
                                     inner + 2 * n), dtype=dt, device=device),
                "ssm": torch.zeros((g, p - 1, batch, nh, n, mhd), **f32),
                "attn_k": torch.zeros((g, batch, w, kvh, hd), dtype=dt,
                                      device=device),
                "attn_v": torch.zeros((g, batch, w, kvh, hd), dtype=dt,
                                      device=device),
                "pos": pos}
    shape = (cfg.num_layers, batch, max_len, kvh, hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": pos}


def _logits(params: Tree, h: Tensor, cfg: ModelConfig) -> Tensor:
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["embedding"], h, cfg)[:, 0]


def _decode_layers(params: Tree, h: Tensor, cfg: ModelConfig,
                   attend: Callable[[Tree, Tensor, int], Tensor]) -> Tensor:
    blocks = params["blocks"]
    for i in range(cfg.num_layers):
        bp = layer(blocks, i)
        h = h + attend(bp["attn"], L.rmsnorm(h, bp["norm1"], cfg.norm_eps), i)
        h = h + _ffn(bp, L.rmsnorm(h, bp["norm2"], cfg.norm_eps), cfg)
    return _logits(params, h, cfg)


def _decode_ssm(params: Tree, cache: Tree, h: Tensor,
                cfg: ModelConfig) -> Tensor:
    g, p = group_layout(cfg)
    mstate, scarry = cache["mlstm"], cache["slstm"]
    for gi in range(g):
        gp = layer(params["blocks"], gi)
        for li in range(p - 1):
            lp = layer(gp["mlstm"], li)
            y, st = S.mlstm_decode_step(
                lp["cell"], L.rmsnorm(h, lp["norm"], cfg.norm_eps), cfg,
                mstate[gi, li])
            h = h + y
            mstate[gi, li].copy_(st)
        sp = gp["slstm"]
        y, carry = S.slstm_decode_step(
            sp["cell"], L.rmsnorm(h, sp["norm"], cfg.norm_eps), cfg,
            tuple(x[gi] for x in scarry))
        h = h + y
        for dst, src in zip(scarry, carry):
            dst[gi].copy_(src)
    return h


def _decode_hybrid(params: Tree, cache: Tree, h: Tensor, cfg: ModelConfig,
                   pos: Tensor) -> Tensor:
    g, p = group_layout(cfg)
    shared = params["shared_attn"]
    w = cache["attn_k"].shape[2]
    for gi in range(g):
        gp = layer(params["blocks"], gi)
        for li in range(p - 1):
            lp = layer(gp, li)
            y, cst, sst = S.mamba_decode_step(
                lp["cell"], L.rmsnorm(h, lp["norm"], cfg.norm_eps), cfg,
                cache["conv"][gi, li], cache["ssm"][gi, li])
            h = h + y
            cache["conv"][gi, li].copy_(cst)
            cache["ssm"][gi, li].copy_(sst)
        hn = L.rmsnorm(h, shared["norm1"], cfg.norm_eps)
        att, _, _ = L.attention_decode(shared["attn"], hn, cfg,
                                       cache["attn_k"][gi],
                                       cache["attn_v"][gi], pos, window=w)
        h = h + att
        h = h + L.mlp_block(shared["mlp"],
                            L.rmsnorm(h, shared["norm2"], cfg.norm_eps))
    return h


def decode_step(params: Tree, cache: Tree, token: Tensor,
                cfg: ModelConfig) -> Tuple[Tensor, Tree]:
    """One decode step. token: [b] int. Returns (logits [b, V], cache):
    the K/V rows and recurrent states are written into ``cache`` in
    place and ``pos`` moves on by one."""
    check_supported(cfg)
    pos = cache["pos"]
    h = L.embed(params["embedding"], token[:, None])      # [b, 1, d]
    if cfg.family == "ssm":
        h = _decode_ssm(params, cache, h, cfg)
    elif cfg.family == "hybrid":
        h = _decode_hybrid(params, cache, h, cfg, pos)
    else:
        def attend(ap, hn, i):
            return L.attention_decode(ap, hn, cfg, cache["k"][i],
                                      cache["v"][i], pos)[0]

        return _decode_layers(params, h, cfg, attend), \
            {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
    return _logits(params, h, cfg), {**cache, "pos": pos + 1}


# ---------------------------------------------------------------------------
# Prefill -> decode cache handoff
# ---------------------------------------------------------------------------

def prefill_cache_to_decode(cache: Tree, cfg: ModelConfig, max_len: int,
                            seq_len: int,
                            lengths: Optional[Tensor] = None) -> Tree:
    """Convert a ``forward(collect_cache=True)`` cache into the decode
    layout of ``init_cache(cfg, b, max_len)`` — no prompt replay.

    * dense and moe: pad the KV seq axis out to ``max_len``.
    * ssm: states are O(1) and already decode-shaped — pass through.
    * hybrid: conv/ssm states pass through; the sliding-window KV kept by
      forward (last ``w_f = min(window, s)`` positions, in position
      order) is padded to the decode window ``w_d = min(window,
      max_len)`` and rotated so index ``j`` lands at ring slot
      ``(s - w_f + j) % w_d``, as ``attention_decode(window=w_d)``
      expects.

    ``lengths`` [b] overrides ``pos`` for batches prefilled on
    right-padded prompts (decode then overwrites the first pad slot and
    masks the rest). Only meaningful for the dense family — recurrent
    states absorb pad tokens, so ssm/hybrid must prefill at exact length.
    """
    check_supported(cfg)
    pos = cache["pos"] if lengths is None else lengths.to(torch.int32)
    if cfg.family == "ssm":
        return {"mlstm": cache["mlstm"], "slstm": cache["slstm"],
                "pos": pos}
    if cfg.family == "hybrid":
        k, v = cache["attn_k"], cache["attn_v"]     # [g, b, w_f, kvh, hd]
        w_f = k.shape[2]
        w_d = min(cfg.shared_attn_window, max_len)
        assert w_f <= w_d, (w_f, w_d)
        if w_f < w_d:
            pad = (0, 0, 0, 0, 0, w_d - w_f)
            k, v = F.pad(k, pad), F.pad(v, pad)
        # index j holds position s - w_f + j -> ring slot (s - w_f + j) % w_d
        shift = (seq_len - w_f) % w_d
        if shift:
            k = torch.roll(k, shift, dims=2)
            v = torch.roll(v, shift, dims=2)
        return {"conv": cache["conv"], "ssm": cache["ssm"],
                "attn_k": k, "attn_v": v, "pos": pos}
    s = cache["k"].shape[2]
    assert s <= max_len, (s, max_len)
    pad = (0, 0, 0, 0, 0, max_len - s)          # the seq axis of [L,b,s,kvh,hd]
    return {"k": F.pad(cache["k"], pad), "v": F.pad(cache["v"], pad),
            "pos": pos}


# ---------------------------------------------------------------------------
# Paged decode (serving tier)
# ---------------------------------------------------------------------------

PAGED_FAMILIES = ("dense", "moe")


def _check_paged(cfg: ModelConfig) -> None:
    check_supported(cfg)
    if cfg.family not in PAGED_FAMILIES:
        raise ValueError(
            f"paged KV serving needs a KV-cache family, got {cfg.family}")


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device) -> Dict[str, Tensor]:
    """Zeroed paged KV pool shared by all sessions: ``[L, num_blocks,
    block_size, kvh, hd]`` per tensor. Block 0 is the engine's scratch
    page (inactive batch rows write there). KV-cache families only —
    ssm/hybrid state is O(1)/O(window) and needs no paging."""
    _check_paged(cfg)
    dt = L.torch_dtype(cfg)
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.head_dim)
    return {"k_pages": torch.zeros(shape, dtype=dt, device=device),
            "v_pages": torch.zeros(shape, dtype=dt, device=device)}


def paged_decode_step(params: Tree, pages: Dict[str, Tensor],
                      block_tables: Tensor, pos: Tensor, token: Tensor,
                      cfg: ModelConfig) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One decode step over the paged pool. token [b] int; block_tables
    [b, nblk] int32; pos [b] = tokens already in cache (the new token
    writes at slot ``pos`` of its session's pages, in place). Returns
    (logits [b, V], pages)."""
    _check_paged(cfg)
    h = L.embed(params["embedding"], token[:, None])      # [b, 1, d]

    def attend(ap, hn, i):
        return L.attention_decode_paged(ap, hn, cfg, pages["k_pages"][i],
                                        pages["v_pages"][i], block_tables,
                                        pos)[0]

    return _decode_layers(params, h, cfg, attend), pages
