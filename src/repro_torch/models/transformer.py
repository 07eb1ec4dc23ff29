"""Decoder stack, dense family: forward with the prefill cache, dense and
paged decode.

Port of the JAX package's ``repro/models/transformer.py`` for the dense
family. Layer params are stacked along a leading ``[L]`` axis, as in the
reference, so the carry-over is the identity; the decoder is a Python
loop over the layer views ``leaf[i]`` (the reference's ``lax.scan``).
KV caches and the paged pool are updated in place.

Families this slice does not take (moe, ssm, hybrid) and modality
frontends raise ``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.tree import Tree, tree_map

Tensor = torch.Tensor

#: families whose backbone is a run of attention + MLP blocks
DENSE_FAMILIES = ("dense", "vlm", "audio")
#: families this slice does not take, with the ROADMAP.md item that does
UNPORTED_FAMILIES = {"moe": "Queue 1 item 9", "ssm": "Queue 1 item 9",
                     "hybrid": "Queue 1 item 9"}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not take."""
    if cfg.family in UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) is not ported yet "
            f"(ROADMAP.md, {UNPORTED_FAMILIES[cfg.family]})")
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"the {cfg.frontend} frontend ({cfg.name}) is not ported yet "
            f"(ROADMAP.md, Queue 1 item 9)")
    if cfg.family not in DENSE_FAMILIES:
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


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Tree]:
    """Random parameters drawn from ``gen`` on its device."""
    check_supported(cfg)
    dt = L.torch_dtype(cfg)
    d, dev = cfg.d_model, gen.device
    params: Dict[str, Tree] = {"embedding": L.embedding_init(gen, cfg)}
    params["blocks"] = _stack(cfg.num_layers, lambda: {
        "norm1": L.rmsnorm_init(d, dt, dev),
        "attn": L.attention_init(gen, cfg),
        "norm2": L.rmsnorm_init(d, dt, dev),
        "mlp": L.mlp_init(gen, cfg),
    })
    params["final_norm"] = L.rmsnorm_init(d, dt, dev)
    return params


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _attn_mlp_block(bp: Tree, h: Tensor, cfg: ModelConfig,
                    positions: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    hn = L.rmsnorm(h, bp["norm1"], cfg.norm_eps)
    q, k, v = L._qkv(bp["attn"], hn, cfg, positions)
    att = L.attention_impl(q, k, v, cfg)
    b, s = h.shape[:2]
    h = h + att.reshape(b, s, -1) @ bp["attn"]["wo"]
    hin = L.rmsnorm(h, bp["norm2"], cfg.norm_eps)
    return h + L.mlp_block(bp["mlp"], hin), k, v


def forward(params: Tree, tokens: Tensor, cfg: ModelConfig,
            prefix_embeds: Optional[Tensor] = None,
            collect_cache: bool = False):
    """tokens: [b, s]. Returns (logits [b, s, V] f32, aux_loss, cache).

    ``aux_loss`` is 0 (no MoE here). With ``collect_cache`` the cache is
    ``{"k", "v": [L, b, s, kvh, hd], "pos": [b] int32}``.
    """
    check_supported(cfg)
    if prefix_embeds is not None:
        raise NotImplementedError("prefix embeddings come with the "
                                  "frontends (ROADMAP.md, Queue 1 item 9)")
    b, s = tokens.shape
    h = L.embed(params["embedding"], tokens)
    positions = torch.arange(s, device=h.device)
    blocks = params["blocks"]
    ks, vs = [], []
    for i in range(cfg.num_layers):
        h, k, v = _attn_mlp_block(layer(blocks, i), h, cfg, positions)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    cache = None
    if collect_cache:
        cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "pos": torch.full((b,), s, dtype=torch.int32,
                                   device=h.device)}
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embedding"], h, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return logits, aux, cache


# ---------------------------------------------------------------------------
# Decode (dense cache: the sequential baseline)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> Dict[str, Tensor]:
    """Zeroed decode cache: k, v [L, batch, max_len, kvh, hd], pos [b]."""
    check_supported(cfg)
    dt = L.torch_dtype(cfg)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _decode_layers(params: Tree, h: Tensor, cfg: ModelConfig,
                   attend: Callable[[Tree, Tensor, int], Tensor]) -> Tensor:
    blocks = params["blocks"]
    for i in range(cfg.num_layers):
        bp = layer(blocks, i)
        h = h + attend(bp["attn"], L.rmsnorm(h, bp["norm1"], cfg.norm_eps), i)
        h = h + L.mlp_block(bp["mlp"], L.rmsnorm(h, bp["norm2"],
                                                 cfg.norm_eps))
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["embedding"], h, cfg)[:, 0]


def decode_step(params: Tree, cache: Dict[str, Tensor], token: Tensor,
                cfg: ModelConfig) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One decode step. token: [b] int. Returns (logits [b, V], cache):
    the K/V rows are written into ``cache`` in place and ``pos`` moves
    on by one."""
    check_supported(cfg)
    pos = cache["pos"]
    h = L.embed(params["embedding"], token[:, None])      # [b, 1, d]

    def attend(ap, hn, i):
        return L.attention_decode(ap, hn, cfg, cache["k"][i], cache["v"][i],
                                  pos)[0]

    logits = _decode_layers(params, h, cfg, attend)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


# ---------------------------------------------------------------------------
# Prefill -> decode cache handoff
# ---------------------------------------------------------------------------

def prefill_cache_to_decode(cache: Dict[str, Tensor], cfg: ModelConfig,
                            max_len: int, seq_len: int,
                            lengths: Optional[Tensor] = None
                            ) -> Dict[str, Tensor]:
    """Convert a ``forward(collect_cache=True)`` cache into the decode
    layout of ``init_cache(cfg, b, max_len)``: pad the KV seq axis out to
    ``max_len`` (no prompt replay). ``lengths`` [b] overrides ``pos`` for
    batches prefilled on right-padded prompts (decode then overwrites the
    first pad slot and masks the rest)."""
    check_supported(cfg)
    del seq_len                       # only the recurrent families use it
    pos = cache["pos"] if lengths is None else lengths.to(torch.int32)
    s = cache["k"].shape[2]
    assert s <= max_len, (s, max_len)
    pad = (0, 0, 0, 0, 0, max_len - s)          # the seq axis of [L,b,s,kvh,hd]
    return {"k": F.pad(cache["k"], pad), "v": F.pad(cache["v"], pad),
            "pos": pos}


# ---------------------------------------------------------------------------
# Paged decode (serving tier)
# ---------------------------------------------------------------------------

PAGED_FAMILIES = ("dense",)


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device) -> Dict[str, Tensor]:
    """Zeroed paged KV pool shared by all sessions: ``[L, num_blocks,
    block_size, kvh, hd]`` per tensor. Block 0 is the engine's scratch
    page (inactive batch rows write there)."""
    check_supported(cfg)
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"paged serving of the {cfg.family} family is not ported yet "
            f"(ROADMAP.md, Queue 1 item 9)")
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
    check_supported(cfg)
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"paged serving of the {cfg.family} family is not ported yet "
            f"(ROADMAP.md, Queue 1 item 9)")
    h = L.embed(params["embedding"], token[:, None])      # [b, 1, d]

    def attend(ap, hn, i):
        return L.attention_decode_paged(ap, hn, cfg, pages["k_pages"][i],
                                        pages["v_pages"][i], block_tables,
                                        pos)[0]

    return _decode_layers(params, h, cfg, attend), pages

