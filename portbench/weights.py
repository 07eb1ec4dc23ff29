"""Initial weights, drawn on the device from ``--seed``: one ``randn``
a leaf, in the dtype the configuration states, each leaf from a
generator of its own, so the reference and the change readings can draw
any one leaf again without the others.

The layouts are the port's parameter trees (dense ``w`` is ``[in,
out]``, layers stacked on a leading axis), written out here from the
configuration's widths; the distributions are the port's (normal over
sqrt(fan-in) for dense weights, 0.02 for the token embedding, ones for
norms, zeros for biases).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from portbench.gen import stream_seed

#: the stream of weight draws (``gen.stream_seed``)
WEIGHTS = 3

Leaf = Tuple[str, Tuple[int, ...], str, float]   # path, shape, init, scale


def lm_leaves(cfg: Dict[str, Any]) -> List[Leaf]:
    """The decoder-only LM's leaves (``"a.b"`` paths)."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    h, kvh, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    ff, vocab = cfg["ffn_dim"], cfg["vocab_size"]
    leaves = [
        ("embedding.tok", (vocab, d), "normal", 0.02),
        ("embedding.unembed", (d, vocab), "normal", 1 / math.sqrt(d)),
        ("blocks.norm1", (L, d), "ones", 1.0),
        ("blocks.attn.wq", (L, d, h * hd), "normal", 1 / math.sqrt(d)),
        ("blocks.attn.wk", (L, d, kvh * hd), "normal", 1 / math.sqrt(d)),
        ("blocks.attn.wv", (L, d, kvh * hd), "normal", 1 / math.sqrt(d)),
        ("blocks.attn.wo", (L, h * hd, d), "normal", 1 / math.sqrt(h * hd)),
        ("blocks.norm2", (L, d), "ones", 1.0),
        ("blocks.mlp.wg", (L, d, ff), "normal", 1 / math.sqrt(d)),
        ("blocks.mlp.wu", (L, d, ff), "normal", 1 / math.sqrt(d)),
        ("blocks.mlp.wd", (L, ff, d), "normal", 1 / math.sqrt(ff)),
        ("final_norm", (d,), "ones", 1.0),
    ]
    if cfg.get("frontend", "none") != "none":
        leaves.append(("frontend_norm", (d,), "ones", 1.0))
    return leaves


def mlp_leaves(cfg: Dict[str, Any]) -> List[Leaf]:
    """The paper's text model: ``fc1`` feature -> hidden, ``fc2`` hidden
    -> classes."""
    f, hid, c = cfg["feature_dim"], cfg["hidden"], cfg["num_classes"]
    return [("fc1.b", (hid,), "zeros", 0.0),
            ("fc1.w", (f, hid), "normal", 1 / math.sqrt(f)),
            ("fc2.b", (c,), "zeros", 0.0),
            ("fc2.w", (hid, c), "normal", 1 / math.sqrt(hid))]


def leaves_for(cfg: Dict[str, Any]) -> List[Leaf]:
    return {"lm": lm_leaves, "mlp": mlp_leaves}[cfg["model"]](cfg)


def dtype_of(cfg: Dict[str, Any]) -> torch.dtype:
    return getattr(torch, cfg["dtype"])


def draw_leaf(leaves: List[Leaf], index: int, seed: int,
              dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Leaf ``index`` of ``leaves`` as drawn for ``seed``."""
    _, shape, init, scale = leaves[index]
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, WEIGHTS, index))
    x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return x.mul_(scale)


def nest(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """``{"a.b": x}`` -> ``{"a": {"b": x}}``."""
    out: Dict[str, Any] = {}
    for path, x in flat.items():
        node = out
        *parents, last = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = x
    return out


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """``{"a": {"b": x}}`` -> ``{"a.b": x}``."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "."))
        else:
            out[path] = v
    return out


def draw(cfg: Dict[str, Any], seed: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """Every leaf, ``{"a.b": tensor}``."""
    leaves, dt = leaves_for(cfg), dtype_of(cfg)
    return {leaves[i][0]: draw_leaf(leaves, i, seed, dt, device)
            for i in range(len(leaves))}
