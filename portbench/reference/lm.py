"""The decoder-only LM trained by MAR-FL, in plain PyTorch.

The equations are those the configuration states: token embedding;
per layer, pre-RMSNorm causal multi-head attention with rotary
positions (half-split pairs) and a residual, then pre-RMSNorm SwiGLU
(``silu(x Wg) * (x Wu)) Wd``) and a residual; final RMSNorm; untied
unembedding; next-token cross entropy, the mean over every position.
Every operation is float32 with TF32 off; each layer is recomputed in
the backward (``torch.utils.checkpoint``) so a long sequence fits.

One FL iteration (``train``): each peer in turn takes ``local_steps``
damped momentum-SGD steps (``m = mu m + (1 - mu) g``, ``theta = theta
- lr m``) on the mean gradient of its micro-batches, with theta stored in
the configuration's dtype and m in float32; then MAR over the grid
(``mar.py``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import check, gen, weights
from portbench.reference import mar
from portbench.reference.precision import exact_float32, matmul_for

Tensor = torch.Tensor
BLOCK = ("blocks.norm1", "blocks.attn.wq", "blocks.attn.wk",
         "blocks.attn.wv", "blocks.attn.wo", "blocks.norm2",
         "blocks.mlp.wg", "blocks.mlp.wu", "blocks.mlp.wd")


def rmsnorm(x: Tensor, w: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: Tensor, theta: float) -> Tensor:
    """x [b, s, heads, d]: pairs (i, i + d/2) rotated by position."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(x.shape[1], dtype=torch.float32,
                       device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def block(h: Tensor, n1, wq, wk, wv, wo, n2, wg, wu, wd, *,
          cfg: Dict[str, Any], mm: Callable) -> Tensor:
    b, s, _ = h.shape
    nh, kvh, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    x = rmsnorm(h, n1, eps)
    q = rope(mm(x, wq).view(b, s, nh, hd), theta)
    k = rope(mm(x, wk).view(b, s, kvh, hd), theta)
    v = mm(x, wv).view(b, s, kvh, hd)
    if kvh != nh:                       # query head j reads kv head j // g
        k = k.repeat_interleave(nh // kvh, dim=2)
        v = v.repeat_interleave(nh // kvh, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = mm(p, v).transpose(1, 2).reshape(b, s, nh * hd)
    h = h + mm(o, wo)
    x = rmsnorm(h, n2, eps)
    return h + mm(F.silu(mm(x, wg)) * mm(x, wu), wd)


def loss(W: Dict[str, Any], tokens: Tensor, labels: Tensor,
         cfg: Dict[str, Any], mm: Callable) -> Tensor:
    """``W``: float32 leaves, the block leaves as per-layer lists."""
    h = W["embedding.tok"][tokens.long()]
    for i in range(cfg["num_hidden_layers"]):
        h = checkpoint(block, h, *(W[k][i] for k in BLOCK),
                       use_reentrant=False, cfg=cfg, mm=mm)
    h = rmsnorm(h, W["final_norm"], cfg["norm_eps"])
    logits = mm(h, W["embedding.unembed"])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


class Trainer:
    """The reference's FL state: every leaf ``[peers, ...]``, theta in
    the configuration's dtype, m in float32, all peers from theta0."""

    def __init__(self, cfg: Dict[str, Any], mix: Dict[str, Any], seed: int,
                 device: torch.device, precision: str = "float32"):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.mm = matmul_for(precision)
        self.leaves = weights.lm_leaves(cfg)
        dt, p = weights.dtype_of(cfg), mix["peers"]
        self.theta: Dict[str, Tensor] = {}
        self.m: Dict[str, Tensor] = {}
        for i, (path, shape, *_) in enumerate(self.leaves):
            x = weights.draw_leaf(self.leaves, i, seed, dt, device)
            self.theta[path] = x.unsqueeze(0).repeat(p, *([1] * x.dim()))
            self.m[path] = torch.zeros((p, *shape), dtype=torch.float32,
                                       device=device)
            del x

    def _working(self, peer: int) -> Dict[str, Any]:
        W: Dict[str, Any] = {}
        for path, *_ in self.leaves:
            x = self.theta[path][peer]
            if path in BLOCK:
                W[path] = [t.to(torch.float32, copy=True).requires_grad_()
                           for t in x.unbind(0)]
            else:
                W[path] = x.to(torch.float32, copy=True).requires_grad_()
        return W

    def _peer_update(self, peer: int, tokens: Tensor, labels: Tensor
                     ) -> float:
        """``local_steps`` SGDM steps of one peer; its mean loss."""
        cfg, lr, mu = self.cfg, self.cfg["lr"], self.cfg["momentum"]
        n_steps, n_micro = tokens.shape[:2]
        losses = []
        for b in range(n_steps):
            W = self._working(peer)
            flat = [t for path, *_ in self.leaves
                    for t in (W[path] if path in BLOCK else [W[path]])]
            gsum: List[Any] = [None] * len(flat)
            lsum = 0.0
            for u in range(n_micro):
                value = loss(W, tokens[b, u], labels[b, u], cfg, self.mm)
                grads = torch.autograd.grad(value, flat, allow_unused=True)
                for j, g in enumerate(grads):
                    if g is not None:
                        gsum[j] = g if gsum[j] is None else gsum[j] + g
                lsum += float(value.detach())
                del grads, value
            del W, flat
            j = 0
            for path, *_ in self.leaves:
                th, m = self.theta[path][peer], self.m[path][peer]
                parts = ([(th[i], m[i]) for i in range(th.shape[0])]
                         if path in BLOCK else [(th, m)])
                for t, mm_ in parts:
                    g = (torch.zeros_like(mm_) if gsum[j] is None
                         else gsum[j] / n_micro)
                    gsum[j] = None
                    new_m = mu * mm_ + (1.0 - mu) * g
                    t.copy_(t.float() - lr * new_m)
                    mm_.copy_(new_m)
                    j += 1
            losses.append(lsum / n_micro)
        return sum(losses) / len(losses)

    def step(self, batch: Dict[str, Tensor]) -> float:
        """One FL iteration; the mean over peers of each peer's loss."""
        losses = [self._peer_update(i, batch["tokens"][i],
                                    batch["labels"][i])
                  for i in range(self.mix["peers"])]
        with torch.no_grad():
            mar.aggregate_(self.theta, self.mix["grid"])
            mar.aggregate_(self.m, self.mix["grid"])
        return sum(losses) / len(losses)


def readings(cfg: Dict[str, Any], mix: Dict[str, Any], seed: int,
             device: torch.device, steps: int,
             precision: str = "float32") -> Dict[str, Any]:
    """The check steps' readings (``check.py``), the same inputs as the
    port's set-up drew."""
    with exact_float32():
        tr = Trainer(cfg, mix, seed, device, precision)
        out: Dict[str, Any] = {"loss": []}
        for k in range(steps):
            batch = gen.lm_batch(mix, cfg["vocab_size"], seed, gen.CHECK, k,
                                 device)
            out["loss"].append(tr.step(batch))
            if k == 0:
                out["grad"] = check.grad_norms(tr.m, cfg["momentum"])
        out["change"] = check.change_norms(tr.theta, cfg, seed)
    return out
