"""Zamba2 trained by MAR-FL, in plain PyTorch.

The equations are Zamba2-2.7B's (Zyphra, arXiv:2411.15242) as
transformers' ``Zamba2ForCausalLM`` computes them on its torch path
(``models/zamba2/modeling_zamba2.py``, version 4.57.6), written here from
that description:

* ``e`` = the token embedding (row ``pad_token_id`` takes no gradient
  from the lookup); ``h = e``;
* each of the ``num_hidden_layers`` layers is a Mamba2 layer
  ``h = h + mixer(rmsnorm(h + t))``. ``t`` is 0 in a ``"mamba"`` layer;
  in the j-th ``"hybrid"`` layer it is ``linear_j(block(concat(h, e)))``,
  where ``block`` is shared block ``j % num_mem_blocks``: RMSNorm over
  the 2d features; attention of ``num_attention_heads`` heads of
  ``attention_head_dim``, causal, scores scaled by ``(attention_head_dim
  / 2) ** -0.5``; ``o_proj``; RMSNorm; the MLP
  ``down(gelu(g) * u)`` with ``(g, u) = x gate_up + (x A_j) B_j``, the
  j-th application's own adapter, GELU in its exact erf form. The block
  has no residual of its own.
* the mixer: ``(z, xBC, dt) = x in_proj``; ``xBC = silu(conv(xBC) +
  conv_b)``, depthwise and causal over ``mamba_d_conv`` steps; ``dt =
  max(softplus(dt + dt_bias), time_step_min)``; per head the scan
  ``H_t = exp(dt_t A) H_{t-1} + B_t (dt_t x_t)^T``, ``y_t = C_t H_t +
  D x_t`` with ``A = -exp(a_log)`` and B, C shared by the heads; ``y =
  rmsnorm(y silu(z)) w``; ``y out_proj``. The scan runs in chunks of
  ``chunk_size`` steps: the products inside a chunk, the state carried
  between chunks.
* final RMSNorm; logits against the tied embedding; next-token cross
  entropy, the mean over every position.

The configuration's flags are the published 2.7B's, which
:func:`leaves` checks: one Mamba group, a conv bias, no rotary
positions, no attention adapters, tied embeddings.

Departures from the published code: none in the equations; the weights
are random (the configuration's ``init``), and every operation is
float32 with TF32 off, where the published bfloat16 model computes
softplus(dt) in bfloat16 on its torch path. Each layer is recomputed in
the backward (``torch.utils.checkpoint``) so 4,096 positions fit.

One FL iteration (``Trainer.step``) is ``lm.py``'s: each peer in turn
takes ``local_steps`` damped momentum-SGD steps on the mean gradient of
its micro-batches, theta stored in the configuration's dtype and m in
float32; then MAR over the grid (``mar.py``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import check, gen, weights
from portbench.reference import mar
from portbench.reference.lm import rmsnorm
from portbench.reference.precision import exact_float32, matmul_for

Tensor = torch.Tensor
#: leaves stacked on a leading axis: the Mamba2 layers, the shared
#: blocks, the hybrid layers' adapters and linears
STACKS = ("mamba.", "shared.", "adapters.")
MAMBA = ("norm", "in_proj", "conv_w", "conv_b", "a_log", "dt_bias",
         "d_skip", "gate_norm", "out_proj")
SHARED = ("norm1", "wq", "wk", "wv", "wo", "norm2", "gate_up", "down")
ADAPTER = ("mlp_a", "mlp_b", "linear")
#: the published 2.7B's flags, the only values this reference computes
FLAGS = {"mamba_ngroups": 1, "use_conv_bias": True, "use_mem_rope": False,
         "use_shared_attention_adapter": False, "tie_word_embeddings": True}


def leaves(cfg: Dict[str, Any]) -> List[weights.Leaf]:
    """Every leaf (``"a.b"`` path, shape, init, scale), in the layout of
    the port's ``models/zamba2.py``; ``a_log`` and ``dt_bias`` are drawn
    by :func:`draw_leaf`, the others by ``weights.draw_leaf``. Refuses a
    configuration whose flags are not :data:`FLAGS`."""
    flags = {k: cfg[k] for k in FLAGS}
    if flags != FLAGS:
        raise ValueError(f"the reference computes the flags {FLAGS}, "
                         f"not {flags}")
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    nh, hd = cfg["n_mamba_heads"], cfg["mamba_headdim"]
    inner, n = nh * hd, cfg["mamba_d_state"]
    cdim, w = inner + 2 * n, cfg["mamba_d_conv"]
    a, ff, r = (cfg["attention_hidden_size"], cfg["intermediate_size"],
                cfg["adapter_rank"])
    blocks = cfg["num_mem_blocks"]
    apps = cfg["layers_block_type"].count("hybrid")
    return [
        ("embedding.tok", (cfg["vocab_size"], d), "normal", 0.02),
        ("mamba.norm", (L, d), "ones", 1.0),
        ("mamba.in_proj", (L, d, inner + cdim + nh), "normal",
         1 / math.sqrt(d)),
        ("mamba.conv_w", (L, w, cdim), "normal", 1 / math.sqrt(3 * w)),
        ("mamba.conv_b", (L, cdim), "zeros", 0.0),
        ("mamba.a_log", (L, nh), "a_log", 0.0),
        ("mamba.dt_bias", (L, nh), "dt_bias", 0.0),
        ("mamba.d_skip", (L, nh), "ones", 1.0),
        ("mamba.gate_norm", (L, inner), "ones", 1.0),
        ("mamba.out_proj", (L, inner, d), "normal", 1 / math.sqrt(inner)),
        ("shared.norm1", (blocks, a), "ones", 1.0),
        ("shared.wq", (blocks, a, a), "normal", 1 / math.sqrt(a)),
        ("shared.wk", (blocks, a, a), "normal", 1 / math.sqrt(a)),
        ("shared.wv", (blocks, a, a), "normal", 1 / math.sqrt(a)),
        ("shared.wo", (blocks, a, d), "normal", 1 / math.sqrt(a)),
        ("shared.norm2", (blocks, d), "ones", 1.0),
        ("shared.gate_up", (blocks, d, 2 * ff), "normal", 1 / math.sqrt(d)),
        ("shared.down", (blocks, ff, d), "normal", 1 / math.sqrt(ff)),
        ("adapters.mlp_a", (apps, d, r), "normal", 1 / math.sqrt(d)),
        ("adapters.mlp_b", (apps, r, 2 * ff), "normal", 1 / math.sqrt(r)),
        ("adapters.linear", (apps, d, d), "normal", 1 / math.sqrt(d)),
        ("final_norm", (d,), "ones", 1.0),
    ]


def draw_leaf(cfg: Dict[str, Any], index: int, seed: int,
              dtype: torch.dtype, device: torch.device) -> Tensor:
    """Leaf ``index`` of :func:`leaves` as drawn for ``seed``: ``a_log``
    is log(1..heads) in every layer; ``dt_bias`` softplus^-1 of dt drawn
    log-uniform in [time_step_min, time_step_max] (at least
    time_step_floor), each layer its own, from the leaf's own generator."""
    table = leaves(cfg)
    _, shape, init, _ = table[index]
    if init == "a_log":
        a = torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                         device=device)
        return torch.log(a).expand(shape).to(dtype).contiguous()
    if init == "dt_bias":
        g = torch.Generator(device=device).manual_seed(
            gen.stream_seed(seed, weights.WEIGHTS, index))
        u = torch.rand(shape, generator=g, dtype=torch.float32,
                       device=device)
        lo, hi = math.log(cfg["time_step_min"]), math.log(cfg["time_step_max"])
        dt = torch.exp(u * (hi - lo) + lo).clamp(min=cfg["time_step_floor"])
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    return weights.draw_leaf(table, index, seed, dtype, device)


def draw(cfg: Dict[str, Any], seed: int,
         device: torch.device) -> Dict[str, Tensor]:
    """Every leaf, ``{"a.b": tensor}``, in the configuration's dtype."""
    dt = weights.dtype_of(cfg)
    return {path: draw_leaf(cfg, i, seed, dt, device)
            for i, (path, *_) in enumerate(leaves(cfg))}


def change_norms(params: Dict[str, Tensor], cfg: Dict[str, Any],
                 seed: int) -> Dict[str, float]:
    """Each leaf's norm of ``params - theta0`` over all peers, theta0
    drawn again leaf by leaf (``check.change_norms`` for this layout)."""
    dt, out = weights.dtype_of(cfg), {}
    for i, (path, *_) in enumerate(leaves(cfg)):
        x = params[path]
        theta0 = draw_leaf(cfg, i, seed, dt, x.device)
        out[path] = math.sqrt(sum(check.sumsq(x[p], theta0)
                                  for p in range(x.shape[0])))
        del theta0
    return out


# -- the model ---------------------------------------------------------------

def _conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv: x [b, S, c], w [width, c] (``w[-1]`` on the
    current step), then the bias and SiLU."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    y = sum(xp[:, i:i + s] * w[i] for i in range(width))
    return F.silu(y + b)


def ssd(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor,
        chunk: int) -> Tensor:
    """The selective scan: x [b, S, nh, p], dt [b, S, nh], A [nh], B, C
    [b, S, nh, n] -> y [b, S, nh, p] (without the D skip), in chunks."""
    b, s, nh, p = x.shape
    n = B.shape[-1]
    state = x.new_zeros(b, nh, n, p)
    ys = []
    for c0 in range(0, s, chunk):
        xc, dtc = x[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
        Bc, Cc = B[:, c0:c0 + chunk], C[:, c0:c0 + chunk]
        L = xc.shape[1]
        acs = torch.cumsum(dtc * A, dim=1)                  # [b, L, nh]
        u = xc * dtc[..., None]                             # dt x
        # within the chunk: (C_i . B_j) exp(acs_i - acs_j) for j <= i
        seg = acs[:, :, None, :] - acs[:, None, :, :]       # [b, i, j, nh]
        causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        decay = torch.where(causal[None, :, :, None], seg, -math.inf).exp()
        scores = torch.einsum("bihn,bjhn->bijh", Cc, Bc) * decay
        y = torch.einsum("bijh,bjhp->bihp", scores, u)
        # from the state before the chunk
        y = y + torch.einsum("bihn,bhnp->bihp", Cc, state) \
            * acs.exp()[..., None]
        ys.append(y)
        last = acs[:, -1]                                   # [b, nh]
        w = (last[:, None, :] - acs).exp()                  # [b, L, nh]
        state = state * last.exp()[..., None, None] \
            + torch.einsum("bjhn,bjhp->bhnp", Bc * w[..., None], u)
    return torch.cat(ys, dim=1)


def mamba_layer(h: Tensor, t: Any, norm, in_proj, conv_w, conv_b, a_log,
                dt_bias, d_skip, gate_norm, out_proj, *,
                cfg: Dict[str, Any], mm: Callable) -> Tensor:
    b, s, _ = h.shape
    nh, p = cfg["n_mamba_heads"], cfg["mamba_headdim"]
    n, eps = cfg["mamba_d_state"], cfg["rms_norm_eps"]
    inner = nh * p
    x = rmsnorm(h if t is None else h + t, norm, eps)
    z, xbc, dt = torch.split(mm(x, in_proj), [inner, inner + 2 * n, nh],
                             dim=-1)
    xbc = _conv(xbc, conv_w, conv_b)
    xs, B, C = torch.split(xbc, [inner, n, n], dim=-1)
    dt = F.softplus(dt + dt_bias).clamp(min=cfg["time_step_min"])
    xs = xs.reshape(b, s, nh, p)
    B, C = (m[:, :, None].expand(b, s, nh, n) for m in (B, C))
    y = ssd(xs, dt, -torch.exp(a_log), B, C, cfg["chunk_size"])
    y = (y + xs * d_skip[:, None]).reshape(b, s, inner)
    y = y * F.silu(z)
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + 1e-5)
    return h + mm(y * gate_norm, out_proj)


def shared_block(h: Tensor, e: Tensor, norm1, wq, wk, wv, wo, norm2,
                 gate_up, down, mlp_a, mlp_b, linear, *, cfg: Dict[str, Any],
                 mm: Callable) -> Tensor:
    """``linear(block(concat(h, e)))`` of one hybrid layer, ``mlp_a`` and
    ``mlp_b`` its MLP's adapter."""
    b, s, _ = h.shape
    nh, hd, eps = (cfg["num_attention_heads"], cfg["attention_head_dim"],
                   cfg["rms_norm_eps"])
    x = rmsnorm(torch.cat([h, e], dim=-1), norm1, eps)
    # [b, heads, s, d]
    q, k, v = (mm(x, wt).view(b, s, nh, hd).transpose(1, 2)
               for wt in (wq, wk, wv))
    scores = mm(q, k.transpose(-1, -2)) * (hd / 2) ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    att = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = mm(mm(att, v).transpose(1, 2).reshape(b, s, nh * hd), wo)
    x = rmsnorm(o, norm2, eps)
    gu = mm(x, gate_up) + mm(mm(x, mlp_a), mlp_b)
    gate, up = gu.chunk(2, dim=-1)
    return mm(mm(F.gelu(gate) * up, down), linear)


def logits(W: Dict[str, Any], tokens: Tensor, cfg: Dict[str, Any],
           mm: Callable) -> Tensor:
    """``W``: float32 leaves, each stacked leaf a list of its entries."""
    e = F.embedding(tokens.long(), W["embedding.tok"],
                    padding_idx=cfg["pad_token_id"])
    h, j = e, 0
    kw = dict(cfg=cfg, mm=mm)
    for i, kind in enumerate(cfg["layers_block_type"]):
        mp = [W["mamba." + k][i] for k in MAMBA]
        if kind == "hybrid":
            bp = [W["shared." + k][j % cfg["num_mem_blocks"]] for k in SHARED]
            ap = [W["adapters." + k][j] for k in ADAPTER]
            j += 1

            def layer(h, e, *ws, kw=kw):
                t = shared_block(h, e, *ws[len(MAMBA):], **kw)
                return mamba_layer(h, t, *ws[:len(MAMBA)], **kw)

            h = checkpoint(layer, h, e, *mp, *bp, *ap, use_reentrant=False)
        else:
            h = checkpoint(mamba_layer, h, None, *mp, use_reentrant=False,
                           **kw)
    h = rmsnorm(h, W["final_norm"], cfg["rms_norm_eps"])
    return mm(h, W["embedding.tok"].T)


def loss(W: Dict[str, Any], tokens: Tensor, labels: Tensor,
         cfg: Dict[str, Any], mm: Callable) -> Tensor:
    out = logits(W, tokens, cfg, mm)
    return F.cross_entropy(out.reshape(-1, out.shape[-1]),
                           labels.reshape(-1).long())


# -- MAR-FL ------------------------------------------------------------------

class Trainer:
    """The reference's FL state: every leaf ``[peers, ...]``, theta in the
    configuration's dtype, m in float32, all peers from theta0."""

    def __init__(self, cfg: Dict[str, Any], mix: Dict[str, Any], seed: int,
                 device: torch.device, precision: str = "float32"):
        self.cfg, self.mix = cfg, mix
        self.mm = matmul_for(precision)
        self.paths = [p for p, *_ in leaves(cfg)]
        self.theta: Dict[str, Tensor] = {}
        self.m: Dict[str, Tensor] = {}
        for path, x in draw(cfg, seed, device).items():
            self.theta[path] = x.unsqueeze(0).repeat(
                mix["peers"], *([1] * x.dim()))
            self.m[path] = torch.zeros(self.theta[path].shape,
                                       dtype=torch.float32, device=device)
            del x

    @staticmethod
    def _stacked(path: str) -> bool:
        return path.startswith(STACKS)

    def _parts(self, tree: Dict[str, Tensor], path: str, peer: int
               ) -> List[Tensor]:
        x = tree[path][peer]
        return list(x.unbind(0)) if self._stacked(path) else [x]

    def _peer_update(self, peer: int, tokens: Tensor, labels: Tensor
                     ) -> float:
        """``local_steps`` SGDM steps of one peer; its mean loss."""
        lr, mu = self.cfg["lr"], self.cfg["momentum"]
        n_steps, n_micro = tokens.shape[:2]
        losses = []
        for b in range(n_steps):
            W = {p: [t.to(torch.float32, copy=True).requires_grad_()
                     for t in self._parts(self.theta, p, peer)]
                 for p in self.paths}
            flat = [t for p in self.paths for t in W[p]]
            W = {p: (ts if self._stacked(p) else ts[0])
                 for p, ts in W.items()}
            gsum: List[Any] = [None] * len(flat)
            lsum = 0.0
            for u in range(n_micro):
                value = loss(W, tokens[b, u], labels[b, u], self.cfg, self.mm)
                grads = torch.autograd.grad(value, flat, allow_unused=True)
                for j, g in enumerate(grads):
                    if g is not None:
                        gsum[j] = g if gsum[j] is None else gsum[j] + g
                lsum += float(value.detach())
                del grads, value
            del W, flat
            j = 0
            for p in self.paths:
                for t, m in zip(self._parts(self.theta, p, peer),
                                self._parts(self.m, p, peer)):
                    g = (torch.zeros_like(m) if gsum[j] is None
                         else gsum[j] / n_micro)
                    gsum[j] = None
                    new_m = mu * m + (1.0 - mu) * g
                    t.copy_(t.float() - lr * new_m)
                    m.copy_(new_m)
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
        out["change"] = change_norms(tr.theta, cfg, seed)
    return out
