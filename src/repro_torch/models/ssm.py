"""Recurrent blocks: Mamba2 (SSD), mLSTM and sLSTM (xLSTM).

Port of the JAX package's ``repro/models/ssm.py``. Mamba2 and mLSTM share
one *gated linear recurrence*: per step

    H_t = exp(a_t) * H_{t-1} + k_t^T (outer) v_t,     y_t = q_t . H_t

with a per-(head, step) scalar log-decay ``a_t <= 0``. Mamba2 maps
(q,k,v,a) = (C, B, dt*x, A*dt); mLSTM maps (q,k,v,a) = (q, k, i*v,
logsigmoid(f)) with the normalizer tracked via an appended ones-column.

The prefill's scan follows ``cfg.attn_impl`` as attention does
(``layers.attention_impl``): ``"pallas"`` and the default ``"flash"``
both call ``kernels.ops.ssd_scan`` (the CUDA kernel for CUDA tensors,
its plain sequential version for CPU tensors); ``"xla"`` stays on the
plain :func:`chunked_linear_scan`. On the TPU ``chunked_linear_scan``
was the XLA semantics reference of the Pallas kernel, which matches it
(``repro/kernels/ssd_scan.py``); here that function has one
implementation per device, the kernel on the card.

Parameters are nested dicts with the reference's keys and layouts,
drawn from a ``torch.Generator`` with the reference's distributions; the
deterministic leaves (``a_log = log(linspace(1, nheads))``, ``dt_bias``
zeros, ``d_skip`` ones, the sLSTM ``bias`` zeros) equal the reference's.

Faithfulness notes (the reference's DESIGN.md §8): mLSTM's exponential
input gate is implemented with the max-stabilizer folded into sigmoid
gating for scan stability; sLSTM keeps the exact exponential-gating
stabilizer (m_t) since it runs a sequential scan.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import chunked_linear_scan  # noqa: F401
from repro_torch.models.layers import dense_init, torch_dtype

Tensor = torch.Tensor
Carry = Tuple[Tensor, Tensor, Tensor, Tensor]


# ---------------------------------------------------------------------------
# Gated linear recurrence (shared by Mamba2 / mLSTM)
# ---------------------------------------------------------------------------

def _scan(cfg: ModelConfig, q: Tensor, k: Tensor, v: Tensor, log_a: Tensor,
          h0: Tensor) -> Tuple[Tensor, Tensor]:
    """The prefill's scan, by ``cfg.attn_impl`` (see the module doc)."""
    if cfg.attn_impl in ("pallas", "flash"):
        return kops.ssd_scan(q, k, v, log_a, h0)
    return chunked_linear_scan(q, k, v, log_a, h0)


def linear_scan_step(q: Tensor, k: Tensor, v: Tensor, log_a: Tensor,
                     h: Tensor) -> Tuple[Tensor, Tensor]:
    """Single decode step. q,k: [b, nh, dk]; v: [b, nh, dv]; log_a: [b, nh]."""
    h_new = h * torch.exp(log_a.float())[..., None, None] + \
        torch.einsum("bhd,bhv->bhdv", k.float(), v.float())
    y = torch.einsum("bhd,bhdv->bhv", q.float(), h_new)
    return y.to(v.dtype), h_new


# ---------------------------------------------------------------------------
# Depthwise causal conv (width-w, shift-add form)
# ---------------------------------------------------------------------------

def causal_conv(x: Tensor, w: Tensor, state: Optional[Tensor] = None,
                bias: Optional[Tensor] = None):
    """x: [b, S, c]; w: [width, c] depthwise taps (``w[-1]`` weighs the
    current step); ``bias`` [c] added before the SiLU. Returns y same
    shape.

    If ``state`` [b, width-1, c] is given, runs in streaming mode (decode):
    x is [b, 1, c] and the updated state is returned as well.
    """
    width = w.shape[0]
    if state is not None:
        buf = torch.cat([state, x], dim=1)             # [b, width, c]
        y = torch.einsum("bwc,wc->bc", buf, w)[:, None, :]
        if bias is not None:
            y = y + bias
        return F.silu(y), buf[:, 1:, :]
    acc = x * w[-1]
    for i in range(1, width):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i, :]
        acc = acc + shifted * w[width - 1 - i]
    if bias is not None:
        acc = acc + bias
    return F.silu(acc)


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    inner = cfg.ssm_expand * cfg.d_model
    headdim = 64
    nheads = inner // headdim
    return inner, headdim, nheads


def mamba_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = torch_dtype(cfg)
    dev = gen.device
    d, n = cfg.d_model, cfg.ssm_state
    inner, headdim, nheads = mamba_dims(cfg)
    zxbcdt = 2 * inner + 2 * n + nheads
    conv_w = torch.randn((cfg.ssm_conv_width, inner + 2 * n), generator=gen,
                         dtype=torch.float32, device=dev) * 0.1
    return {
        "in_proj": dense_init(gen, d, zxbcdt, dt),
        "conv_w": conv_w.to(dt),
        "a_log": torch.log(torch.linspace(1.0, float(nheads), nheads,
                                          dtype=torch.float32, device=dev)),
        "dt_bias": torch.zeros((nheads,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((nheads,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, inner, d, dt),
    }


def mamba_split(params: dict, x: Tensor, cfg: ModelConfig):
    n = cfg.ssm_state
    inner, _, nheads = mamba_dims(cfg)
    zxbcdt = x @ params["in_proj"]
    return torch.split(zxbcdt, [inner, inner, 2 * n, nheads], dim=-1)


def mamba_ssd(conv_out: Tensor, dt_raw: Tensor, a: Tensor, params: dict,
              cfg: ModelConfig, nheads: int, headdim: int,
              dt_min: float = 0.0, h0: Optional[Tensor] = None
              ) -> Tuple[Tensor, Tensor]:
    """The Mamba2 mixer between the conv and the gate: ``conv_out`` [b,
    S, inner + 2 n] (x, B, C after the conv), ``dt_raw`` [b, S, nheads],
    ``a`` = A [nheads] (< 0) -> (y [b, S, inner] with the D skip,
    h_final [b, nheads, n, headdim] f32).

    dt = softplus(dt_raw + dt_bias), at least ``dt_min``; the scan maps
    (q, k, v, log a) = (C, B, dt x, A dt), B and C one group shared by
    the heads (views broadcast over them, no copy).
    """
    b, s, _ = conv_out.shape
    inner = nheads * headdim
    n = (conv_out.shape[-1] - inner) // 2
    xs, bmat, cmat = torch.split(conv_out, [inner, n, n], dim=-1)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    if dt_min > 0:
        dt = torch.clamp(dt, min=dt_min)
    log_decay = (dt * a).transpose(1, 2)              # [b, nheads, S]

    xh = xs.reshape(b, s, nheads, headdim).transpose(1, 2)
    kk = bmat[:, None].expand(b, nheads, s, n)
    qq = cmat[:, None].expand(b, nheads, s, n)
    vv = xh * dt.transpose(1, 2)[..., None].to(xh.dtype)

    if h0 is None:
        h0 = torch.zeros((b, nheads, n, headdim), dtype=torch.float32,
                         device=conv_out.device)
    y, h_final = _scan(cfg, qq, kk, vv, log_decay, h0)
    y = y + xh * params["d_skip"][None, :, None, None].to(xh.dtype)
    return y.transpose(1, 2).reshape(b, s, inner), h_final


def gated_rmsnorm(y: Tensor, z: Tensor, weight: Tensor,
                  eps: float = 1e-5) -> Tensor:
    """Mamba2's gated RMSNorm of one group: ``y silu(z)`` in f32,
    normalized over the last axis, cast back to y's dtype and scaled by
    ``weight``."""
    dt = y.dtype
    x = y.float() * F.silu(z.float())
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return x.to(dt) * weight.to(dt)


def mamba_block(params: dict, x: Tensor, cfg: ModelConfig,
                h0: Optional[Tensor] = None):
    """x: [b, S, d] -> (y [b, S, d], h_final, conv_state).

    ``conv_state`` [b, width-1, inner+2n] is the raw conv-input tail
    (zero-padded when S < width-1) — exactly the streaming buffer
    ``causal_conv`` expects, so prefill hands off to
    ``mamba_decode_step`` without replaying the prompt. B and C go to
    the scan as views broadcast over the heads (no copy).
    """
    _, headdim, nheads = mamba_dims(cfg)
    z, xs, bc, dt_raw = mamba_split(params, x, cfg)
    conv_in = torch.cat([xs, bc], dim=-1)
    cw = cfg.ssm_conv_width
    conv_state = F.pad(conv_in, (0, 0, cw - 1, 0))[:, -(cw - 1):]
    conv_out = causal_conv(conv_in, params["conv_w"])
    y, h_final = mamba_ssd(conv_out, dt_raw, -torch.exp(params["a_log"]),
                           params, cfg, nheads, headdim, h0=h0)
    y = y * F.silu(z)
    return y @ params["out_proj"], h_final, conv_state


def mamba_decode_step(params: dict, x: Tensor, cfg: ModelConfig,
                      conv_state: Tensor, ssm_state: Tensor):
    """x: [b, 1, d]. conv_state: [b, w-1, inner+2n]; ssm_state [b,nh,n,hd]."""
    b = x.shape[0]
    n = cfg.ssm_state
    inner, headdim, nheads = mamba_dims(cfg)
    z, xs, bc, dt_raw = mamba_split(params, x, cfg)
    conv_in = torch.cat([xs, bc], dim=-1)
    conv_out, conv_state = causal_conv(conv_in, params["conv_w"], conv_state)
    xs, bmat, cmat = torch.split(conv_out, [inner, n, n], dim=-1)

    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    log_decay = dt * a                                # [b, nheads]
    xh = xs.reshape(b, nheads, headdim)
    kk = bmat[:, None, 0].expand(b, nheads, n)
    qq = cmat[:, None, 0].expand(b, nheads, n)
    vv = xh * dt[..., None].to(xh.dtype)
    y, ssm_state = linear_scan_step(qq, kk, vv, log_decay, ssm_state)
    y = y + xh * params["d_skip"][None, :, None].to(xh.dtype)
    y = y.reshape(b, 1, inner) * F.silu(z)
    return y @ params["out_proj"], conv_state, ssm_state


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM matrix memory)
# ---------------------------------------------------------------------------

def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    inner = cfg.ssm_expand * cfg.d_model
    nh = cfg.num_heads
    return inner, inner // nh, nh


def mlstm_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = torch_dtype(cfg)
    d = cfg.d_model
    inner, _, nh = mlstm_dims(cfg)
    return {
        "up_proj": dense_init(gen, d, 2 * inner, dt),
        "wq": dense_init(gen, inner, inner, dt),
        "wk": dense_init(gen, inner, inner, dt),
        "wv": dense_init(gen, inner, inner, dt),
        "wi": dense_init(gen, inner, nh, torch.float32),
        "wf": dense_init(gen, inner, nh, torch.float32),
        "out_proj": dense_init(gen, inner, d, dt),
    }


def _mlstm_qkvif(params: dict, x: Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    inner, hd, nh = mlstm_dims(cfg)
    up = x @ params["up_proj"]
    xi, z = up.chunk(2, dim=-1)
    q = (xi @ params["wq"]).reshape(b, s, nh, hd).transpose(1, 2)
    k = (xi @ params["wk"]).reshape(b, s, nh, hd).transpose(1, 2)
    v = (xi @ params["wv"]).reshape(b, s, nh, hd).transpose(1, 2)
    igate = torch.sigmoid(xi.float() @ params["wi"])            # [b,s,nh]
    fgate = F.logsigmoid(xi.float() @ params["wf"])
    q = q / math.sqrt(hd)
    return q, k, v, igate.transpose(1, 2), fgate.transpose(1, 2), z


def _mlstm_normalize(y_aug: Tensor) -> Tensor:
    num, den = y_aug[..., :-1], y_aug[..., -1:]
    return num / torch.clamp(den.abs(), min=1.0)


def mlstm_block(params: dict, x: Tensor, cfg: ModelConfig,
                h0: Optional[Tensor] = None):
    b, s, _ = x.shape
    inner, hd, nh = mlstm_dims(cfg)
    q, k, v, i, f, z = _mlstm_qkvif(params, x, cfg)
    # normalizer trick: append ones column to v, scaled by input gate
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    v_aug = v_aug * i[..., None].to(v.dtype)
    if h0 is None:
        h0 = torch.zeros((b, nh, hd, hd + 1), dtype=torch.float32,
                         device=x.device)
    y_aug, h_final = _scan(cfg, q, k, v_aug, f, h0)
    y = _mlstm_normalize(y_aug.float()).to(x.dtype)
    y = y.transpose(1, 2).reshape(b, s, inner)
    y = y * F.silu(z)
    return y @ params["out_proj"], h_final


def mlstm_decode_step(params: dict, x: Tensor, cfg: ModelConfig,
                      state: Tensor):
    b = x.shape[0]
    inner, _, _ = mlstm_dims(cfg)
    q, k, v, i, f, z = _mlstm_qkvif(params, x, cfg)
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    v_aug = (v_aug * i[..., None].to(v.dtype))[:, :, 0]
    y_aug, state = linear_scan_step(q[:, :, 0], k[:, :, 0], v_aug,
                                    f[:, :, 0], state)
    y = _mlstm_normalize(y_aug.float()).to(x.dtype)
    y = y.reshape(b, 1, inner) * F.silu(z)
    return y @ params["out_proj"], state


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM scalar memory, exact exponential gating + stabilizer)
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = torch_dtype(cfg)
    dev = gen.device
    d = cfg.d_model
    nh = cfg.num_heads
    hd = d // nh
    r_rec = torch.randn((nh, hd, 4 * hd), generator=gen, dtype=torch.float32,
                        device=dev) / math.sqrt(hd)
    return {
        "w_in": dense_init(gen, d, 4 * d, dt),          # z, i, f, o pre-acts
        # block-diagonal recurrent weights: per head [nh, hd, 4*hd]
        "r_rec": r_rec,
        "bias": torch.zeros((4 * d,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, d, d, dt),
    }


def slstm_cell(params: dict, xt: Tensor, carry: Carry,
               cfg: ModelConfig) -> Carry:
    """One timestep. xt: [b, 4d] pre-activations from input projection."""
    h, c, n, m = carry                                   # [b, d] each (fp32)
    nh = cfg.num_heads
    d = h.shape[-1]
    hd = d // nh
    hh = h.reshape(-1, nh, hd)
    rec = torch.einsum("bnd,ndk->bnk", hh, params["r_rec"]).reshape(-1, 4 * d)
    pre = xt.float() + rec + params["bias"]
    zt, it, ft, ot = pre.chunk(4, dim=-1)
    zt = torch.tanh(zt)
    ot = torch.sigmoid(ot)
    log_f = F.logsigmoid(ft)
    m_new = torch.maximum(log_f + m, it)                 # stabilizer
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c_new = f_p * c + i_p * zt
    n_new = f_p * n + i_p
    h_new = ot * c_new / torch.clamp(n_new, min=1e-6)
    return (h_new, c_new, n_new, m_new)


def slstm_block(params: dict, x: Tensor, cfg: ModelConfig,
                carry: Optional[Carry] = None):
    """x: [b, S, d] -> ([b, S, d], carry); sequential loop over time."""
    b, s, d = x.shape
    xin = x @ params["w_in"]                             # [b, S, 4d]
    if carry is None:
        zeros = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        carry = (zeros, zeros, zeros, torch.full((b, d), -1e30,
                                                 dtype=torch.float32,
                                                 device=x.device))
    hs = []
    for t in range(s):
        carry = slstm_cell(params, xin[:, t], carry, cfg)
        hs.append(carry[0])
    y = torch.stack(hs, dim=1).to(x.dtype)               # [b, S, d]
    return y @ params["out_proj"], carry


def slstm_decode_step(params: dict, x: Tensor, cfg: ModelConfig,
                      carry: Carry):
    xin = (x @ params["w_in"])[:, 0]
    carry = slstm_cell(params, xin, carry, cfg)
    y = carry[0][:, None, :].to(x.dtype)
    return y @ params["out_proj"], carry
