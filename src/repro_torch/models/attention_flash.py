"""Flash-style causal GQA attention as a ``torch.autograd.Function``.

Port of the JAX package's ``repro/models/attention_flash.py``. There the
custom-VJP function is blockwise XLA code, the semantics reference of
the Pallas TPU kernel. Here the forward has one implementation per
device: the CUDA flash kernel (``kernels/flash_attention.py``) for CUDA
tensors and its plain PyTorch version for CPU tensors. It returns what
the reference's ``_flash_fwd_impl`` returns: o in q's dtype and lse
[b, kvh, g, s] in f32.

The backward is the reference's ``_flash_bwd`` in plain PyTorch: from
the saved (q, k, v, o, lse) it recomputes the probabilities block by
block (the reference's ``_chunks`` of ``q_chunk`` and ``kv_chunk``),
so no [s, s] matrix is kept between forward and backward. The
reference's backward is plain jnp too, so there is no TPU kernel behind
it; a Hopper kernel for it is perf work (ROADMAP.md, Queue 2 #2b). As
in the reference, the gradient is that of o alone: a gradient arriving
for lse raises. The backward runs under the ``torch.profiler`` label
``flash_attention.backward``.

Shapes: q [b, s, h, d]; k, v [b, skv, kvh, d]; GQA via h = g * kvh.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels.ref import NEG_INF

Tensor = torch.Tensor

#: profiler label of the plain backward (``FlashAttention.backward``)
SPAN_BACKWARD = "flash_attention.backward"


def _chunks(s: int, target: int) -> int:
    """The largest block size <= ``target`` that divides ``s``."""
    c = min(target, s)
    while s % c != 0:
        c -= 1
    return c


def _grouped(x: Tensor, kvh: int) -> Tensor:
    """[b, s, h, d] -> [b, kvh, g, s, d] in f32."""
    b, s, h, d = x.shape
    return x.reshape(b, s, kvh, h // kvh, d).permute(0, 2, 3, 1, 4).float()


def flash_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
              do: Tensor, causal: bool, q_chunk: int = 1024,
              kv_chunk: int = 2048, scale: Optional[float] = None
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv) in the inputs' dtypes, from o's cotangent ``do``;
    ``scale`` is the forward's (1/sqrt(d) where it is None).

    For each kv block and each q block: P = exp(S - lse) recomputed,
    dP = dO V^T, dS = P (dP - delta) scale with delta = rowsum(dO o);
    dq += dS K, dk += dS^T Q and dv += P^T dO, all in f32. dk and dv sum
    over the g query heads of each kv head.
    """
    b, s, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qc, kc = _chunks(s, q_chunk), _chunks(skv, kv_chunk)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg, og, dog = (_grouped(x, kvh) for x in (q, o, do))
    kg = k.permute(0, 2, 1, 3).float()                   # [b, kvh, skv, d]
    vg = v.permute(0, 2, 1, 3).float()
    lse = lse.float()                                    # [b, kvh, g, s]
    delta = (dog * og).sum(-1)                           # [b, kvh, g, s]
    dq = torch.zeros_like(qg)
    dk = torch.zeros_like(kg)
    dv = torch.zeros_like(vg)
    for j0 in range(0, skv, kc):
        k_j, v_j = kg[:, :, j0:j0 + kc], vg[:, :, j0:j0 + kc]
        kv_pos = torch.arange(j0, j0 + kc, device=q.device)
        for i0 in range(0, s, qc):
            q_i = qg[:, :, :, i0:i0 + qc]
            do_i = dog[:, :, :, i0:i0 + qc]
            sc = torch.einsum("bkgqd,bksd->bkgqs", q_i, k_j) * scale
            if causal:
                q_pos = torch.arange(i0, i0 + qc, device=q.device)
                sc = torch.where(q_pos[:, None] >= kv_pos[None, :], sc,
                                 NEG_INF)
            p = torch.exp(sc - lse[:, :, :, i0:i0 + qc, None])
            dp = torch.einsum("bkgqd,bksd->bkgqs", do_i, v_j)
            ds = p * (dp - delta[:, :, :, i0:i0 + qc, None]) * scale
            dk[:, :, j0:j0 + kc] += torch.einsum("bkgqs,bkgqd->bksd", ds,
                                                 q_i)
            dv[:, :, j0:j0 + kc] += torch.einsum("bkgqs,bkgqd->bksd", p,
                                                 do_i)
            dq[:, :, :, i0:i0 + qc] += torch.einsum("bkgqs,bksd->bkgqd",
                                                    ds, k_j)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """(q, k, v, causal, q_chunk, kv_chunk, scale) -> (o, lse [b, kvh,
    g, s]). The chunks set the backward's blocks; the kernel picks its
    own. ``scale`` multiplies the scores (1/sqrt(d) where it is None)
    in the forward and the backward alike."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor, causal: bool,
                q_chunk: int, kv_chunk: int,
                scale: Optional[float] = None) -> Tuple[Tensor, Tensor]:
        o, lse = _flash.flash_attention_fwd(q, k, v, causal, scale)
        b, s, h, _ = q.shape
        kvh = k.shape[2]
        lse = lse.view(b, kvh, h // kvh, s)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.blocks = (causal, q_chunk, kv_chunk, scale)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do: Tensor, dlse: Tensor):
        if dlse is not None:
            raise NotImplementedError(
                "the flash attention backward is that of o alone, as the "
                "reference's custom VJP; lse takes no gradient")
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            return None, None, None, None, None, None, None
        causal, q_chunk, kv_chunk, scale = ctx.blocks
        with record_function(SPAN_BACKWARD):
            dq, dk, dv = flash_bwd(q, k, v, o, lse, do, causal, q_chunk,
                                   kv_chunk, scale)
        return dq, dk, dv, None, None, None, None


def flash_fwd(q: Tensor, k: Tensor, v: Tensor,
              causal: bool = True) -> Tuple[Tensor, Tensor]:
    """(o, lse [b, kvh, g, s]) as the reference's ``_flash_fwd_impl``."""
    return FlashAttention.apply(q, k, v, causal, 1024, 2048)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                    q_chunk: int = 1024, kv_chunk: int = 2048) -> Tensor:
    """o only, as the reference's ``flash_attention``. ``q_chunk`` and
    ``kv_chunk`` are the reference's XLA blocks, which the backward
    follows; the forward kernel picks its own tiles."""
    return FlashAttention.apply(q, k, v, causal, q_chunk, kv_chunk)[0]
