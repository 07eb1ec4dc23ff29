"""Flash-style causal GQA attention as a ``torch.autograd.Function``.

Port of the JAX package's ``repro/models/attention_flash.py``. There the
custom-VJP function is blockwise XLA code, the semantics reference of
the Pallas TPU kernel. Here the forward has one implementation per
device: the CUDA flash kernel (``kernels/flash_attention.py``) for CUDA
tensors and its plain PyTorch version for CPU tensors. It returns what
the reference's ``_flash_fwd_impl`` returns: o in q's dtype and lse
[b, kvh, g, s] in f32.

The backward (the reference recomputes the probabilities blockwise from
(o, lse)) comes with its kernel in the LM-training slice; until then it
raises.

Shapes: q [b, s, h, d]; k, v [b, skv, kvh, d]; GQA via h = g * kvh.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import flash_attention as _flash

Tensor = torch.Tensor


class FlashAttention(torch.autograd.Function):
    """(q, k, v, causal) -> (o, lse [b, kvh, g, s])."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor,
                causal: bool) -> Tuple[Tensor, Tensor]:
        o, lse = _flash.flash_attention_fwd(q, k, v, causal)
        b, s, h, _ = q.shape
        kvh = k.shape[2]
        return o, lse.view(b, kvh, h // kvh, s)

    @staticmethod
    def backward(ctx, do: Tensor, dlse: Tensor):
        raise NotImplementedError(
            "the flash attention backward (recompute from o and lse, with "
            "its kernel) is ported with LM training (ROADMAP.md, Queue 1 "
            "item 9)")


def flash_fwd(q: Tensor, k: Tensor, v: Tensor,
              causal: bool = True) -> Tuple[Tensor, Tensor]:
    """(o, lse [b, kvh, g, s]) as the reference's ``_flash_fwd_impl``."""
    return FlashAttention.apply(q, k, v, causal)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                    q_chunk: int = 1024, kv_chunk: int = 2048) -> Tensor:
    """o only, as the reference's ``flash_attention``. ``q_chunk`` and
    ``kv_chunk`` set the reference's XLA blocking; the kernel picks its
    own tiles, so they are accepted and not used."""
    del q_chunk, kv_chunk
    return FlashAttention.apply(q, k, v, causal)[0]
