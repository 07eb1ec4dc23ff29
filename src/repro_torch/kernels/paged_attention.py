"""Paged decode attention — the decode-step hot spot, as a CUDA kernel.

The serving tier stores KV in fixed-size pages (``[num_blocks,
block_size, kvh, d]``) owned by a host-side allocator; each session holds
a block-table row mapping its logical positions to pages
(``serve/paged_cache.py``). Every decode step runs this once per layer:
one query token per row against that row's pages, masked beyond
``lengths``. The kernel is the paged entry of ``csrc/decode_attention.cu``
(the split-K recurrence of ``decode_attention.py``, one launch per call,
tensor cores in bf16; each page is looked up once in the block table per
16-position sub-tile). It replaces the Pallas TPU
kernel ``paged_decode_attention_fwd`` of the JAX package's
``repro/kernels/paged_attention.py``; the source's header gives its
bound and design.

:func:`paged_decode_attention_fwd` dispatches on where the tensors lie:
CPU tensors go to the plain :func:`gather_dense_decode`; CUDA tensors
launch the kernel or raise — there is no fallback. ``launches`` counts
the kernel launches (one per call: the splits merge inside it).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels.ref import NEG_INF

#: kernel launches since the count was last set to 0
launches = 0


def gather_dense_decode(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """The plain version: gather each row's pages into a dense [b,
    nblk*bs, kvh, d] view and run the dense decode einsum.

    Mirrors ``models.layers._sdpa_chunk`` op for op (f32 scores and
    softmax, probabilities cast back to the value dtype), so the paged
    serve path agrees with the dense-cache path on the CPU exactly as in
    the JAX package.
    """
    b, h, d = q.shape
    bs, kvh = k_pages.shape[1], k_pages.shape[2]
    nblk = block_tables.shape[1]
    s = nblk * bs
    g = h // kvh
    scale = 1.0 / math.sqrt(d)

    bt = block_tables.long()
    k = k_pages[bt].reshape(b, s, kvh, d)
    v = v_pages[bt].reshape(b, s, kvh, d)
    qg = q.reshape(b, 1, kvh, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(b, 1, h, d)[:, 0]


def check_layout(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, block_tables: torch.Tensor,
                 lengths: torch.Tensor) -> None:
    """Raise unless the paged kernel takes the inputs, device aside."""
    _decode.check_common(q, k_pages, v_pages, lengths, k_pages.shape[2])
    if block_tables.dtype != torch.int32:
        raise TypeError(f"paged kernel takes an int32 block table; got "
                        f"{block_tables.dtype}")
    if block_tables.dim() != 2 or block_tables.shape[0] != q.shape[0] \
            or block_tables.shape[1] == 0 or k_pages.shape[1] == 0:
        raise ValueError(f"paged kernel needs block_tables [b, nblk>=1] and "
                         f"pages [nb, bs>=1, kvh, d]; got "
                         f"{tuple(block_tables.shape)} and "
                         f"{tuple(k_pages.shape)}")
    if not block_tables.is_contiguous():
        raise ValueError("paged kernel needs a contiguous block table")


def paged_decode_attention_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               block_tables: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """q [b,h,d]; pages [nb,bs,kvh,d]; block_tables [b,nblk] int32;
    lengths [b] int32 -> [b,h,d]. Table entries must name pages of the
    pool (the kernel reads them unchecked)."""
    global launches
    if q.device.type == "cpu":
        return gather_dense_decode(q, k_pages, v_pages, block_tables,
                                   lengths)
    _build.refuse_autograd("paged_decode_attention",
                           (q, k_pages, v_pages))
    _decode.check_device(q, k_pages, v_pages, block_tables, lengths)
    check_layout(q, k_pages, v_pages, block_tables, lengths)
    if q.numel() == 0:
        return torch.empty_like(q)
    bs, kvh = k_pages.shape[1], k_pages.shape[2]
    b, nblk = block_tables.shape
    out = _decode.launch_split("paged_decode_attention", q, k_pages,
                               v_pages, (block_tables, lengths),
                               (b, bs, nblk), nblk * bs, kvh)
    launches += 1
    return out
