"""Public wrappers for the port's kernels.

Each checks its shapes as the JAX package's ``repro/kernels/ops.py``
does, then calls the kernel module, which runs the plain PyTorch
version for CPU and ``meta`` tensors and the Hopper kernel for CUDA
tensors.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import group_mean as _group_mean
from repro_torch.kernels import mar_rounds as _mar_rounds
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ssd_scan as _ssd

_MODULES = {"group_mean": _group_mean, "flash_attention": _flash,
            "decode_attention": _decode, "paged_decode_attention": _paged,
            "ssd_scan": _ssd, "mar_rounds": _mar_rounds}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q [b,s,h,d]; k,v [b,skv,kvh,d] -> [b,s,h,d]."""
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, "rank-4 inputs")
    _check(k.shape == v.shape, "k/v shape mismatch")
    _check(q.shape[3] == k.shape[3], "head_dim mismatch")
    _check(q.shape[2] % k.shape[2] == 0, "GQA heads must divide")
    return _flash.flash_attention_fwd(q, k, v, causal)[0]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q [b,h,d]; caches [b,S,kvh,d]; lengths [b] -> [b,h,d]."""
    _check(q.dim() == 3 and k_cache.dim() == 4, "bad ranks")
    _check(q.shape[2] == k_cache.shape[3], "head_dim mismatch")
    return _decode.decode_attention_fwd(q, k_cache, v_cache,
                                        lengths.to(torch.int32))


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q [b,h,d]; pages [nb,bs,kvh,d]; block_tables [b,nblk]; lengths [b]
    -> [b,h,d]. CUDA: the split-K kernel reading pages through the
    block table; CPU: the gather + dense einsum it is held against."""
    _check(q.dim() == 3 and k_pages.dim() == 4, "bad ranks")
    _check(q.shape[2] == k_pages.shape[3], "head_dim mismatch")
    _check(k_pages.shape == v_pages.shape, "k/v pages mismatch")
    _check(block_tables.dim() == 2 and block_tables.shape[0] == q.shape[0],
           "block_tables must be [b, nblk]")
    return _paged.paged_decode_attention_fwd(
        q, k_pages, v_pages, block_tables.to(torch.int32),
        lengths.to(torch.int32))


def group_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked MAR group mean; x [G, M, D], mask [G, M]."""
    _check(x.dim() == 3 and tuple(mask.shape) == tuple(x.shape[:2]),
           "bad shapes")
    return _group_mean.group_mean_fwd(x, mask.to(torch.float32))


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_a: torch.Tensor, h0: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked gated linear recurrence; see ``ssd_scan.py``.
    q,k [b,nh,S,dk]; v [b,nh,S,dv]; log_a [b,nh,S]; h0 [b,nh,dk,dv]
    -> (y [b,nh,S,dv] in v's dtype, h_final f32)."""
    _check(tuple(q.shape) == tuple(k.shape), "q/k shape mismatch")
    _check(tuple(q.shape[:3]) == tuple(v.shape[:3]), "v batch/seq mismatch")
    return _ssd.ssd_scan_fwd(q, k, v, log_a, h0)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since :func:`reset_launch_counts`."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
