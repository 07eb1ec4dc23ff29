"""Causal GQA flash attention forward — the prefill hot spot, as a CUDA
kernel.

Every prefill runs it once per layer on q [b, s, h, d] and k, v [b,
skv, kvh, d]. The kernel (``csrc/flash_attention.cu``) keeps the online
softmax state (acc, m, l) in f32 registers, walks the kv tiles up to the
causal diagonal and returns o in q's dtype and lse [b, h, s] in f32 (the
pair the JAX package's ``attention_flash._flash_fwd_impl`` returns). In
bf16 both products run on the tensor cores (``mma.sync``) from bf16
tiles that ``cp.async`` fills one tile ahead; in f32 they stay f32 FMAs
(no TF32). It replaces the Pallas TPU kernel ``flash_attention_fwd`` of
the JAX package's ``repro/kernels/flash_attention.py``; the source's
header gives its bound and design.

:func:`flash_attention_fwd` dispatches on where the tensors lie: CPU
(and ``meta``) tensors go to the plain :func:`~repro_torch.kernels.ref.
flash_attention_ref`; CUDA tensors launch the kernel or raise — there is
no fallback. ``launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

#: kernel launches since the count was last set to 0
launches = 0

_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
MAX_HEAD_DIM = 128
#: the head dim must be a multiple of this: 16-byte rows of the dtype
#: (bf16 rows are copied with ``cp.async`` in 16-byte pieces)
HEAD_DIM_MULTIPLE = {torch.float32: 4, torch.bfloat16: 8}
ALIGN = 16              # bytes, every data pointer


def check_aligned(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor's data starts on a 16-byte boundary (a
    view with a storage offset may not)."""
    if any(t.data_ptr() % ALIGN for t in tensors):
        raise ValueError(f"{kernel} kernel needs {ALIGN}-byte aligned "
                         f"inputs; got data pointers at offsets "
                         f"{[t.data_ptr() % ALIGN for t in tensors]}")


def _fn(dtype: torch.dtype):
    fn = getattr(_build.load("flash_attention"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def check_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless the kernel takes (q, k, v) as they are, device aside:
    dtypes, ranks, shapes, contiguity and 16-byte alignment."""
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes float32 or bfloat16 q, k, v of "
                        f"one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"flash kernel needs q [b,s,h,d] and k, v "
                         f"[b,skv,kvh,d]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2] != 0:
        raise ValueError(f"flash kernel: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on batch, head_dim or "
                         f"GQA grouping")
    if k.shape[1] == 0:
        raise ValueError("flash kernel needs at least one kv position")
    mult = HEAD_DIM_MULTIPLE[q.dtype]
    if d % mult != 0 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash kernel takes a {q.dtype} head_dim that is "
                         f"a multiple of {mult} and at most {MAX_HEAD_DIM}; "
                         f"got {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel needs contiguous q, k and v")
    check_aligned("flash", q, k, v)


def validate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless the CUDA kernel takes (q, k, v) as they are."""
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"flash kernel needs q, k and v on one CUDA "
                         f"device; got {q.device}, {k.device}, {v.device}")
    check_layout(q, k, v)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [b,s,h,d]; k,v [b,skv,kvh,d] -> (o [b,s,h,d] in q's dtype,
    lse [b,h,s] f32)."""
    global launches
    if q.device.type in _build.PLAIN_DEVICES:
        return flash_attention_ref(q, k, v, causal)
    # models.attention_flash.FlashAttention gives it a backward (its
    # forward runs with grad off); a bare call under autograd refuses
    _build.refuse_autograd("flash_attention", (q, k, v))
    validate(q, k, v)
    b, s, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    fn = _fn(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, s, skv, h, kvh, d, int(bool(causal)),
                 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash kernel launch failed: CUDA error {err} "
                           f"at q {tuple(q.shape)} k {tuple(k.shape)} "
                           f"{q.dtype}")
    launches += 1
    return o, lse
