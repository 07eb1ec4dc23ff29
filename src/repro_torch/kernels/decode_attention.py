"""Split-K decode attention against a dense cache, as a CUDA kernel.

One query token per row, q [b, h, d], against caches [b, S, kvh, d]
filled up to lengths [b]. The kernel (``csrc/decode_attention.cu``, a
source it shares with the paged kernel of ``paged_attention.py``) splits
the positions over blocks, each reducing its chunk into a partial (acc,
m, l) in f32; the last block of each (row, kv head) merges them, so a
call is one launch. In bf16 the products run on the tensor cores
(``mma.sync``) from bf16 tiles that ``cp.async`` keeps two ahead; in f32
they stay f32 FMAs (no TF32). It replaces the Pallas TPU kernel
``decode_attention_fwd`` of the JAX package's
``repro/kernels/decode_attention.py``; the source's header gives its
bound and design. No model path calls it (the JAX package calls its
kernel only from its benchmarks and tests); it is the dense-cache form
of the paged kernel on the serving path.

:func:`decode_attention_fwd` dispatches on where the tensors lie: CPU
(and ``meta``) tensors go to the plain :func:`~repro_torch.kernels.ref.
decode_attention_ref`; CUDA tensors launch the kernel or raise — there
is no fallback. ``launches`` counts the kernel launches (one per call).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (HEAD_DIM_MULTIPLE,
                                                 check_aligned)
from repro_torch.kernels.ref import decode_attention_ref

#: kernel launches since the count was last set to 0
launches = 0

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_HEAD_DIM = 128
MAX_GROUP = 16          # query heads per kv head one block holds
MAX_SPLITS = 32         # splits per (row, kv head) the merge takes
#: per dtype: (positions a chunk is a multiple of, the least chunk, blocks
#: per SM the plan aims at). bf16: 4 warps x 16 positions, and two
#: sub-tiles per warp so that each keeps copies in flight; f32: the f32
#: kernel's 32-position tile, whose per-tile cost favours more, shorter
#: splits.
PLAN = {torch.bfloat16: (64, 128, 1), torch.float32: (32, 32, 2)}

#: per (device, stream): int32 counters of the splits that have stored
#: their partial, one per (row, kv head); the kernel leaves them at 0
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def entry(name: str, dtype: torch.dtype, n_pointers: int, n_ints: int):
    """``csrc/decode_attention.cu``'s ``<name>_<f32|bf16>`` with its
    argtypes: ``n_pointers`` pointers, ``n_ints`` ints, the scale and the
    stream."""
    fn = getattr(_build.load("decode_attention"),
                 f"{name}_{_DTYPES[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_pointers
                       + [ctypes.c_int] * n_ints
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(positions: int, pairs: int, sms: int,
               dtype: torch.dtype) -> Tuple[int, int]:
    """(chunk, nsplit) for ``pairs`` (row, kv head) pairs over
    ``positions`` cache positions, by ``PLAN[dtype]``: at most
    ``ceil(per_sm * sms / pairs)`` and ``MAX_SPLITS`` splits, chunks a
    multiple of the tile and at least the least chunk;
    ``chunk * nsplit >= positions`` and the last split is not empty."""
    tile, least, per_sm = PLAN[dtype]
    want = max(1, min(MAX_SPLITS, -(-per_sm * sms // max(pairs, 1))))
    chunk = max(least, -(-(-(-positions // want)) // tile) * tile)
    return chunk, -(-positions // chunk)


def counters(device: torch.device, pairs: int) -> torch.Tensor:
    """The split counters of ``device``'s current stream, at least
    ``pairs`` long: zeroed when first made (or grown), then kept at 0 by
    the kernel itself, so a call adds no launch to clear them."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index or 0, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < pairs:
        buf = torch.zeros(max(pairs, 64), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def check_common(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, kvh: int) -> None:
    """The checks the dense and paged kernels share: dtypes, q's shape
    against the kv heads, contiguity and 16-byte alignment."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode kernel takes float32 or bfloat16 q and "
                        f"cache of one dtype; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"decode kernel takes int32 lengths; got "
                        f"{lengths.dtype}")
    if q.dim() != 3 or tuple(k.shape) != tuple(v.shape) or k.dim() != 4:
        raise ValueError(f"decode kernel needs q [b,h,d] and a rank-4 "
                         f"cache; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, d = q.shape
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"decode kernel needs lengths [{b}]; got "
                         f"{tuple(lengths.shape)}")
    if k.shape[3] != d or h % kvh != 0 or h // kvh > MAX_GROUP:
        raise ValueError(f"decode kernel needs the cache's head_dim {d} and "
                         f"at most {MAX_GROUP} query heads per kv head; got "
                         f"q {tuple(q.shape)}, cache {tuple(k.shape)}")
    mult = HEAD_DIM_MULTIPLE[q.dtype]
    if d % mult != 0 or d > MAX_HEAD_DIM:
        raise ValueError(f"decode kernel takes a {q.dtype} head_dim that is "
                         f"a multiple of {mult} and at most {MAX_HEAD_DIM}; "
                         f"got {d}")
    if not all(t.is_contiguous() for t in (q, k, v, lengths)):
        raise ValueError("decode kernel needs contiguous inputs")
    check_aligned("decode", q, k, v)


def check_device(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"decode kernel needs every input on one CUDA "
                         f"device; got {[str(t.device) for t in tensors]}")


def check_layout(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor) -> None:
    """Raise unless the dense kernel takes the inputs, device aside."""
    check_common(q, k_cache, v_cache, lengths, k_cache.shape[2])
    if k_cache.shape[0] != q.shape[0] or k_cache.shape[1] == 0:
        raise ValueError(f"decode kernel needs caches [b,S>=1,kvh,d] for "
                         f"q {tuple(q.shape)}; got {tuple(k_cache.shape)}")


def launch_split(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, extra: Tuple[torch.Tensor, ...],
                 dims: Tuple[int, ...], positions: int,
                 kvh: int) -> torch.Tensor:
    """Run ``<name>`` of the shared source on non-empty q: allocate the
    output and the f32 split scratch, plan the splits and raise on a
    failed launch. ``extra`` are the pointers after q, k, v (block table,
    lengths); ``dims`` the ints before h, kvh, d."""
    b, h, d = q.shape
    out = torch.empty_like(q)
    chunk, nsplit = split_plan(positions, b * kvh,
                               _sm_count(q.device.index or 0), q.dtype)
    parts = b * kvh * nsplit
    part_acc = torch.empty(parts * (h // kvh) * d, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(parts * MAX_GROUP * 2, dtype=torch.float32,
                          device=q.device)
    fn = entry(name, q.dtype, 3 + len(extra) + 4, len(dims) + 5)
    with torch.cuda.device(q.device):
        count = counters(q.device, b * kvh)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 *(t.data_ptr() for t in extra), out.data_ptr(),
                 part_acc.data_ptr(), part_ml.data_ptr(), count.data_ptr(),
                 *dims, h, kvh, d, chunk, nsplit, 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"at q {tuple(q.shape)} cache {tuple(k.shape)} "
                           f"{q.dtype}")
    return out


def decode_attention_fwd(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q [b,h,d]; caches [b,S,kvh,d]; lengths [b] int32 -> [b,h,d]."""
    global launches
    if q.device.type in _build.PLAIN_DEVICES:
        return decode_attention_ref(q, k_cache, v_cache, lengths)
    _build.refuse_autograd("decode_attention", (q, k_cache, v_cache))
    check_device(q, k_cache, v_cache, lengths)
    check_layout(q, k_cache, v_cache, lengths)
    if q.numel() == 0:
        return torch.empty_like(q)
    b, s, kvh = k_cache.shape[0], k_cache.shape[1], k_cache.shape[2]
    out = launch_split("decode_attention", q, k_cache, v_cache, (lengths,),
                       (b, s), s, kvh)
    launches += 1
    return out
