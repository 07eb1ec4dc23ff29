"""Chunked SSD scan — the recurrent families' prefill hot spot, as a CUDA
kernel.

Every Mamba2 layer (zamba2) and every mLSTM layer (xLSTM) of a prefill
runs the gated linear recurrence

    H_t = exp(a_t) H_{t-1} + k_t^T v_t;     y_t = q_t . H_t

once, over the whole prompt. The kernel (``csrc/ssd_scan.cu``) walks the
chunks of one (batch, head, 32-column tile of H) inside a block, with the
state tile in f32 shared memory, and returns y in v's dtype and h_final
in f32. It replaces the Pallas TPU kernel ``ssd_scan_fwd`` of the JAX
package's ``repro/kernels/ssd_scan.py``; the source's header gives its
bound and design.

q, k, v and log_a go in with their own batch, head and time strides, so
Mamba2's B and C, broadcast over the heads (a head stride of 0), are
never copied; only a tensor whose last axis is not contiguous is.

:func:`ssd_scan_fwd` dispatches on where the tensors lie: CPU tensors go
to the plain :func:`~repro_torch.kernels.ref.ssd_scan_ref`; CUDA tensors
launch the kernel or raise — there is no fallback. ``launches`` counts
the kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_scan_ref

#: kernel launches since the count was last set to 0
launches = 0

_ENTRY = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
MAX_DK = 1024


def _fn(dtype: torch.dtype):
    fn = getattr(_build.load("ssd_scan"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _unit_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when its last axis is contiguous, else a copy."""
    return x if x.shape[-1] <= 1 or x.stride(-1) == 1 else x.contiguous()


def check_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_a: torch.Tensor, h0: torch.Tensor) -> None:
    """Raise unless the kernel takes (q, k, v, log_a, h0), device aside:
    dtypes, ranks and shapes (any strides; the wrapper copies only a
    tensor whose last axis is not contiguous)."""
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"ssd_scan kernel takes float32 or bfloat16 q, k, "
                        f"v of one dtype; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if log_a.dtype != torch.float32 or h0.dtype != torch.float32:
        raise TypeError(f"ssd_scan kernel takes float32 log_a and h0; got "
                        f"{log_a.dtype}, {h0.dtype}")
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) or v.dim() != 4:
        raise ValueError(f"ssd_scan kernel needs q, k [b,nh,S,dk] and v "
                         f"[b,nh,S,dv]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, nh, s, dk = q.shape
    dv = v.shape[3]
    if tuple(v.shape[:3]) != (b, nh, s) \
            or tuple(log_a.shape) != (b, nh, s) \
            or tuple(h0.shape) != (b, nh, dk, dv):
        raise ValueError(f"ssd_scan kernel: v {tuple(v.shape)}, log_a "
                         f"{tuple(log_a.shape)} and h0 {tuple(h0.shape)} "
                         f"disagree with q {tuple(q.shape)}")
    if dk % 4 != 0 or dk > MAX_DK:
        raise ValueError(f"ssd_scan kernel takes a dk that is a multiple of "
                         f"4 and at most {MAX_DK}; got {dk}")
    if nh > 65535 or b > 65535:
        raise ValueError(f"ssd_scan kernel takes at most 65535 heads and "
                         f"batch rows; got {nh}, {b}")


def validate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_a: torch.Tensor, h0: torch.Tensor) -> None:
    """Raise unless the CUDA kernel takes the inputs as they are."""
    dev = q.device
    if dev.type != "cuda" or any(x.device != dev for x in (k, v, log_a, h0)):
        raise ValueError(f"ssd_scan kernel needs q, k, v, log_a and h0 on "
                         f"one CUDA device; got {q.device}, {k.device}, "
                         f"{v.device}, {log_a.device}, {h0.device}")
    check_layout(q, k, v, log_a, h0)


def ssd_scan_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_a: torch.Tensor, h0: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q,k [b,nh,S,dk]; v [b,nh,S,dv]; log_a [b,nh,S]; h0 [b,nh,dk,dv]
    -> (y [b,nh,S,dv] in v's dtype, h_final [b,nh,dk,dv] f32)."""
    global launches
    if q.device.type == "cpu":
        return ssd_scan_ref(q, k, v, log_a, h0)
    log_a, h0 = log_a.float(), h0.float().contiguous()
    validate(q, k, v, log_a, h0)
    q, k, v = (_unit_last(x) for x in (q, k, v))
    b, nh, s, dk = q.shape
    dv = v.shape[3]
    y = torch.empty((b, nh, s, dv), dtype=v.dtype, device=v.device)
    h_out = torch.empty_like(h0)
    if h_out.numel() == 0:
        return y, h_out
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *log_a.stride())
    fn = _fn(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(),
                 h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
                 ctypes.addressof(strides), b, nh, s, dk, dv, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err} "
                           f"at q {tuple(q.shape)} v {tuple(v.shape)} "
                           f"{q.dtype}")
    launches += 1
    return y, h_out
