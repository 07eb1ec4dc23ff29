"""Chunked SSD scan — the recurrent families' prefill hot spot, as a CUDA
kernel.

Every Mamba2 layer (zamba2) and every mLSTM layer (xLSTM) of a prefill
runs the gated linear recurrence

    H_t = exp(a_t) H_{t-1} + k_t^T v_t;     y_t = q_t . H_t

once, over the whole prompt. The kernel (``csrc/ssd_scan.cu``) replaces
the Pallas TPU kernel ``ssd_scan_fwd`` of the JAX package's
``repro/kernels/ssd_scan.py`` and returns y in v's dtype and h_final in
f32. Its bound is the bytes (~4.0 us at zamba2's prefill, ~5.0 us at
xlstm's, on an H100); the source's header gives the numbers.

bf16 (the serving path): one block of 4 warps per (batch, head, 32- or
16-column tile of H) walks 64-step chunks. All four products run on the
tensor cores (``mma.sync``, f32 accumulators): q k^T, the gated scores
rounded to bf16 times v, q . H with H split into bf16 hi + lo, and the
state update k^T (w o v) with w o v rounded to bf16 once. H stays f32 in
shared memory. q and k stream in 64 x 64 pieces through a 3-stage
``cp.async`` ring, so they must be 16-byte aligned with batch, head and
time strides and dk that are multiples of 8, and dk <= 512 (H's tile,
its hi/lo copy and the ring fill shared memory); v and y take any
alignment (xlstm's dv = 513 puts odd rows at odd offsets), loaded a chunk
ahead into registers. f32: the f32 cores, 32-step chunks, dk <= 1024
and a multiple of 4.

q, k, v and log_a go in with their own batch, head and time strides, so
Mamba2's B and C, broadcast over the heads (a head stride of 0), are
never copied; only a tensor whose last axis is not contiguous is.
:func:`check_layout` states what each entry takes; every ssm and hybrid
config's scan inputs pass it.

:func:`ssd_scan_fwd` dispatches on where the tensors lie: CPU tensors
go to the plain :func:`~repro_torch.kernels.ref.ssd_scan_ref`, which
autograd differentiates; ``meta`` tensors (the dry run, shapes only) to
the plain chunked form :func:`~repro_torch.kernels.ref.
chunked_linear_scan`, which computes the same function in S/256 steps
where the sequential scan takes S; CUDA tensors go through
:class:`_SsdScanFn`,
whose forward launches the kernel or raises — there is no fallback —
and whose backward is the plain
:func:`~repro_torch.kernels.ref.ssd_scan_bwd`: the Pallas kernel has no
backward either, and the reference trains through the VJP of its jnp
``chunked_linear_scan``, which that function is. ``launches`` counts the
kernel launches (a remat recompute launches the forward again).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.profiler import record_function

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (chunked_linear_scan, ssd_scan_bwd,
                                     ssd_scan_ref)

#: kernel launches since the count was last set to 0
launches = 0
#: ``torch.profiler`` label of the plain backward; only a profiler reads it
SPAN_BACKWARD = "ssd_scan.backward"

_ENTRY = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
#: largest dk each entry takes
MAX_DK = {torch.float32: 1024, torch.bfloat16: 512}
#: dk must be a multiple of this (bf16: 16-byte copies of q and k)
DK_MULTIPLE = {torch.float32: 4, torch.bfloat16: 8}


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
    dtypes, ranks, shapes, and for bf16 the 16-byte copies of q and k
    (bases 16-byte aligned, batch, head and time strides multiples of 8
    elements). Checked on the tensors as launched: the wrapper first
    copies a tensor whose last axis is not contiguous."""
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
    mult, most = DK_MULTIPLE[q.dtype], MAX_DK[q.dtype]
    if dk % mult != 0 or dk > most:
        raise ValueError(f"ssd_scan kernel takes a {q.dtype} dk that is a "
                         f"multiple of {mult} and at most {most}; got {dk}")
    if nh > 65535 or b > 65535:
        raise ValueError(f"ssd_scan kernel takes at most 65535 heads and "
                         f"batch rows; got {nh}, {b}")
    if q.dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k)):
            if any(st % 8 for st in x.stride()[:3]):
                raise ValueError(f"ssd_scan bf16 kernel copies {name} in "
                                 f"16-byte pieces: its batch, head and "
                                 f"time strides must be multiples of 8; "
                                 f"got {x.stride()}")
            if x.data_ptr() % 16:
                raise ValueError(f"ssd_scan bf16 kernel copies {name} in "
                                 f"16-byte pieces: its base must be "
                                 f"16-byte aligned")


def validate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_a: torch.Tensor, h0: torch.Tensor) -> None:
    """Raise unless the CUDA kernel takes the inputs as they are."""
    dev = q.device
    if dev.type != "cuda" or any(x.device != dev for x in (k, v, log_a, h0)):
        raise ValueError(f"ssd_scan kernel needs q, k, v, log_a and h0 on "
                         f"one CUDA device; got {q.device}, {k.device}, "
                         f"{v.device}, {log_a.device}, {h0.device}")
    check_layout(q, k, v, log_a, h0)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            log_a: torch.Tensor, h0: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validate and launch the kernel once."""
    global launches
    log_a, h0 = log_a.float(), h0.float().contiguous()
    q, k, v = (_unit_last(x) for x in (q, k, v))
    validate(q, k, v, log_a, h0)
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


class _SsdScanFn(torch.autograd.Function):
    """The kernel's forward with the plain backward: the inputs are saved
    as given (Mamba2's stride-0 B and C stay views) and the backward
    recomputes the chunked scan in f32 and differentiates it."""

    @staticmethod
    def forward(ctx, q, k, v, log_a, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, log_a, h0)
        return _launch(q, k, v, log_a, h0)

    @staticmethod
    def backward(ctx, dy, dh_final):
        with record_function(SPAN_BACKWARD):
            return ssd_scan_bwd(*ctx.saved_tensors, dy, dh_final)


def ssd_scan_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_a: torch.Tensor, h0: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q,k [b,nh,S,dk]; v [b,nh,S,dv]; log_a [b,nh,S]; h0 [b,nh,dk,dv]
    -> (y [b,nh,S,dv] in v's dtype, h_final [b,nh,dk,dv] f32)."""
    if q.device.type in _build.PLAIN_DEVICES:
        if q.device.type == "meta":
            return chunked_linear_scan(q, k, v, log_a, h0)
        return ssd_scan_ref(q, k, v, log_a, h0)
    return _SsdScanFn.apply(q, k, v, log_a, h0)
