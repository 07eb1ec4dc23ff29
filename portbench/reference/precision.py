"""The reference's matrix products, in the precision a run asks for.

``float32`` is the plain product with TF32 off (``exact_float32``). The
lower precisions are the controls, the reference put in the port's
place one step below the precision the configuration states: ``tf32``
rounds both operands (and, in the backward, the incoming gradient) to
TF32's 10-bit mantissa; ``float8`` scales each operand to its amax and
rounds it to e4m3 (gradients to e5m2), as an fp8 GEMM takes them. Both
accumulate in float32, as the tensor cores do.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

Tensor = torch.Tensor


@contextlib.contextmanager
def exact_float32():
    """float32 products without TF32, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_tf32(x: Tensor) -> Tensor:
    """``x`` rounded to nearest (ties to even) on TF32's 10 mantissa
    bits, in float32."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def round_fp8(x: Tensor, dtype: torch.dtype) -> Tensor:
    """``x`` scaled to ``dtype``'s range by its amax, rounded, scaled
    back, in float32."""
    fmax = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / fmax, torch.ones_like(amax))
    return (x.float() / scale).to(dtype).float() * scale


def _grads(qa: Tensor, qb: Tensor, qg: Tensor):
    ga = qg @ qb.transpose(-1, -2)
    if qb.dim() == 2 and qa.dim() > 2:
        gb = qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
    else:
        gb = qa.transpose(-1, -2) @ qg
    return ga, gb


class _Tf32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        return _grads(qa, qb, round_tf32(g))


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa = round_fp8(a, torch.float8_e4m3fn)
        qb = round_fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        return _grads(qa, qb, round_fp8(g, torch.float8_e5m2))


def matmul_for(precision: str) -> Callable[[Tensor, Tensor], Tensor]:
    if precision == "float32":
        return torch.matmul
    if precision == "tf32":
        return _Tf32.apply
    if precision == "float8":
        return _Fp8.apply
    raise ValueError(f"no reference precision {precision!r}")
