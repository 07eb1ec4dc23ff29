"""Masked MAR group mean — the MAR aggregation hot spot, as a CUDA kernel.

MAR round g averages each group of M peer states (paper Alg. 1 line 10);
on a device that owns several peer replicas this is a masked mean over
the group axis, memory-bound over the full model state. The kernel
(``csrc/group_mean.cu``) fuses mask multiply, group sum, count, divide
and the empty-group fallback into one pass: one read of x, one write of
y. It replaces the Pallas TPU kernel ``group_mean_fwd`` of the JAX
package's ``repro/kernels/group_mean.py``; the source's header gives its
bound and design.

:func:`group_mean_fwd` dispatches on where the tensor lies: a CPU tensor
goes to the plain :func:`~repro_torch.kernels.ref.group_mean_ref`; a
CUDA tensor launches the kernel or raises — there is no fallback.
``launches`` counts the kernel launches, so a run can show that its
main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import group_mean_ref

#: kernel launches since the count was last set to 0
launches = 0

_ENTRY = {torch.float32: "group_mean_f32", torch.bfloat16: "group_mean_bf16"}
_MAX_M = 12288      # the mask row lives in 48 KB of dynamic shared memory


def _fn(dtype: torch.dtype):
    fn = getattr(_build.load("group_mean"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def validate(x: torch.Tensor, mask: torch.Tensor) -> None:
    """Raise unless the CUDA kernel takes (x, mask) as they are."""
    if x.device.type != "cuda" or mask.device != x.device:
        raise ValueError(f"group_mean kernel needs x and mask on one CUDA "
                         f"device; got {x.device} and {mask.device}")
    check_layout(x, mask)


def check_layout(x: torch.Tensor, mask: torch.Tensor) -> None:
    """The device-independent half of :func:`validate`: dtypes, ranks,
    shapes and contiguity."""
    if x.dtype not in _ENTRY:
        raise TypeError(f"group_mean kernel takes float32 or bfloat16 x; "
                        f"got {x.dtype}")
    if mask.dtype != torch.float32:
        raise TypeError(f"group_mean kernel takes a float32 mask; got "
                        f"{mask.dtype}")
    if x.dim() != 3 or tuple(mask.shape) != tuple(x.shape[:2]):
        raise ValueError(f"group_mean kernel needs x [G, M, D] and mask "
                         f"[G, M]; got {tuple(x.shape)} and "
                         f"{tuple(mask.shape)}")
    if x.shape[1] > _MAX_M:
        raise ValueError(f"group size {x.shape[1]} exceeds the kernel's "
                         f"{_MAX_M}")
    if not (x.is_contiguous() and mask.is_contiguous()):
        raise ValueError("group_mean kernel needs contiguous x and mask")


def group_mean_fwd(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x [G, M, D]; mask [G, M] -> [G, M, D] (each slot gets its group's
    masked mean; fully-dropped groups keep their own values)."""
    global launches
    if x.device.type == "cpu":
        return group_mean_ref(x, mask)
    validate(x, mask)
    g, m, d = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    fn = _fn(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), mask.data_ptr(), y.data_ptr(), g, m, d,
                 stream)
    if err != 0:
        raise RuntimeError(f"group_mean kernel launch failed: CUDA error "
                           f"{err} at x {tuple(x.shape)} {x.dtype}")
    launches += 1
    return y
