"""Every MAR round of the device backend over one leaf, in one in-place
CUDA pass (``csrc/mar_rounds.cu``).

The device backend (``core/mar_allreduce.mar_aggregate_device``) keeps
every peer's state on one card as leaves ``[P, ...]`` and runs MAR round
r as a masked mean over axis r of the grid reshape ``[P] -> [*dims]``.
The plain route takes each round over column blocks of the leaf, about
ten kernels a block; the kernel reads each column of every peer once,
runs all the requested rounds in registers, rounding to the leaf's dtype
between rounds as the plain route does, and writes the column back in
place. It replaces no TPU kernel (the JAX package leaves this mean to
XLA); the source's header gives its bound, its arithmetic and design.

:func:`mar_rounds_` dispatches on where the tensors lie: CPU (and
``meta``) tensors go to the plain version
(:func:`~repro_torch.kernels.ref.mar_rounds_ref`, the rounds of
``_grid_reshape_mean``), written into the leaf; CUDA tensors launch the
kernel or raise, with no fallback. ``launches`` counts the kernel's
launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mar_rounds_ref

#: kernel launches since the count was last set to 0
launches = 0

#: peer counts the kernel is built for: 4 (the (2, 2) and (4,) grids of
#: the training step) and 2 (a rank's own peers on a mesh)
PEERS = (2, 4)
#: rounds one launch takes
MAX_ROUNDS = 8
#: leaf dtypes the kernel has
DTYPES = (torch.float32, torch.bfloat16)
_ENTRY = {torch.float32: "mar_rounds_f32", torch.bfloat16: "mar_rounds_bf16"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mar_rounds")
    for name in _ENTRY.values():
        getattr(lib, name).argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=64)
def groups(dims: Tuple[int, ...], axes: Tuple[int, ...]
           ) -> Tuple[Tuple[int, ...], ...]:
    """For each round of ``axes``, each peer's group as a bit mask of
    peers: the peers (row major over ``dims``) whose grid coordinates
    differ from its own on that axis alone."""
    n = math.prod(dims)
    out = []
    for axis in axes:
        stride, size = math.prod(dims[axis + 1:]), dims[axis]
        row = []
        for p in range(n):
            first = p - (p // stride) % size * stride
            row.append(sum(1 << (first + j * stride) for j in range(size)))
        out.append(tuple(row))
    return tuple(out)


def validate(x: torch.Tensor, dims: Sequence[int], axes: Sequence[int],
             mask: torch.Tensor) -> None:
    """Raise unless the CUDA kernel takes (x, dims, axes, mask): a
    contiguous ``[P, D]`` leaf of a dtype the kernel has, P = prod(dims)
    one of :data:`PEERS`, at most :data:`MAX_ROUNDS` axes of the grid,
    and a contiguous f32 mask ``[P]``, both on one CUDA device."""
    if x.dtype not in DTYPES:
        raise TypeError(f"mar_rounds kernel takes float32 or bfloat16 "
                        f"leaves; got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"mar_rounds kernel needs a contiguous [P, D] "
                         f"leaf; got {tuple(x.shape)} (contiguous: "
                         f"{x.is_contiguous()})")
    if math.prod(dims) != x.shape[0] or x.shape[0] not in PEERS:
        raise ValueError(f"mar_rounds kernel takes {PEERS} peers on the "
                         f"grid; got {x.shape[0]} peers on {tuple(dims)}")
    if len(axes) > MAX_ROUNDS or any(not 0 <= a < len(dims) for a in axes):
        raise ValueError(f"rounds {tuple(axes)} are not at most "
                         f"{MAX_ROUNDS} axes of the grid {tuple(dims)}")
    if mask.dtype != torch.float32 or tuple(mask.shape) != (x.shape[0],) \
            or not mask.is_contiguous():
        raise TypeError(f"mar_rounds kernel takes a contiguous f32 mask "
                        f"[{x.shape[0]}]; got {mask.dtype} "
                        f"{tuple(mask.shape)}")
    if x.device.type != "cuda" or mask.device != x.device:
        raise ValueError(f"mar_rounds kernel needs x and mask on one CUDA "
                         f"device; got {x.device} and {mask.device}")


def mar_rounds_(x: torch.Tensor, dims: Sequence[int], axes: Sequence[int],
                mask: torch.Tensor) -> torch.Tensor:
    """Run the MAR rounds ``axes``, in order, over the grid ``dims`` of
    leaf ``x`` ([P, D], peers row major over ``dims``), in place: in
    each, every peer receives its group's masked mean (a group whose
    mask sums to 0 keeps its own rows), summed in f32 and rounded to x's
    dtype. Returns ``x``."""
    global launches
    dims, axes = tuple(dims), tuple(axes)
    if {x.device.type, mask.device.type} <= set(_build.PLAIN_DEVICES):
        return x.copy_(mar_rounds_ref(x, dims, axes, mask))
    _build.refuse_autograd("mar_rounds", (x, mask))
    validate(x, dims, axes, mask)
    if x.numel() == 0 or not axes:
        return x
    rows = [g for row in groups(dims, axes) for g in row]
    table = (ctypes.c_uint16 * len(rows))(*rows)
    with torch.cuda.device(x.device):
        err = getattr(_lib(), _ENTRY[x.dtype])(
            x.data_ptr(), mask.data_ptr(), x.shape[1], x.shape[0],
            ctypes.addressof(table), len(axes),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mar_rounds kernel launch failed: CUDA error "
                           f"{err} at x {tuple(x.shape)} {x.dtype}, grid "
                           f"{dims}, rounds {axes}")
    launches += 1
    return x
