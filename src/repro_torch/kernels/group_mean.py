"""Masked MAR group mean — the MAR aggregation hot spot, as a CUDA kernel.

MAR round g averages each group of M peer states (paper Alg. 1 line 10);
on a device that owns several peer replicas this is a masked mean over
the group axis, memory-bound over the full model state. The kernel
(``csrc/group_mean.cu``) replaces the Pallas TPU kernel
``group_mean_fwd`` of the JAX package's ``repro/kernels/group_mean.py``
together with the gather and scatter its caller wrapped around it: one
launch per MAR round takes every leaf of one dtype, reads each peer's
row through the round's slot order and writes each peer's row in place,
so each leaf is read once and written once. The source's header gives
its bound and design.

Two entries, one kernel:

- :func:`group_mean_round` — one round over up to :data:`MAX_LEAVES`
  leaves ``[n, d]`` of one dtype, the round's ``order`` (slots by group,
  int64, length ``cap``) and the peer mask ``[n]``. :func:`batches`
  splits a tree's leaves into such launches.
- :func:`group_mean_fwd` — the reference's ``[G, M, D]`` entry: one
  leaf, identity order.

Each dispatches on where the tensors lie: CPU tensors go to the plain
version in :mod:`~repro_torch.kernels.ref`; CUDA tensors launch the
kernel or raise — there is no fallback. ``launches`` counts the kernel
launches of both entries, so a run can show that its main path went
through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import group_mean_ref, group_mean_round_ref

#: kernel launches since the count was last set to 0
launches = 0

_ENTRY = {torch.float32: "group_mean_f32", torch.bfloat16: "group_mean_bf16"}
_ROUND_ENTRY = {torch.float32: "group_mean_round_f32",
                torch.bfloat16: "group_mean_round_bf16"}
_MAX_M = 12288      # m slots of 8 bytes in 96 KB of dynamic shared memory
#: leaves one round launch takes (the kernel's parameter table)
MAX_LEAVES = 32


class _Leaf(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("y", ctypes.c_void_p),
                ("d", ctypes.c_longlong), ("first_block", ctypes.c_longlong)]


class _Round(ctypes.Structure):
    """ctypes mirror of ``Round`` in ``csrc/group_mean.cu``."""
    _fields_ = [("leaf", _Leaf * MAX_LEAVES), ("order", ctypes.c_void_p),
                ("mask", ctypes.c_void_p), ("n", ctypes.c_int),
                ("m", ctypes.c_int), ("groups", ctypes.c_int),
                ("n_leaves", ctypes.c_int)]


def struct_layout() -> List[int]:
    """The table's layout as ctypes lays it out, in the order
    ``group_mean_round_layout`` reports the C compiler's."""
    return [MAX_LEAVES, _MAX_M, ctypes.sizeof(_Leaf),
            *(getattr(_Leaf, f).offset for f, _ in _Leaf._fields_),
            ctypes.sizeof(_Round),
            *(getattr(_Round, f).offset for f, _ in _Round._fields_)]


def check_struct_layout(c_layout: Sequence[int]) -> None:
    """Raise unless the C side's table layout is the ctypes mirror's: a
    mismatch would pass garbage to the kernel without an error."""
    if list(c_layout) != struct_layout():
        raise RuntimeError(f"group_mean.cu's Round layout {list(c_layout)} "
                           f"differs from the ctypes mirror's "
                           f"{struct_layout()}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("group_mean")
    lib.group_mean_round_layout.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.group_mean_round_layout.restype = ctypes.c_int
    out = (ctypes.c_longlong * 32)()
    count = lib.group_mean_round_layout(ctypes.addressof(out), len(out))
    check_struct_layout(out[:count])
    for name in _ENTRY.values():
        getattr(lib, name).argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    for name in _ROUND_ENTRY.values():
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def batches(leaves: Sequence[torch.Tensor]) -> List[List[int]]:
    """Indices of ``leaves`` by launch: grouped by dtype (in the order
    each dtype first appears), each group cut into runs of at most
    :data:`MAX_LEAVES`, leaves in their own order within a launch."""
    by_dtype: dict = {}
    for i, x in enumerate(leaves):
        by_dtype.setdefault(x.dtype, []).append(i)
    return [idx[k:k + MAX_LEAVES] for idx in by_dtype.values()
            for k in range(0, len(idx), MAX_LEAVES)]


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


def validate_round(xs: Sequence[torch.Tensor], order: torch.Tensor,
                   mask: torch.Tensor, m: int) -> None:
    """Raise unless the CUDA round kernel takes (xs, order, mask, m)."""
    dev = mask.device
    if dev.type != "cuda" or any(t.device != dev for t in (*xs, order)):
        raise ValueError(f"group_mean round kernel needs every leaf, order "
                         f"and mask on one CUDA device; got mask on {dev}")
    check_round_layout(xs, order, mask, m)


def check_round_layout(xs: Sequence[torch.Tensor], order: torch.Tensor,
                       mask: torch.Tensor, m: int) -> None:
    """The device-independent half of :func:`validate_round`: one dtype
    the kernel has, at most :data:`MAX_LEAVES` contiguous ``[n, d]``
    leaves, an int64 ``order`` of length ``cap >= n`` that ``m``
    divides, and a contiguous f32 mask ``[n]``."""
    if not 1 <= len(xs) <= MAX_LEAVES:
        raise ValueError(f"group_mean round kernel takes 1 to {MAX_LEAVES} "
                         f"leaves; got {len(xs)}")
    if mask.dtype != torch.float32 or mask.dim() != 1 or \
            not mask.is_contiguous():
        raise TypeError(f"group_mean round kernel takes a contiguous f32 "
                        f"mask [n]; got {mask.dtype} {tuple(mask.shape)}")
    n = mask.shape[0]
    dtype = xs[0].dtype
    if dtype not in _ROUND_ENTRY or any(x.dtype != dtype for x in xs):
        raise TypeError(f"group_mean round kernel takes leaves of one "
                        f"dtype, float32 or bfloat16; got "
                        f"{sorted({str(x.dtype) for x in xs})}")
    for x in xs:
        if x.dim() != 2 or x.shape[0] != n or not x.is_contiguous():
            raise ValueError(f"group_mean round kernel needs contiguous "
                             f"[n={n}, d] leaves; got {tuple(x.shape)} "
                             f"(contiguous: {x.is_contiguous()})")
    if order.dtype != torch.int64 or order.dim() != 1 or \
            not order.is_contiguous():
        raise TypeError(f"group_mean round kernel takes a contiguous int64 "
                        f"order [cap]; got {order.dtype} "
                        f"{tuple(order.shape)}")
    cap = order.shape[0]
    if not 1 <= m <= _MAX_M:
        raise ValueError(f"group size {m} is outside the kernel's 1 to "
                         f"{_MAX_M}")
    if cap < n or cap % m:
        raise ValueError(f"order of length {cap} must cover n={n} peers in "
                         f"whole groups of {m}")


def group_mean_round(xs: Sequence[torch.Tensor], order: torch.Tensor,
                     mask: torch.Tensor, m: int) -> List[torch.Tensor]:
    """One MAR round over leaves ``xs`` (each ``[n, d]``, one dtype):
    slot j of group g holds peer ``order[g*m + j]`` (``>= n``: a virtual
    slot), every real peer receives its group's masked mean, a group
    whose mask sums to 0 keeps its own rows. Returns fresh ``[n, d]``
    tensors; the inputs are not written."""
    global launches
    if all(t.device.type == "cpu" for t in (mask, order, *xs)):
        return group_mean_round_ref(xs, order, mask, m)
    _build.refuse_autograd("group_mean", (mask, *xs))
    validate_round(xs, order, mask, m)
    ys = [torch.empty_like(x) for x in xs]
    if all(x.numel() == 0 for x in xs):
        return ys
    args = _Round(order=order.data_ptr(), mask=mask.data_ptr(),
                  n=mask.shape[0], m=m, groups=order.shape[0] // m,
                  n_leaves=len(xs))
    for entry, x, y in zip(args.leaf, xs, ys):
        entry.x, entry.y, entry.d = x.data_ptr(), y.data_ptr(), x.shape[1]
    fn = getattr(_lib(), _ROUND_ENTRY[xs[0].dtype])
    with torch.cuda.device(mask.device):
        err = fn(ctypes.addressof(args),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"group_mean round kernel launch failed: CUDA "
                           f"error {err} at {len(xs)} {xs[0].dtype} leaves, "
                           f"n={mask.shape[0]}, m={m}")
    launches += 1
    return ys


def group_mean_fwd(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x [G, M, D]; mask [G, M] -> [G, M, D] (each slot gets its group's
    masked mean; fully-dropped groups keep their own values)."""
    global launches
    if x.device.type == "cpu":
        return group_mean_ref(x, mask)
    _build.refuse_autograd("group_mean", (x, mask))
    validate(x, mask)
    g, m, d = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    fn = getattr(_lib(), _ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), mask.data_ptr(), y.data_ptr(), g, m, d,
                 stream)
    if err != 0:
        raise RuntimeError(f"group_mean kernel launch failed: CUDA error "
                           f"{err} at x {tuple(x.shape)} {x.dtype}")
    launches += 1
    return y
