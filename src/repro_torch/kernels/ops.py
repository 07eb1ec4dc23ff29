"""Public wrappers for the port's kernels.

Each checks its shapes as the JAX package's ``repro/kernels/ops.py``
does, then calls the kernel module, which runs the plain PyTorch
version for CPU tensors and the Hopper kernel for CUDA tensors.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import group_mean as _group_mean


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def group_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked MAR group mean; x [G, M, D], mask [G, M]."""
    _check(x.dim() == 3 and tuple(mask.shape) == tuple(x.shape[:2]),
           "bad shapes")
    return _group_mean.group_mean_fwd(x, mask.to(torch.float32))


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since :func:`reset_launch_counts`."""
    return {"group_mean": _group_mean.launches}


def reset_launch_counts() -> None:
    _group_mean.launches = 0
