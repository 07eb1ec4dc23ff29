"""Plain PyTorch versions of the port's kernels.

Each function is the semantic ground truth at f32 precision with no
blocking. The kernel wrappers call these for tensors on the CPU, and
``chip_smoke.py`` holds each kernel against them on the card. Port of
the matching functions in the JAX package's ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import torch


def group_mean_ref(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked group mean (MAR aggregation hot spot).

    x [G, M, D]; mask [G, M] -> [G, M, D]: every slot receives its
    group's masked mean; empty groups keep their own values.
    """
    m = mask.unsqueeze(-1).float()
    num = (x.float() * m).sum(dim=1, keepdim=True)
    den = m.sum(dim=1, keepdim=True)
    mean = num / den.clamp(min=1.0)
    out = torch.where(den > 0, mean, x.float())
    return out.expand(x.shape).to(x.dtype)
