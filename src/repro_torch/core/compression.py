"""Delta compression for MAR exchanges: int8 with error feedback.

Peers exchange model state every iteration; quantizing the *delta since
the last aggregated state* to int8 cuts MAR wire bytes 4x (vs f32) at
<1% relative error, and **error feedback** (Seide et al. / EF-SGD)
carries each peer's quantization residual into its next delta, so the
bias cancels over iterations instead of accumulating.

Protocol (per FL iteration, sim backend):
    delta_i   = theta_i - ref_i + e_i          # e_i = residual carry
    q_i       = Q(delta_i)                     # int8 absmax per tensor
    e_i'      = delta_i - deQ(q_i)             # new residual
    exchange  = MAR group means over deQ(q_i)  # wire format: int8+scale
    theta_i'  = ref' = ref_i + mean(deQ(q))    # all peers re-anchor

Port of the JAX package's ``repro/core/compression.py``.
``FederationConfig(compress="int8_ef")`` activates it through
:class:`~repro_torch.core.aggregation.Int8EFStage`. ``torch.round``
rounds half to even as ``jnp.round`` does, so f32 results are the
reference's bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.tree import Tree, tree_leaves, tree_map

INT8_RATIO = 4.0   # vs f32 wire format (scales are negligible)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax int8 quantization (leading peer axis kept)."""
    xf = x.float()
    dims = tuple(range(1, x.dim()))
    absmax = xf.abs().amax(dim=dims, keepdim=True) if dims else xf.abs()
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(tree: Tree, error: Optional[Tree]) -> Tuple[Tree, Tree]:
    """Quantize every leaf (plus carried error); returns (dequantized
    values as seen on the wire, new error carry)."""
    def leaf(x, e):
        xe = x.float() if e is None else x.float() + e
        q, s = quantize_int8(xe)
        deq = dequantize_int8(q, s)
        return deq, xe - deq

    errs = None if error is None else iter(tree_leaves(error))
    pairs = [leaf(x, None if errs is None else next(errs))
             for x in tree_leaves(tree)]
    it_d = iter(p[0] for p in pairs)
    it_e = iter(p[1] for p in pairs)
    return (tree_map(lambda _: next(it_d), tree),
            tree_map(lambda _: next(it_e), tree))
