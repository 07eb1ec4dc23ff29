"""Small peer models for the paper-scale FL experiments.

* ``cnn``  — two-block conv net + MLP head (MNIST-analogue, paper §3.1
  "CNN-based architecture").
* ``mlp``  — classification head on frozen features (20NG-on-DistilBERT
  analogue: the trainable part of the paper's text model is exactly a
  head over frozen CLS features).

Port of the JAX package's ``repro/models/small.py``. The reference
vmaps its apply functions over a leading peer axis; here the peer axis
is written out: every parameter leaf is ``[N, ...]`` and the input is
``[N, B, F]``, so one call runs all N peers (batched ``matmul`` for the
dense layers, a grouped convolution with ``groups=N`` for the convs).

The parameter layout is the reference's at these public functions —
dense ``w`` is ``[n_in, n_out]`` and conv kernels are HWIO
``[3, 3, cin, cout]`` over NHWC images with ``SAME`` padding — so
weights carry over between the packages as the identity on arrays.
The initial draw uses a ``torch.Generator``: the values differ from
``jax.random``'s, the distributions do not.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from repro_torch.tree import Tree


def _dense(gen: torch.Generator, n_in: int, n_out: int) -> Tree:
    w = torch.randn((n_in, n_out), generator=gen) / math.sqrt(n_in)
    return {"w": w, "b": torch.zeros(n_out)}


def _dense_apply(p: Tree, x: torch.Tensor) -> torch.Tensor:
    """x [N, B, n_in] @ w [N, n_in, n_out] + b [N, n_out]."""
    return torch.matmul(x, p["w"]) + p["b"].unsqueeze(-2)


# ---------------------------------------------------------------------------
# MLP head (text task)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, feature_dim: int, num_classes: int,
             hidden: int = 128) -> Tree:
    return {"fc1": _dense(gen, feature_dim, hidden),
            "fc2": _dense(gen, hidden, num_classes)}


def mlp_apply(params: Tree, x: torch.Tensor) -> torch.Tensor:
    """params leaves [N, ...]; x [N, B, F] -> logits [N, B, C]."""
    h = torch.relu(_dense_apply(params["fc1"], x))
    return _dense_apply(params["fc2"], h)


# ---------------------------------------------------------------------------
# Small CNN (vision task); input x: [N, B, 784] reshaped to 28x28x1
# ---------------------------------------------------------------------------

def cnn_init(gen: torch.Generator, feature_dim: int = 784,
             num_classes: int = 10) -> Tree:
    side = int(math.isqrt(feature_dim))
    if side * side != feature_dim:
        raise ValueError("vision features must be square")
    c1, c2 = 8, 16
    flat = (side // 4) * (side // 4) * c2
    return {
        "conv1": torch.randn((3, 3, 1, c1), generator=gen) * 0.1,
        "conv2": torch.randn((3, 3, c1, c2), generator=gen) * 0.1,
        "fc1": _dense(gen, flat, 64),
        "fc2": _dense(gen, 64, num_classes),
    }


def _peer_conv(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 ``SAME`` conv, one kernel per peer, as one grouped conv.

    h [B, N*cin, H, W] (peer-major channels); w [N, 3, 3, cin, cout]
    (HWIO per peer) -> [B, N*cout, H, W].
    """
    n, kh, kw, cin, cout = w.shape
    wk = w.permute(0, 4, 3, 1, 2).reshape(n * cout, cin, kh, kw)
    return F.conv2d(h, wk, padding=kh // 2, groups=n)


def cnn_apply(params: Tree, x: torch.Tensor) -> torch.Tensor:
    """params leaves [N, ...]; x [N, B, 784] -> logits [N, B, C]."""
    n, b, feat = x.shape
    side = int(math.isqrt(feat))
    # peers become channel groups: [B, N*1, side, side]
    h = x.reshape(n, b, side, side).transpose(0, 1)
    h = F.max_pool2d(torch.relu(_peer_conv(h, params["conv1"])), 2)
    h = F.max_pool2d(torch.relu(_peer_conv(h, params["conv2"])), 2)
    c2 = params["conv2"].shape[-1]
    # back to per-peer NHWC flattening, the reference's feature order
    h = h.reshape(b, n, c2, h.shape[-2], h.shape[-1]).permute(1, 0, 3, 4, 2)
    h = torch.relu(_dense_apply(params["fc1"], h.reshape(n, b, -1)))
    return _dense_apply(params["fc2"], h)


def build_peer_model(task: str, feature_dim: int, num_classes: int
                     ) -> Tuple[Callable[[torch.Generator], Tree],
                                Callable[[Tree, torch.Tensor],
                                         torch.Tensor]]:
    """Returns (init_fn(gen) -> one peer's params, apply_fn(stacked
    params, x [N, B, F]) -> logits [N, B, C])."""
    if task == "vision":
        return (lambda gen: cnn_init(gen, feature_dim, num_classes),
                cnn_apply)
    return (lambda gen: mlp_init(gen, feature_dim, num_classes),
            mlp_apply)
