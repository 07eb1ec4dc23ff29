"""Synthetic federated classification tasks (numpy).

The paper uses MNIST (vision) and 20 Newsgroups (text, frozen-encoder
features). The repo runs offline, so it generates statistically
analogous synthetic tasks:

* ``classification_task("vision")`` — 10-class Gaussian-mixture images
  (flattened 28x28-like), stand-in for MNIST's CNN task.
* ``classification_task("text")``  — 20-class anisotropic Gaussian
  feature clusters in d=768 (stand-in for frozen-DistilBERT CLS
  features on 20NG — the paper's model IS a linear/MLP head on frozen
  features, so a feature-space task is the faithful analogue).

A copy of ``classification_task`` from the JAX package's
``repro/data/synthetic.py``: numpy ``default_rng`` throughout, so the
arrays are bit-identical to the reference's. The LM token stream waits
for the LM slice (ROADMAP.md, Queue 1 item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    name: str
    num_classes: int
    feature_dim: int
    num_train: int
    num_test: int


TASKS = {
    # MNIST analogue: 10 classes, 784 features
    "vision": TaskSpec("vision", 10, 784, 8_192, 2_048),
    # 20NG-on-frozen-DistilBERT analogue: 20 classes, 768-dim features
    "text": TaskSpec("text", 20, 768, 4_096, 1_024),
}


def _smooth_templates(rng, num_classes: int, side: int,
                      coarse: int = 7) -> np.ndarray:
    """Low-frequency class template "images" (bilinear-upsampled coarse
    grids) so conv layers have spatial structure to exploit."""
    grids = rng.normal(size=(num_classes, coarse, coarse))
    xs = np.linspace(0, coarse - 1, side)
    x0 = np.clip(np.floor(xs).astype(int), 0, coarse - 2)
    w = xs - x0                                        # [side]
    # separable bilinear upsample: rows then columns
    up_r = (grids[:, x0, :] * (1 - w)[None, :, None]
            + grids[:, x0 + 1, :] * w[None, :, None])  # [C, side, coarse]
    up = (up_r[:, :, x0] * (1 - w)[None, None, :]
          + up_r[:, :, x0 + 1] * w[None, None, :])     # [C, side, side]
    flat = up.reshape(num_classes, side * side)
    return flat / np.linalg.norm(flat, axis=1, keepdims=True)


def classification_task(name: str, seed: int = 0, margin: float = 5.0
                        ) -> Tuple[TaskSpec, Dict[str, np.ndarray],
                                   Dict[str, np.ndarray]]:
    """Returns (spec, train, test) with numpy arrays x [N, D], y [N]."""
    spec = TASKS[name]
    rng = np.random.default_rng(seed)
    if name == "vision":
        side = int(np.sqrt(spec.feature_dim))
        means = margin * _smooth_templates(rng, spec.num_classes, side)
        scales = np.ones(spec.feature_dim)
    else:
        # class means on a scaled random simplex; anisotropic noise
        means = rng.normal(size=(spec.num_classes, spec.feature_dim))
        means = margin * means / np.linalg.norm(means, axis=1, keepdims=True)
        scales = 0.5 + rng.random(spec.feature_dim)

    def sample(n):
        y = rng.integers(0, spec.num_classes, size=n)
        x = means[y] + rng.normal(size=(n, spec.feature_dim)) * scales
        return {"x": x.astype(np.float32), "y": y.astype(np.int32)}

    return spec, sample(spec.num_train), sample(spec.num_test)
