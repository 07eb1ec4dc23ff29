"""Synthetic federated classification tasks and LM token batches (numpy).

The paper uses MNIST (vision) and 20 Newsgroups (text, frozen-encoder
features). The repo runs offline, so it generates statistically
analogous synthetic tasks:

* ``classification_task("vision")`` — 10-class Gaussian-mixture images
  (flattened 28x28-like), stand-in for MNIST's CNN task.
* ``classification_task("text")``  — 20-class anisotropic Gaussian
  feature clusters in d=768 (stand-in for frozen-DistilBERT CLS
  features on 20NG — the paper's model IS a linear/MLP head on frozen
  features, so a feature-space task is the faithful analogue).
* ``lm_token_stream`` — Zipfian LM token batches with a short-range
  bigram chain, the LM trainer's data (``launch/train.py``).

Copies of ``classification_task`` and ``lm_token_stream`` from the JAX
package's ``repro/data/synthetic.py``: numpy ``default_rng`` throughout,
so the arrays are bit-identical to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np
import torch


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


def lm_token_stream(vocab_size: int, batch: int, seq_len: int,
                    seed: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite synthetic LM batches with Zipfian unigram statistics and a
    short-range bigram structure (so loss decreases measurably): int32
    ``tokens`` and ``labels`` [batch, seq_len] on the CPU, the caller
    moves them to its device."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
    shift = rng.integers(1, vocab_size)
    while True:
        base = rng.choice(vocab_size, size=(batch, seq_len + 1), p=unigram)
        # 50% of positions continue a deterministic bigram chain
        cont = rng.random((batch, seq_len)) < 0.5
        for t in range(1, seq_len + 1):
            nxt = (base[:, t - 1] + shift) % vocab_size
            base[:, t] = np.where(cont[:, t - 1], nxt, base[:, t])
        yield {
            "tokens": torch.from_numpy(base[:, :-1].astype(np.int32)),
            "labels": torch.from_numpy(base[:, 1:].astype(np.int32)),
        }


def lm_batch(vocab_size: int, batch: int, seq_len: int, seed: int = 0
             ) -> Dict[str, torch.Tensor]:
    return next(lm_token_stream(vocab_size, batch, seq_len, seed))
