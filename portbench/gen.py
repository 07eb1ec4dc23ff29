"""The general traffic generator: every input a run feeds the port,
drawn from ``--seed`` and the traffic mix's parameters on the device.

One step's draws come from a generator seeded by (seed, stream, step),
so the same seed gives the same inputs, the set-up's check steps and the
window's steps never share rows, and the reference can draw any step's
inputs again.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

_MASK = (1 << 63) - 1
#: streams of draws: the check steps of set-up, the measured window
CHECK, WINDOW = 1, 2


def stream_seed(seed: int, stream: int, step: int) -> int:
    """A 63-bit seed for one step of one stream; ``seed`` may be any
    whole number."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9
         + (step + 1) * 0x94D049BB133111EB) & _MASK
    x ^= x >> 31
    return (x * 0xD6E8FEB86659FD93) & _MASK


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def lm_batch(mix: Dict[str, Any], vocab: int, seed: int, stream: int,
             step: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """One step's token batch for ``fl_train_step``: ``tokens`` and
    ``labels`` int32 ``[peers, local_steps, micro_batches, batch, seq]``,
    ids uniform over the vocabulary, labels the next ids of each row."""
    lead = (mix["peers"], mix["local_steps"], mix["micro_batches"],
            mix["batch"])
    ids = torch.randint(0, vocab, lead + (mix["seq"] + 1,),
                        generator=_generator(device, stream_seed(
                            seed, stream, step)),
                        device=device, dtype=torch.int64)
    return {"tokens": ids[..., :-1].to(torch.int32).contiguous(),
            "labels": ids[..., 1:].to(torch.int32).contiguous()}


def batch_indices(mix: Dict[str, Any], n_rows: int, seed: int, stream: int,
                  step: int, device: torch.device) -> torch.Tensor:
    """One federation step's rows: int64 ``[peers, local_batches,
    batch_size]``, each uniform over the ``n_rows`` rows of a peer's
    shard."""
    shape = (mix["peers"], mix["local_batches"], mix["batch_size"])
    return torch.randint(0, n_rows, shape,
                         generator=_generator(device, stream_seed(
                             seed, stream, step)),
                         device=device, dtype=torch.int64)
