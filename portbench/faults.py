"""Faults planted in the port underneath a run, to show that the
comparison catches them (``tests/test_portbench_faults.py`` on the CPU,
``calibrate.py`` on the chip at the cells' sizes):

* ``frozen``       the local update returns its state unchanged;
* ``half_batch``   half of each batch is left out, the mean taken over
  the rest;
* ``no_exchange``  the MAR aggregation between peers is left out;
* ``alter``        an answer is altered where it is produced: the LM's
  loss (and so its gradient) scaled by 1.01; the federation's ledger one
  byte over on every record.
"""
from __future__ import annotations

import contextlib
from typing import Iterable, Iterator

FAULTS = ("frozen", "half_batch", "no_exchange", "alter")


def _unchanged(params, momentum, grads, lr, mu=0.9):
    return params, momentum


@contextlib.contextmanager
def planted(entry: str, names: Iterable[str]) -> Iterator[None]:
    """The port with ``names`` planted, restored on exit."""
    from unittest import mock

    names = list(names)
    unknown = set(names) - set(FAULTS)
    if unknown:
        raise ValueError(f"unknown faults {sorted(unknown)}")
    with contextlib.ExitStack() as stack:
        for name in names:
            stack.enter_context(_PATCHES[entry][name](mock))
        yield


def _lm_loss_wrapper(mock, fn):
    from repro_torch.models.model import Model
    original = Model.loss

    def loss(self, params, batch):
        return fn(original, self, params, batch)
    return mock.patch.object(Model, "loss", loss)


def _half(original, self, params, batch):
    import torch
    tokens = batch["tokens"]
    mask = torch.ones(tokens.shape, dtype=torch.float32,
                      device=tokens.device)
    if tokens.shape[0] > 1:
        mask[tokens.shape[0] // 2:] = 0.0
    else:
        mask[:, tokens.shape[1] // 2:] = 0.0
    return original(self, params, {**batch, "loss_mask": mask})


def _scaled(original, self, params, batch):
    return original(self, params, batch) * 1.01


def _fed_half(mock):
    from repro_torch.core.federation import Federation
    original = Federation._local_update

    def local_update(self, params, momentum, batch_indices):
        half = batch_indices.shape[-1] // 2
        return original(self, params, momentum, batch_indices[..., :half])
    return mock.patch.object(Federation, "_local_update", local_update)


def _fed_alter(mock):
    from repro_torch.core.aggregation import CommLedger
    original = CommLedger.record

    def record(self, source, nbytes):
        return original(self, source, nbytes + 1)
    return mock.patch.object(CommLedger, "record", record)


_PATCHES = {
    "fl_train": {
        "frozen": lambda mock: mock.patch(
            "repro_torch.core.fl_device.momentum_sgd_step", _unchanged),
        "half_batch": lambda mock: _lm_loss_wrapper(mock, _half),
        "no_exchange": lambda mock: mock.patch(
            "repro_torch.core.mar_allreduce.mar_aggregate_device",
            lambda state, *a, **k: state),
        "alter": lambda mock: _lm_loss_wrapper(mock, _scaled),
    },
    "federation": {
        "frozen": lambda mock: mock.patch(
            "repro_torch.core.federation.momentum_sgd_step", _unchanged),
        "half_batch": _fed_half,
        "no_exchange": lambda mock: mock.patch(
            "repro_torch.core.mar_allreduce.mar_aggregate_sim",
            lambda state, *a, **k: state),
        "alter": _fed_alter,
    },
}
