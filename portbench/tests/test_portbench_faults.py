"""A run with the timed path broken underneath comes out not correct:
each fault a cell lists, planted in the port, drives the rest of a run
(the look for a chip skipped, on the CPU at a small size)."""
import time

import pytest
import torch

from portbench import harness, spec
from portbench.tests import tiny

_BENCH = spec.Bench(spec=tiny.with_staged(spec.Bench().spec))
CASES = [(w["name"], f) for w in _BENCH.spec["workloads"]
         for f in _BENCH.cell(w["name"])["faults"]]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("portbench")))


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(bench, cell, fault):
    out = harness.run(bench, bench.cell(cell), 2**31 + 5, 0.1, False,
                      torch.device("cpu"), time.perf_counter(), (fault,))
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_faults_are_restored(bench):
    from repro_torch.core import fl_device, mar_allreduce
    before = (fl_device.momentum_sgd_step,
              mar_allreduce.mar_aggregate_device)
    cell = "musicgen-medium.fl_train"
    harness.run(bench, bench.cell(cell), 1, 0.1, False, torch.device("cpu"),
                time.perf_counter(), ("frozen", "no_exchange"))
    assert (fl_device.momentum_sgd_step,
            mar_allreduce.mar_aggregate_device) == before
