"""On the CPU at a small size, the plain reference agrees with the
port's step, each control (the reference one precision below the
configuration's, in the port's place) fails the cell's comparison, and
the reference's frozen copies derive what the port derives."""
import time

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.reference import data, mar
from portbench.tests import tiny

CELLS = ["musicgen-medium.fl_train", "musicgen-medium.fl_train_30s",
         "marfl-text-mlp.fed_n125"]
SEED = 2**31 + 99
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("portbench")))


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(bench, cell):
    out = harness.run(bench, bench.cell(cell), SEED, 0.2, False, CPU,
                      time.perf_counter())
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    # both sides float32 on one CPU: agreement to rounding, far inside
    # the limits set on the chip for the cell's precision
    for name, c in out["checks"].items():
        assert c["value"] <= (0 if name in ("bytes", "rows") else 1e-5), \
            (name, c)
    e2e = {m["name"] for m in bench.end_to_end(cell)}
    assert set(out["metrics"]) == e2e
    # times are positive; the CPU has no device memory to read
    assert all(m["value"] > 0 for k, m in out["metrics"].items()
               if m["unit"] in ("s", "ms"))


@pytest.mark.parametrize("cell,precision", [
    ("musicgen-medium.fl_train", "float8"),
    ("musicgen-medium.fl_train_30s", "float8"),
    ("marfl-text-mlp.fed_n125", "tf32")])
def test_control_fails_the_comparison(bench, cell, precision):
    """The control must come out as not correct under the cell's limits
    (on the chip at the cell's size: ``calibrate.py``)."""
    c = bench.cell(cell)
    prog = bench.entry(c["entry"]).Program(bench, c, SEED, CPU)
    ref = prog.reference()
    low = prog.reference(precision)
    checks = check.judge(check.compare(low, ref), c["limits"])
    assert not check.passed(checks), checks


def test_reference_data_is_the_ports():
    from repro_torch.core.federation import Federation, FederationConfig

    cfg = {"num_classes": 20, "feature_dim": 768, "num_train": 4096,
           "margin": 5.0, "alpha": 1.0}
    fed = Federation(FederationConfig(n_peers=8, seed=SEED), device=CPU)
    x, y = data.peer_rows(cfg, 8, 16, SEED)
    assert np.array_equal(fed.data_x.numpy(), x)
    assert np.array_equal(fed.data_y.numpy(), y)


def test_mar_is_the_global_mean_on_a_full_grid():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 3, 5, generator=g)
    want = x.mean(0, keepdim=True).expand_as(x)
    state = {"x": x.clone()}
    mar.aggregate_(state, [2, 2, 2])
    assert torch.allclose(state["x"], want, atol=1e-6)
