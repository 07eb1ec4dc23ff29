"""The port's MetricsLogger and read_metrics against the JAX package's.

The same ``log`` calls must give the same records, leaving out what the
wall clock sets (``run_id``, ``wall_s``, ``step_ms``, ``tokens_per_s``);
``read_metrics`` must reconcile a file both packages appended to (a
restart under the other package) the same way.
"""
import json

import jax.numpy as jnp
import numpy as np
import torch

from repro.runtime.metrics import MetricsLogger as RefLogger
from repro.runtime.metrics import read_metrics as ref_read_metrics

from repro_torch.runtime.metrics import MetricsLogger, read_metrics

CLOCK = ("run_id", "wall_s", "step_ms", "tokens_per_s")


def _calls(tensor):
    """(step, kwargs) of a run: tensor values, plain numbers, strings,
    simulated seconds and token counts."""
    return [(0, dict(loss=tensor(2.5), acc=0.25, sim_s=0.125, tokens=64)),
            (1, dict(loss=tensor(1.75), note="warm", sim_s=0.0625,
                     tokens=64)),
            (2, dict(loss=tensor(1.5), grad_norm=3, sim_s=1 / 3)),
            (3, dict(flag=True))]


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in CLOCK}


def test_records_are_the_references(tmp_path):
    port, ref = MetricsLogger(str(tmp_path / "p.jsonl")), \
        RefLogger(str(tmp_path / "r.jsonl"))
    got = [port.log(s, **kw) for s, kw in _calls(torch.tensor)]
    want = [ref.log(s, **kw) for s, kw in _calls(jnp.asarray)]
    assert [_strip(r) for r in got] == [_strip(r) for r in want]
    assert port.sim_total_s == ref.sim_total_s
    assert got[2]["sim_total_s"] == want[2]["sim_total_s"] == \
        round(0.125 + 0.0625 + 1 / 3, 6)
    assert all(isinstance(r["loss"], float) for r in got[:3])
    assert "step_ms" not in got[0] and "step_ms" in got[1]
    assert "tokens_per_s" in got[1] and "tokens_per_s" not in got[2]
    lines = [json.loads(ln) for ln in open(tmp_path / "p.jsonl")]
    assert lines == got


def test_read_metrics_reconciles_both_packages_appends(tmp_path):
    path = str(tmp_path / "m.jsonl")
    first = RefLogger(path)
    for s in range(4):
        first.log(s, loss=jnp.asarray(float(10 - s)))
    # a restart from step 2 under the port appends with a new run_id
    second = MetricsLogger(path)
    for s in range(2, 6):
        second.log(s, loss=torch.tensor(float(-s)))
    got, want = read_metrics(path), ref_read_metrics(path)
    assert got == want
    assert [r["step"] for r in got] == list(range(6))
    assert [r["loss"] for r in got] == [10.0, 9.0, -2.0, -3.0, -4.0, -5.0]
    assert got[1]["run_id"] == first.run_id
    assert got[2]["run_id"] == second.run_id != first.run_id


def test_logger_without_a_path_keeps_no_file(tmp_path):
    log = MetricsLogger()
    rec = log.log(0, loss=np.float32(0.5), sim_s=0.5)
    assert rec["loss"] == 0.5 and rec["sim_total_s"] == 0.5
    assert not list(tmp_path.iterdir())
