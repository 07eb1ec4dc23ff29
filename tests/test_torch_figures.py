"""``python -m repro_torch.figures --smoke`` against the reference's
figure scripts (``benchmarks/fig*.py``) at the same scale.

Both sides run at ``scale(False, smoke=True)``: 8 peers, 6 iterations,
one local batch, seed 0 (the reference's scripts are given that scale in
place of their default). Rows must match key for key. Bytes, simulated
seconds, the fleet size and the membership events come from numpy in
both packages and must be equal as printed; so must Fig. 1's analytic
table. Accuracy runs free (torch's initial draw and minibatches are not
jax's), so it is held to a band: within ``ACC_BAND`` of the reference's
seed-0 value. The band is twice the largest spread any row's accuracy
shows across the reference's own seeds 0-2 (0.0224, Fig. 2's K=6 row;
``tools/reference_constants.py`` prints it).
"""
import contextlib
import importlib
import io
from pathlib import Path

import pytest

from repro_torch import figures
from test_torch_federation import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ACC_BAND = 2 * 0.0224
SMOKE = figures.scale(False, smoke=True)
REF_SCRIPTS = {"1": "fig1_perf_gap", "2": "fig2_mkd", "3": "fig3_churn",
               "4": "fig4_dp", "5": "fig5_parity"}
EXACT = ("comm_mb", "sim_s", "peers_end", "events", "peers", "technique",
         "scenario", "task", "use_kd", "kd_iters", "noise_multiplier",
         "epsilon", "mb_to_target", "vs")


def _parse(lines):
    rows = []
    for line in lines:
        if line.startswith("fig") and not line.startswith("fig_timing"):
            name, *kv = line.split(",")
            rows.append((name, dict(x.split("=", 1) for x in kv)))
    return rows


def reference_rows(fig, monkeypatch):
    """The reference script's rows at the smoke scale (``benchmarks``
    is importable from the repository's root)."""
    monkeypatch.syspath_prepend(str(ROOT))
    mod = importlib.import_module("benchmarks." + REF_SCRIPTS[fig])
    monkeypatch.setattr(mod, "scale", lambda full, smoke=False: dict(SMOKE))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(["--seed", "0"] + (["--smoke"] if fig == "3" else []))
    return _parse(buf.getvalue().splitlines())


def port_rows(fig, capsys):
    assert figures.main(["--smoke", "--device", "cpu", "--fig", fig]) == 0
    lines = capsys.readouterr().out.splitlines()
    timing = [line for line in lines if line.startswith("fig_timing")]
    return _parse(lines), timing


def check_figure(fig, monkeypatch, capsys):
    rows, timing = port_rows(fig, capsys)
    ref = reference_rows(fig, monkeypatch)
    assert [name for name, _ in rows] == [name for name, _ in ref]
    for (name, got), (_, want) in zip(rows, ref):
        assert sorted(got) == sorted(want), name
        for key, value in want.items():
            if name == "fig1_scaling" or key in EXACT:
                assert got[key] == value, (name, key)
            elif key in ("final_acc", "acc"):
                assert abs(float(got[key]) - float(value)) <= ACC_BAND, \
                    (name, got, want)
            elif key == "max_param_diff":       # Fig. 5: exact parity
                assert float(got[key]) <= 1e-5, (name, got)
            else:
                assert key == "disagreement", (name, key)
                assert float(got[key]) <= 1e-6, (name, got)
    assert timing and all("device=cpu" in t for t in timing)
    return rows


@pytest.mark.parametrize("fig", ["1", "5"])
def test_figure_rows_match_reference(fig, monkeypatch, capsys):
    rows = check_figure(fig, monkeypatch, capsys)
    if fig == "1":
        assert sum(name == "fig1_train" for name, _ in rows) == 6


def test_scale_matches_reference_common(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    from benchmarks import common
    for full, smoke in ((False, False), (True, False), (False, True)):
        assert figures.scale(full, smoke) == common.scale(full, smoke)
