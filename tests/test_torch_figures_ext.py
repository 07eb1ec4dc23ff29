"""The churn and DP figures (Figs. 3 and 4) on the CPU against the
reference's scripts, through ``test_torch_figures.check_figure`` (rows
key for key, ledger fields equal, accuracy in its band); and Figs. 8
and 11 against the constants ``chip_smoke.py`` holds
(``FIGURE_EXT_ROWS``, from ``tools/reference_constants.py``), with the
partition statistics recomputed live by the reference's
``repro.data.partition``."""
import pytest

from repro_torch import figures
from test_torch_figures import ROOT, SMOKE, check_figure
from test_torch_federation import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("fig", ["3", "4"])
def test_extension_figure_rows_match_reference(fig, monkeypatch, capsys):
    rows = check_figure(fig, monkeypatch, capsys)
    if fig == "3":
        elastic = [f for _, f in rows if f.get("scenario") == "elastic"]
        assert elastic[0]["peers_end"] == "7"


def test_noniid_and_approximate_figure_rows_match_reference(monkeypatch):
    from repro.data.partition import dirichlet_partition, partition_stats
    from repro.data.synthetic import classification_task

    monkeypatch.syspath_prepend(str(ROOT))
    from chipsmoke.refs import figure_ext_mismatches

    rows = figures.run_figures(["8", "11"], SMOKE, 0, "cpu")
    assert figure_ext_mismatches(rows) == []
    _, train, _ = classification_task("text", seed=0)
    parts = [r for r in rows if r["row"] == "fig8_partition"]
    for r, alpha in zip(parts, (0.1, 1.0, 100.0)):
        want = partition_stats(dirichlet_partition(
            train["y"], SMOKE["peers"], alpha, seed=0), train["y"])
        assert {k: r[k] for k in want} == want
    timing = [r for r in rows if r["row"] == "fig_timing"]
    assert [t["fig"] for t in timing] == ["8"] * 6 + ["11"] * 3
    assert all(t["device"] == "cpu" for t in timing)
    comm = [float(r["comm_mb"]) for r in rows if r["row"] == "fig11_approx"]
    assert comm[0] == comm[1] == 2 * comm[2]     # one round of two
