"""The churn and DP figures (Figs. 3 and 4) on the CPU against the
reference's scripts, through ``test_torch_figures.check_figure`` (rows
key for key, ledger fields equal, accuracy in its band)."""
import pytest

from test_torch_figures import check_figure
from test_torch_federation import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("fig", ["3", "4"])
def test_extension_figure_rows_match_reference(fig, monkeypatch, capsys):
    rows = check_figure(fig, monkeypatch, capsys)
    if fig == "3":
        elastic = [f for _, f in rows if f.get("scenario") == "elastic"]
        assert elastic[0]["peers_end"] == "7"


