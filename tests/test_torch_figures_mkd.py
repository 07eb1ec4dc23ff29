"""The MKD figure (Fig. 2: MAR with and without Moshpit-KD) on the CPU
against the reference's script, through
``test_torch_figures.check_figure``: rows key for key, the KD bytes in
``comm_mb`` equal, accuracy in its band."""
from test_torch_figures import check_figure
from test_torch_federation import one_torch_thread  # noqa: F401


def test_mkd_figure_rows_match_reference(monkeypatch, capsys):
    rows = check_figure("2", monkeypatch, capsys)
    comm = [float(f["comm_mb"]) for _, f in rows]
    assert comm[1] == comm[2] > comm[0]      # KD's teacher and logit bytes
