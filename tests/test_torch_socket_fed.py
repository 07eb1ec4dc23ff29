"""The socket transport on the port's two entry points, on the CPU.

* ``Federation`` over ``transport="socket"``: three steps at N = 8 on
  the reference's inputs (``test_torch_federation.ref_step_inputs``)
  give the reference's theta and m within 1e-5, and the ledger of the
  port's own ``"sim"`` federation, byte for byte; every frame carried
  the peers' int8-serialized theta.
* ``launch/train.py --transport socket``: the comm-total line is the
  reference CLI's, run live, and the constant ``chip_smoke.py`` holds
  (wall-clock seconds masked); ``--peer-hosts`` without ``--transport
  socket`` is refused as the reference refuses it.
"""
import contextlib
import io
from pathlib import Path

import pytest

from repro.launch import train as ref_train

from repro_torch.core.federation import Federation, FederationConfig
from repro_torch.launch import train
from test_torch_federation import (_assert_trees_close, _pair,  # noqa: F401
                                   one_torch_thread, run_pair)

ROOT = Path(__file__).resolve().parents[1]


def test_socket_federation_matches_reference_and_sim():
    kw = dict(local_batches=2, transport="socket")
    ref_fed, ref_state, fed, state = _pair("text", 8, True, **kw)
    ref_state, state = run_pair(ref_fed, ref_state, fed, state, 3)
    assert fed.network.name == ref_fed.network.name == "socket"
    _assert_trees_close(state.params, ref_state.params)
    _assert_trees_close(state.momentum, ref_state.momentum)
    assert fed.ledger.by_source == ref_fed.ledger.by_source

    sim = Federation(FederationConfig(n_peers=8, task="text", seed=6,
                                      local_batches=2), device="cpu")
    sim_state = sim.init_state()
    for _ in range(3):
        sim_state = sim.step(sim_state)
    assert fed.comm_bytes == sim.comm_bytes
    assert fed.ledger.by_source == sim.ledger.by_source
    tr = fed.last_transcript
    assert tr.payload_bytes == tr.total_bytes > 0      # integral frames
    assert fed.sim_seconds > 0.0                       # wall-clock here


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def test_trainer_socket_line_is_the_references(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    from chipsmoke import refs as cs

    argv = ["--arch", "starcoder2-3b", *cs.TRAIN_CLI_BASE,
            *cs.TRAIN_CLI_CASES["socket"]]

    def line(out):
        return cs.wall_masked(next(ln for ln in out.splitlines()
                                   if ln.startswith("[train] comm total=")))

    want = cs.TRAIN_CLI_COMM["starcoder2-3b socket"]
    assert line(_run(train.main, [*argv, "--device", "cpu"])) == want
    assert line(_run(ref_train.main, argv)) == want


@pytest.mark.parametrize("transport", [None, "sim"])
def test_peer_hosts_needs_the_socket_transport(capsys, transport):
    argv = ["--arch", "starcoder2-3b", "--smoke", "--device", "cpu",
            "--peer-hosts", "book.json"]
    if transport:
        argv += ["--transport", transport]
    with pytest.raises(SystemExit) as e:
        train.main(argv)
    assert e.value.code == 2
    assert "pass --transport socket" in capsys.readouterr().err
