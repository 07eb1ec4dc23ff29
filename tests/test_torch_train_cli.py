"""The port's LM trainer CLI (``repro_torch.launch.train``) on the CPU.

* The ``[train] comm total=...`` line, byte for byte, against the
  reference's for starcoder2-3b and musicgen-medium at their smoke
  configs under each case of ``chipsmoke.refs.TRAIN_CLI_CASES`` (the
  default, ``--churn sessions``, ``--link-profile wireless --link-loss
  0.1`` and ``--resize-at 2:2``): the constant ``chip_smoke.py`` holds
  (``tools/reference_constants.py``), and the reference's own CLI run
  live beside the port.
* Every architecture trains 3 steps at 4 peers with finite losses.
* ``--ckpt-dir`` then ``--resume`` with another ``--peers`` restores
  elastically; the large-N flags (``--adaptive-m``, ``--placement``,
  ``--transport vector_sim | super_sim``) give the reference's regroup
  and comm-total lines at 16 peers; the socket transport's flags
  (``--transport socket``, ``--peer-hosts``, ``--rank``) give the
  reference's line per rank; without ``--device`` the trainer raises
  where there is no CUDA.
"""
import contextlib
import io
import json
import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

from repro.launch import train as ref_train

from repro_torch.configs import ARCH_IDS
from repro_torch.launch import train
from repro_torch.runtime.socket_transport import AddressBook
from test_torch_federation import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _refs(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    from chipsmoke import refs
    return refs


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _comm(out: str) -> str:
    return next(ln for ln in out.splitlines()
                if ln.startswith("[train] comm total="))


@pytest.mark.parametrize("case", ["default", "sessions", "wireless",
                                  "resize"])
@pytest.mark.parametrize("arch", ["starcoder2-3b", "musicgen-medium"])
def test_comm_line_is_the_references(monkeypatch, arch, case):
    cs = _refs(monkeypatch)
    argv = ["--arch", arch, *cs.TRAIN_CLI_BASE, *cs.TRAIN_CLI_CASES[case]]
    out = _run(train.main, [*argv, "--device", "cpu"])
    want = cs.TRAIN_CLI_COMM[f"{arch} {case}"]
    assert _comm(out) == want
    assert _comm(_run(ref_train.main, argv)) == want
    if case == "resize":
        assert "elastic resize at step 2: 4 -> 2 peers" in out


def test_regions_shuffle_line_is_the_references():
    argv = ["--arch", "starcoder2-3b", "--smoke", "--steps", "2",
            "--peers", "4", "--seq", "16", "--link-profile", "regions",
            "--link-shuffle"]
    out = _run(train.main, [*argv, "--device", "cpu"])
    assert _comm(out) == _comm(_run(ref_train.main, argv))
    assert "comm_s=" in _comm(out)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_architecture_trains_with_finite_losses(arch, tmp_path):
    metrics = tmp_path / "m.jsonl"
    out = _run(train.main, ["--arch", arch, "--smoke", "--device", "cpu",
                            "--steps", "3", "--peers", "4", "--seq", "32",
                            "--metrics", str(metrics)])
    assert "params=" in out and "grid=(2, 2)" in out
    losses = [json.loads(ln)["loss"]
              for ln in metrics.read_text().splitlines()]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)


def test_checkpoint_then_elastic_resume(tmp_path):
    base = ["--arch", "starcoder2-3b", "--smoke", "--device", "cpu",
            "--seq", "16", "--ckpt-dir", str(tmp_path)]
    out = _run(train.main, [*base, "--steps", "2", "--peers", "4"])
    assert "[train] checkpointed at 2" in out
    seen = []
    out = _run(lambda a: train.main(a, on_step=seen.append),
               [*base, "--steps", "1", "--peers", "2", "--resume"])
    # the reference prints the restored metadata, whose n_peers
    # restore_elastic has already set to the new count
    assert "resumed from step 2 (was 2 peers)" in out
    assert "[train] checkpointed at 3" in out
    state = seen[0]["state"]
    assert all(x.shape[0] == 2 for x in
               torch.utils._pytree.tree_leaves(state["params"]))
    meta = json.loads((tmp_path / "step_0000000003" / "manifest.json")
                      .read_text())["metadata"]
    assert meta["n_peers"] == 2 and meta["grid_dims"] == [2]


def _socket_ranks(argv, book, ranks, timeout_s=120.0):
    """Run ``ranks`` of a socket world, one thread each, sharing one
    captured stdout; returns it. Each thread's wait is bounded."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), ThreadPoolExecutor(len(ranks)) \
            as ex:
        futures = [ex.submit(train.main, [*argv, "--peer-hosts", book,
                                          "--rank", str(r)])
                   for r in ranks]
        assert [f.result(timeout=timeout_s) for f in futures] == \
            [0] * len(ranks)
    return buf.getvalue()


# the ids are those of the tests that held these flags refused (Queue 1
# item 14), so each case keeps its name
@pytest.mark.parametrize("world_size", [
    pytest.param(0, id="flags0-Queue 1 item 14"),     # --transport socket
    pytest.param(1, id="flags1-Queue 1 item 14"),     # --peer-hosts
    pytest.param(2, id="flags2-Queue 1 item 14"),     # --rank
])
def test_unported_flags_name_their_item(monkeypatch, tmp_path, world_size):
    """The flags of the socket transport, once refused, run the smoke
    trainer over loopback TCP: in one process (``--transport socket``),
    as the only rank of an address book (``--peer-hosts``), and as rank
    1 of a two-rank book beside rank 0 (``--rank``). Each rank's
    comm-total line is the reference's, wall-clock seconds masked: the
    whole ledger for one rank, the nodes' receptions for each of two."""
    cs = _refs(monkeypatch)
    argv = ["--arch", "starcoder2-3b", *cs.TRAIN_CLI_BASE, "--device",
            "cpu", "--transport", "socket"]
    if world_size == 0:
        out = _run(train.main, argv)
        want = [cs.TRAIN_CLI_COMM["starcoder2-3b socket"]]
    else:
        book = str(tmp_path / "book.json")
        AddressBook.loopback(4, world_size=world_size).to_json(book)
        out = _socket_ranks(argv, book, range(world_size))
        want = ([cs.TRAIN_CLI_COMM["starcoder2-3b socket"]]
                if world_size == 1 else cs.TRAIN_CLI_RANKS["starcoder2-3b"])
        for r in range(world_size):
            assert f"over {world_size} ranks; this is rank {r}" in out
    got = [cs.wall_masked(ln) for ln in out.splitlines()
           if ln.startswith("[train] comm total=")]
    assert sorted(got) == sorted(want)
    assert "[wall-clock]" in got[0]


@pytest.mark.parametrize("case", ["adaptive_m", "placement", "vector_sim",
                                  "super_sim", "schedule"])
def test_large_n_flags_give_the_references_lines(monkeypatch, case):
    """``--adaptive-m``, ``--placement`` and ``--transport vector_sim |
    super_sim`` at 16 peers: the regroup and comm-total lines, byte for
    byte, are the constant ``chip_smoke.py`` holds and the reference's
    CLI's, run live. The placement cases regroup after step 1 and bill
    their probes; ``schedule`` injects a ``ScheduleController`` into
    both packages, so the trainer's adaptive regroup (the pipeline
    re-bound, the step rebuilt for (4, 4)) runs and the ledger follows
    the new grid."""
    from repro.core import adaptive as ref_adaptive

    cs = _refs(monkeypatch)
    flags, want = cs.TRAIN_CLI_LARGE_N[case]
    if case == "schedule":
        for mod, attr in ((ref_adaptive, "build_controller"),
                          (train, "build_controller")):
            real = getattr(mod, attr)
            monkeypatch.setattr(mod, attr, (
                lambda real: lambda name, plan, **kw: real(
                    name, plan, schedule=cs.TRAIN_CLI_LARGE_N_SCHEDULE,
                    **kw))(real))
    argv = [*cs.TRAIN_CLI_LARGE_N_BASE, *flags]

    def lines(out):
        return tuple(ln for ln in out.splitlines()
                     if "regroup" in ln or ln.startswith("[train] comm"))

    assert lines(_run(train.main, [*argv, "--device", "cpu"])) == want
    assert lines(_run(ref_train.main, argv)) == want


def test_runs_on_cuda_by_default_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "starcoder2-3b", "--smoke", "--steps", "1"])
