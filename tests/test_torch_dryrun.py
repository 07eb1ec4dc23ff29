"""The dry run (``repro_torch.launch.dryrun``) and its hillclimb ladders.

The reference's ``launch/dryrun.py`` and ``hillclimb.py`` set
``XLA_FLAGS`` when imported, so this file never imports them: their
record keys and ladders are read with ``ast``."""
import ast
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro.runtime.roofline import RooflineReport as RefReport

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch.dryrun import dryrun_cell, fake_world
from repro_torch.launch.mesh import make_test_mesh

REF = os.path.join(os.path.dirname(__file__), "..", "src", "repro", "launch")


def _ref_record_keys():
    """The keys of a reference dry-run record: the report's ``to_dict``
    and the ``rec.update(...)`` keywords of ``dryrun_cell``."""
    keys = set(RefReport("a", "s", "m", 1, 0.0, 0.0, 0.0, {}, 0.0,
                         {}).to_dict())
    tree = ast.parse(open(os.path.join(REF, "dryrun.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "update" and getattr(node.func.value, "id", "") == "rec":
            keys |= {kw.arg for kw in node.keywords}
    return keys


def _smoke_overrides(arch):
    full, smoke = get_config(arch), get_smoke_config(arch)
    return {f.name: getattr(smoke, f.name) for f in dataclasses.fields(full)
            if f.name != "name"
            and getattr(smoke, f.name) != getattr(full, f.name)}


@pytest.fixture(scope="module")
def cells():
    """A smoke train cell and a decode cell on a fake (2, 2, 2) mesh."""
    out = {}
    with fake_world(8):
        mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"),
                              device_type="cpu")
        out["train"] = dryrun_cell(
            "granite-8b", "train_4k", True, verbose=False, mesh=mesh,
            overrides=_smoke_overrides("granite-8b"))
        out["decode"] = dryrun_cell(
            "moonshot-v1-16b-a3b", "decode_32k", True, verbose=False,
            mesh=mesh, overrides=_smoke_overrides("moonshot-v1-16b-a3b"))
    return out


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_cell_ok_with_the_reference_record_keys(cells, kind):
    rec = cells[kind]
    assert rec["status"] == "ok", rec
    assert set(rec) == _ref_record_keys()
    assert rec["chips"] == 8 and rec["mesh"] == "multi-pod-2x2x2"
    assert rec["hlo_flops_per_chip"] > 0 and rec["hlo_bytes_per_chip"] > 0
    mem = rec["memory_per_chip"]
    assert mem["argument_size_in_bytes"] > 0
    assert mem["hbm_fraction"] == mem["total_bytes"] / 80e9
    assert rec["dominant"] in ("compute", "memory", "collective")


def test_train_cell_runs_the_mar_rounds_over_ranks(cells):
    """Peers over (pod, data): 4 peers, a rank each, on the grid (2, 2);
    each round is an all_reduce over 2 ranks, TP shards are gathered."""
    rec = cells["train"]
    assert rec["n_peers"] == 4 and rec["grid_dims"] == [2, 2]
    assert rec["peer_axes"] == ["pod", "data"]
    detail = rec["collective_detail"]
    assert detail["counts"]["all-reduce"] >= 2
    assert detail["counts"]["all-gather"] > 0


def test_failing_cell_is_recorded_and_counted(monkeypatch, capsys):
    def boom(*a, **k):
        raise RuntimeError("no plan")

    monkeypatch.setattr(dryrun, "dryrun_cell", boom)
    assert dryrun.main(["--arch", "granite-8b", "--shape", "train_4k"]) == 1
    assert "dry-run: 0 ok, 0 skipped, 1 FAILED" in capsys.readouterr().out


def test_skipped_cell():
    rec = dryrun_cell("granite-8b", "long_500k", False, verbose=False)
    assert rec["status"] == "skipped"


def _ref_ladders():
    """The reference's LADDERS literal (tuples and ``dict(...)`` calls)."""
    tree = ast.parse(open(os.path.join(REF, "hillclimb.py")).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) \
                and getattr(node.targets[0], "id", "") == "LADDERS":
            return eval(compile(ast.Expression(node.value), "<ladders>",
                                "eval"), {"__builtins__": {}, "dict": dict})


def test_hillclimb_ladders_equal_the_reference():
    ref = _ref_ladders()
    assert list(hillclimb.LADDERS) == list(ref)
    for pair in ref:
        assert [kw for _, kw in hillclimb.LADDERS[pair]] == \
            [kw for _, kw in ref[pair]]
        for label, _ in hillclimb.LADDERS[pair]:
            assert "v5e" not in label and "TPU" not in label


@pytest.mark.slow
def test_dryrun_smallest_cell_512(tmp_path):
    """The reference's 512-rank multi-pod cell through the CLI, in a
    subprocess (the fake process group is process-wide)."""
    out = tmp_path / "rec.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xlstm-350m", "--shape", "decode_32k", "--multi-pod", "--out",
         str(out)], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(out.read_text())[0]
    assert (rec["status"], rec["chips"]) == ("ok", 512)
    assert "of H100 HBM" in proc.stdout and "v5e" not in proc.stdout
