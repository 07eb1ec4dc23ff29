"""BENCHMARK.json and the files it names keep to the benchmark's
contract: names, units, lengths, the files each entry needs, and which
cells report which metrics. The staged cells' entries (``staged/``) are
held to it too, so that they can be added to BENCHMARK.json as they
are."""
import json
import os

import pytest

from portbench import spec
from portbench.tests import tiny

LIVE = spec.Bench().spec
SPEC = tiny.with_staged(LIVE)
BENCH = spec.Bench(spec=SPEC)
CELLS = [w["name"] for w in SPEC["workloads"]]
CONFIGS = [c["name"] for c in SPEC["configs"]]
E2E = [m["name"] for m in SPEC["end_to_end"]]
PER_LAYER = [m["name"] for m in SPEC["per_layer"]]
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def _line(text, limit=200):
    return (isinstance(text, str) and 1 <= len(text) <= limit
            and "\n" not in text and "\t" not in text)


def test_top_level_keys_and_command():
    assert set(LIVE) == TOP_KEYS
    assert LIVE["command"] == ["python3", "portbench/run.py"]
    assert LIVE["paths"] == ["portbench"]
    assert isinstance(LIVE["run_seconds"], int)
    assert 1 <= LIVE["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024
    assert all(_line(w) for w in LIVE["command"])
    # every configuration is some live cell's
    assert {c["name"] for c in LIVE["configs"]} \
        == {w["config"] for w in LIVE["workloads"]}


def test_staged_cells_are_not_live():
    staged = os.path.join(spec.HERE, "staged")
    for f in os.listdir(staged):
        with open(os.path.join(staged, f)) as fh:
            part = json.load(fh)
        assert set(part) <= TOP_KEYS - {"command", "paths", "run_seconds"}
        for key, entries in part.items():
            assert not {e["name"] for e in entries} \
                & {e["name"] for e in LIVE[key]}


def test_names_are_unique():
    for group in (CELLS, CONFIGS, E2E + PER_LAYER):
        assert len(group) == len(set(group))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_at_most_a_quarter_of_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file(name):
    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"] == f"portbench/configs/{name}.json"
    cfg = BENCH.config(name)
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["source"] == entry["source"]
    assert _line(entry["source"]) and _line(entry["why"])
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        spec.check_name(key, "reduced key")
        assert not key.endswith(("_dim", "_rank", "_size"))
        assert key in cfg
    assert name in {w["config"] for w in SPEC["workloads"]}


@pytest.mark.parametrize("name", CELLS)
def test_cell_files(name):
    entry = next(w for w in SPEC["workloads"] if w["name"] == name)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        spec.check_name(entry[key], key)
    assert _line(entry["why"])
    cell = BENCH.cell(name)
    BENCH.config(cell["config"])
    BENCH.traffic(cell["traffic"])
    assert hasattr(BENCH.entry(cell["entry"]), "Program")
    assert cell["limits"] and all(v >= 0 for v in cell["limits"].values())
    # the libraries set-up builds are sources of the port
    csrc = os.path.join(spec.ROOT, "src", "repro_torch", "kernels", "csrc")
    assert all(os.path.isfile(os.path.join(csrc, k + ".cu"))
               for k in cell["kernels"])


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_reports_enough(name):
    e2e = [m["name"] for m in BENCH.end_to_end(name)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert BENCH.per_layer(name)


@pytest.mark.parametrize("name", E2E)
def test_end_to_end_metric(name):
    m = next(m for m in SPEC["end_to_end"] if m["name"] == name)
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                      "source"}
    spec.check_name(name, "metric")
    assert spec.UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("name", PER_LAYER)
def test_per_layer_metric(name):
    m = next(m for m in SPEC["per_layer"] if m["name"] == name)
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}
    spec.check_name(name, "metric")
    assert spec.UNIT.match(m["unit"]) and _line(m["layer"])
    assert m["source"] in spec.SOURCES
    reader = BENCH.reader(name)
    assert (reader.UNIT, reader.LAYER, reader.SOURCE, reader.MOVES,
            reader.BETTER) == (m["unit"], m["layer"], m["source"],
                               m["moves"], m["better"])
    assert callable(reader.read)
    if name.endswith("_roofline") or "mfu" in name:
        assert m["unit"] == "%"


@pytest.mark.parametrize("name", PER_LAYER)
def test_moves_names_an_end_to_end_metric_of_each_cell(name):
    m = next(m for m in SPEC["per_layer"] if m["name"] == name)
    assert m["moves"] in E2E
    for cell in m.get("workloads", CELLS):
        assert cell in CELLS
        assert m["moves"] in [e["name"] for e in BENCH.end_to_end(cell)]


def test_layers_have_one_spelling():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert len({x.lower() for x in layers}) == len(layers)


def test_files_under_paths_are_named_from_names():
    for dirpath, dirs, files in os.walk(BENCH.dir):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), spec.ROOT)
            assert all(c.isascii() and (c.isalnum() or c in "_.-/")
                       for c in rel), rel


def test_benchmark_json_round_trips():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        assert json.load(f) == LIVE
