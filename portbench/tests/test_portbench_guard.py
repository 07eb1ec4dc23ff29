"""The import guard, the harness's refusals, and a later PR's way in:
a new cell, traffic mix and metric reader are found by name."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness, spec
from portbench.tests import tiny

REF = os.path.join(spec.HERE, "reference")


@pytest.mark.parametrize("mods,bad", [
    (["repro_torch", "repro_torch.core.fl_device", "torch"], []),
    (["repro", "repro.core"], ["repro"]),
    (["jax.numpy", "numpy"], ["jax"]),
    (["jaxlib", "flax.linen", "reprox"], ["flax", "jaxlib"]),
])
def test_forbidden_modules_compare_whole_names(mods, bad):
    assert harness.forbidden_modules(mods) == bad


@pytest.mark.parametrize("path", sorted(
    os.path.join(REF, f) for f in os.listdir(REF) if f.endswith(".py")))
def test_reference_imports_nothing_of_the_port(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    tops = {n.split(".")[0] for n in names}
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_reference_loads_no_port_module():
    code = ("import sys; import portbench.reference.lm, "
            "portbench.reference.fedmlp; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": spec.ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "musicgen-medium.fl_train", "--seed", "1", "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={k: v for k, v in os.environ.items()
                          if k != "PYTHONPATH"})


def test_refuses_without_a_cuda_device():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for hosts "
                    "without one")
    out = _run(spec.ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0 and out.stdout == ""


def test_a_later_cell_and_metric_are_files_and_entries(tmp_path):
    """A staged cell put back, and a new traffic mix, cell and per-layer
    metric: new files and new BENCHMARK.json entries in a copy, no
    existing file edited."""
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(os.path.join(dp, p), "rb").read()
              for dp, _, fs in os.walk(tmp_path / "portbench") for p in fs}
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        doc = tiny.with_staged(json.load(f))
    d = tmp_path / "portbench"
    (d / "traffic" / "fed_n27.json").write_text(json.dumps(
        {"name": "fed_n27", "peers": 27, "grid": [3, 3, 3],
         "local_batches": 2, "batch_size": 16, "participation_rate": 1.0,
         "dropout_rate": 0.0, "transport": "sim"}))
    (d / "workloads" / "marfl-text-mlp.fed_n27.json").write_text(json.dumps(
        {"name": "marfl-text-mlp.fed_n27", "config": "marfl-text-mlp",
         "traffic": "fed_n27", "entry": "federation",
         "kernels": ["group_mean"], "check_steps": 3,
         "trace_steps": 50, "faults": ["frozen"],
         "limits": {"grad": 1e-4, "change": 1e-4, "bytes": 0, "rows": 0}}))
    (d / "metrics" / "fed.kernel_launches.py").write_text(
        'UNIT = "launches/iter"\nLAYER = "federation aggregation"\n'
        'SOURCE = "device_trace"\nMOVES = "fed_iter_ms"\n'
        'BETTER = "lower"\n\n\ndef read(ctx):\n'
        '    return ctx.trace.kernel("group_mean")[0] / ctx.steps\n')
    doc["workloads"].append({"name": "marfl-text-mlp.fed_n27",
                             "config": "marfl-text-mlp",
                             "traffic": "fed_n27", "chips": 1,
                             "why": "the quickstart's N=27"})
    for m in doc["end_to_end"]:
        if "fed_n125" in str(m.get("workloads")):
            m["workloads"].append("marfl-text-mlp.fed_n27")
    doc["per_layer"].append({"name": "fed.kernel_launches",
                             "unit": "launches/iter", "better": "lower",
                             "source": "device_trace",
                             "layer": "federation aggregation",
                             "moves": "fed_iter_ms",
                             "workloads": ["marfl-text-mlp.fed_n27"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    bench = spec.Bench(str(tmp_path))
    cell = bench.cell("marfl-text-mlp.fed_n27")
    assert bench.traffic(cell["traffic"])["peers"] == 27
    assert hasattr(bench.entry(cell["entry"]), "Program")
    names = [m["name"] for m in bench.per_layer(cell["name"])]
    assert names == ["fed.kernel_launches"]
    assert "fed_iter_ms" in [m["name"] for m in bench.end_to_end(cell["name"])]
    reader = bench.reader("fed.kernel_launches")
    ctx = type("Ctx", (), {"steps": 2, "trace": type("T", (), {
        "kernel": staticmethod(lambda stem: (6, 1.0))})()})()
    assert reader.read(ctx) == 3
    after = {p: open(os.path.join(dp, p), "rb").read()
             for dp, _, fs in os.walk(tmp_path / "portbench") for p in fs
             if p in before}
    assert after == before
