"""The benchmark's files, found by name.

``BENCHMARK.json`` at the root lists the cells and metrics. Under this
folder each piece has a file of its own:

* ``configs/<config>.json``   a model configuration, as it is run
* ``traffic/<traffic>.json``  a traffic mix: the generator's parameters
* ``workloads/<cell>.json``   a cell: its config, traffic, entry, the
  port's CUDA libraries it launches, trace window, fault list and the
  limits of its correctness numbers
* ``entries/<entry>.py``      the driver of one path of the port
* ``metrics/<metric>.py``     the reader of one per-layer metric

A later cell, configuration, mix or metric is new files and new entries
in ``BENCHMARK.json``; no file here needs an edit. ``staged/<cell>.json``
holds the ``BENCHMARK.json`` entries of a cell whose files are here but
which is not measured yet: putting it back is copying them over.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def check_name(name: Any, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{what} {name!r} is not a valid name")
    return name


def _load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _load_module(path: str, tag: str) -> ModuleType:
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    mod_name = "portbench_" + re.sub(r"[^A-Za-z0-9_]", "_", tag)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` and the files under ``portbench/`` of one
    checkout (``root``)."""

    def __init__(self, root: str = ROOT,
                 spec: Optional[Dict[str, Any]] = None):
        self.root = root
        self.dir = os.path.join(root, "portbench")
        self.spec = spec if spec is not None else _load_json(
            os.path.join(root, "BENCHMARK.json"))
        self._modules: Dict[str, ModuleType] = {}

    # -- files by name -----------------------------------------------------
    def _file(self, kind: str, name: str, ext: str) -> str:
        return os.path.join(self.dir, kind, check_name(name, kind) + ext)

    def config(self, name: str) -> Dict[str, Any]:
        cfg = _load_json(self._file("configs", name, ".json"))
        if cfg.get("name") != name:
            raise ValueError(f"configs/{name}.json names {cfg.get('name')!r}")
        return cfg

    def traffic(self, name: str) -> Dict[str, Any]:
        mix = _load_json(self._file("traffic", name, ".json"))
        if mix.get("name") != name:
            raise ValueError(f"traffic/{name}.json names {mix.get('name')!r}")
        return mix

    def cell(self, name: str) -> Dict[str, Any]:
        """The cell's file merged with its ``BENCHMARK.json`` entry, which
        has to agree with it on the configuration and the traffic."""
        entry = next((w for w in self.spec["workloads"]
                      if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        cell = _load_json(self._file("workloads", name, ".json"))
        for key in ("name", "config", "traffic"):
            if cell.get(key) != entry[key]:
                raise ValueError(f"workloads/{name}.json has {key} "
                                 f"{cell.get(key)!r}, BENCHMARK.json "
                                 f"{entry[key]!r}")
        return {**cell, "chips": entry["chips"], "why": entry["why"]}

    def _module(self, kind: str, name: str) -> ModuleType:
        key = f"{kind}/{name}"
        if key not in self._modules:
            self._modules[key] = _load_module(
                self._file(kind, name, ".py"), f"{kind}_{name}")
        return self._modules[key]

    def entry(self, name: str) -> ModuleType:
        """``entries/<name>.py``: its ``Program`` and ``flops_per_step``."""
        return self._module("entries", name)

    def reader(self, metric: str) -> ModuleType:
        """``metrics/<metric>.py``: ``UNIT``, ``LAYER``, ``SOURCE``,
        ``MOVES``, ``BETTER`` and ``read(ctx)``, which returns ``None``
        where the trace holds nothing to read."""
        return self._module("metrics", metric)

    # -- metrics of a cell -------------------------------------------------
    @staticmethod
    def _reports(metric: Dict[str, Any], cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell: str) -> List[Dict[str, Any]]:
        return [m for m in self.spec["end_to_end"] if self._reports(m, cell)]

    def per_layer(self, cell: str) -> List[Dict[str, Any]]:
        return [m for m in self.spec["per_layer"] if self._reports(m, cell)]
