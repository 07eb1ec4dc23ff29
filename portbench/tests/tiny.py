"""A copy of the benchmark's folder at sizes the CPU tests can hold:
the same cells, entries, readers and limits, the staged cells among
them, with each configuration and traffic mix cut down (the LM's widths
too: the CPU tests check arithmetic and control flow, never speed; the
federation keeps the port's task and model, with fewer peers)."""
from __future__ import annotations

import copy
import glob
import json
import os
import shutil
from typing import Any, Dict

from portbench import spec

TINY_CONFIGS: Dict[str, Dict[str, Any]] = {
    "musicgen-medium": {"hidden_size": 64, "num_hidden_layers": 2,
                        "num_attention_heads": 4, "num_key_value_heads": 4,
                        "head_dim": 16, "ffn_dim": 128, "vocab_size": 96,
                        "dtype": "float32"},
}
TINY_TRAFFIC: Dict[str, Dict[str, Any]] = {
    "fl_train": {"seq": 16},
    "fl_train_30s": {"seq": 24},
    "fed_n125": {"peers": 8, "grid": [2, 2, 2]},
}


def _patch(path: str, changes: Dict[str, Any]) -> None:
    with open(path) as f:
        doc = json.load(f)
    doc.update(changes)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def with_staged(doc: Dict[str, Any]) -> Dict[str, Any]:
    """``doc`` (a ``BENCHMARK.json``) with the entries of every staged
    cell (``staged/<cell>.json``) appended."""
    doc = copy.deepcopy(doc)
    for path in sorted(glob.glob(os.path.join(spec.HERE, "staged",
                                              "*.json"))):
        with open(path) as f:
            part = json.load(f)
        for key, entries in part.items():
            doc[key].extend(entries)
    return doc


def make(root: str, configs=TINY_CONFIGS, traffic=TINY_TRAFFIC
         ) -> spec.Bench:
    """``root`` gets ``BENCHMARK.json``, with the staged cells, and
    ``portbench/`` with the tiny files; returns its ``Bench``."""
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        doc = with_staged(json.load(f))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(doc, f, indent=1)
    shutil.copytree(spec.HERE, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, changes in configs.items():
        _patch(os.path.join(root, "portbench", "configs", name + ".json"),
               changes)
    for name, changes in traffic.items():
        _patch(os.path.join(root, "portbench", "traffic", name + ".json"),
               changes)
    return spec.Bench(root)
