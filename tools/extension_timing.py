#!/usr/bin/env python3
"""Time the quickstart and each protocol extension in turns on the GPU.

    python3 tools/extension_timing.py [--reps R]

Runs the quickstart config (27 peers, kernel on, 20 iterations) plain
and under each of ``quickstart.EXTENSIONS`` in one process, ``R`` times
over (default 5), each repetition in turns: forward in even ones,
backward in odd ones, so a drift of the host's speed falls on every run
alike. Each run is measured as ``chipsmoke.federation`` measures it (ms per
iteration: the median of iterations 2..20, the card synchronized after
each step). Prints one JSON line per run, then one summary line: for
each extension its ms per iteration in every repetition and its paired
difference to the plain quickstart of the same repetition (min, median,
max), with the card's nvidia-smi name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("extension_timing: no CUDA device")
    sys.path.insert(0, str(HERE / "src"))
    sys.path.insert(1, str(HERE))
    from chipsmoke.common import smi_line
    from chipsmoke.federation import run_extension
    from repro_torch.kernels import ops
    from repro_torch.quickstart import (EXTENSIONS, extension_config,
                                        quickstart_config)

    card = smi_line()
    names = ["quickstart"] + list(EXTENSIONS)
    ms = {name: [] for name in names}
    kd_ms = {name: [] for name in names}
    run_extension(torch, quickstart_config(), ops)   # warm-up
    for rep in range(args.reps):
        for name in (names if rep % 2 == 0 else names[::-1]):
            cfg = (quickstart_config() if name == "quickstart"
                   else extension_config(name))
            r = run_extension(torch, cfg, ops)
            ms[name].append(statistics.median(r["step_s"][1:]) * 1e3)
            row = {"rep": rep, "run": name, "ms_per_iteration": ms[name][-1],
                   "first_step_ms": r["step_s"][0] * 1e3,
                   "launches": r["launches"], "card": card}
            if cfg.use_kd:      # the distilling steps after the first
                kd_ms[name].append(statistics.median(
                    r["step_s"][1:cfg.kd_iterations]) * 1e3)
                row["kd_step_ms"] = kd_ms[name][-1]
            print(json.dumps(row), flush=True)

    def spread(xs):
        return {"min": min(xs), "median": statistics.median(xs),
                "max": max(xs)}

    base = ms["quickstart"]
    summary = {}
    for name in names:
        summary[name] = {"ms_per_iteration": ms[name],
                         "delta_vs_quickstart": spread(
                             [a - b for a, b in zip(ms[name], base)])}
        if kd_ms[name]:
            summary[name]["kd_step_delta_vs_quickstart"] = spread(
                [a - b for a, b in zip(kd_ms[name], base)])
    print(json.dumps({"summary": summary, "reps": args.reps, "card": card}),
          flush=True)


if __name__ == "__main__":
    main()
