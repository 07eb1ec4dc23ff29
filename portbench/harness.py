"""One run of one cell.

Set-up (its parts printed on standard error), then either the measured
window (``--trace 0``: the cell's end-to-end metrics) or a short traced
window (``--trace 1``: its per-layer metrics), then, with the port's
state freed, the plain reference over the same check steps and the
comparison that decides ``correct``. The last line on standard output
is the result; the numbers compared, each beside its limit, are the last
lines on standard error and the last key of the result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Any, Dict, List, Optional

from portbench import check, spec as specmod

#: top-level modules no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> List[str]:
    """Forbidden top-level names among ``modules`` (``sys.modules`` by
    default), compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in list(names)}
                  & set(FORBIDDEN))


def _parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(bench: specmod.Bench, cell: Dict[str, Any], seed: int,
        seconds: float, trace: bool, device, t0: float,
        planted=()) -> Dict[str, Any]:
    """The result of one run, in process; ``device`` may be the CPU
    (tests), where a traced run raises."""
    import torch

    from portbench import device as dev

    entry = bench.entry(cell["entry"])
    prog = entry.Program(bench, cell, seed, device, planted)
    parts = prog.setup()
    for part, s in parts.items():
        log(f"setup {part}_s={s:.4f}")
    setup_s = time.perf_counter() - t0
    log(f"setup_s={setup_s:.4f} (run_seconds={seconds:g})")
    cuda = device.type == "cuda"
    dev_info: Dict[str, Any] = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": cell["chips"]}
    if prog.built:
        # this run compiled the cell's kernels: its set-up counts the build
        dev_info["kernels_built"] = prog.built
        dev_info["kernel_build_s"] = parts["kernel_build"]
    metrics: Dict[str, Dict[str, Any]] = {}
    breakdown = None
    setup_peak = dev.start_window(device)
    if trace:
        summary, steps = prog.traced()
        ctx = Context(bench, cell, prog.cfg, prog.mix, summary, steps)
        for m in bench.per_layer(cell["name"]):
            value = bench.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        attempted, failed = steps, 0
        dev_info["busy_s"] = summary.busy_us / 1e6
        dev_info["window_s"] = summary.window_us / 1e6
        breakdown = summary.breakdown()
    else:
        e2e, attempted, failed = prog.measure(seconds)
        e2e["setup_s"] = setup_s
        for m in bench.end_to_end(cell["name"]):
            if m["name"] not in e2e:
                raise RuntimeError(f"{cell['entry']} does not measure "
                                   f"{m['name']}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    # the process's peak, set-up and window, before the reference runs
    dev_info["memory_peak_bytes"] = int(max(setup_peak,
                                            dev.peak_bytes(device)))
    prog.release()
    t = time.perf_counter()
    ref = prog.reference()
    log(f"reference_s={time.perf_counter() - t:.4f}")
    checks = check.judge(check.compare(prog.readings, ref), cell["limits"])
    out: Dict[str, Any] = {
        "correct": check.passed(checks) and failed == 0,
        "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return out


class Context:
    """What a per-layer metric's reader reads: the traced window's
    summary (``trace.Summary``), the steps it holds, and the cell's
    configuration and traffic."""

    def __init__(self, bench, cell, cfg, mix, summary, steps: int):
        self.bench, self.cell, self.cfg, self.mix = bench, cell, cfg, mix
        self.trace, self.steps = summary, steps

    @property
    def step_s(self) -> float:
        """Seconds a step in the traced window."""
        return self.trace.window_us / 1e6 / self.steps

    def flops_per_step(self) -> float:
        return self.bench.entry(self.cell["entry"]).flops_per_step(
            self.cfg, self.mix)


def _json_number(x: float) -> Optional[float]:
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def emit(result: Dict[str, Any]) -> None:
    for name, c in result["checks"].items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    out = dict(result)
    out["checks"] = {k: {"value": _json_number(v["value"]),
                         "limit": v["limit"]}
                     for k, v in result["checks"].items()}
    print(json.dumps(out), flush=True)


def main(argv, t0: float) -> int:
    args = _parse(argv)
    bench = specmod.Bench()
    cell = bench.cell(args.workload)
    if not os.path.isdir(os.path.join(bench.root, "src", "repro_torch")):
        log("the port (src/repro_torch) is not in this checkout")
        return 2
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        log(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count()}")
        return 3
    result = run(bench, cell, args.seed, args.seconds, bool(args.trace),
                 torch.device("cuda", 0), t0)
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded forbidden modules: {bad}")
        return 4
    emit(result)
    return 0
