"""The readings the limits of ``correct`` are set from, on the chip at a
cell's own size (the benchmark's runs never run this):

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--faulted 3] [--out chiprun_out/calib.jsonl]

For every seed: the port's check steps against the float32 reference
(the lower readings). For the first ``--faulted`` seeds besides: the
control, the reference in the port's place one precision below the
configuration's (``bfloat16`` -> ``float8``, ``float32`` -> ``tf32``),
against the float32 reference; and each of the cell's faults
(``faults.py``) planted in the port, against it too. ``frozen`` needs
no run: a state left unchanged reads 1. One JSON line per reading.
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from portbench import check, harness, spec  # noqa: E402

CONTROL = {"bfloat16": "float8", "float32": "tf32"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faulted", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        harness.log("calibrate needs a CUDA device")
        return 3
    device = torch.device("cuda", 0)
    bench = spec.Bench()
    cell = bench.cell(args.workload)
    entry = bench.entry(cell["entry"])
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None

    def emit(**row):
        row["cell"] = cell["name"]
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def program(seed, planted=()):
        prog = entry.Program(bench, cell, seed, device, planted)
        prog.setup()
        prog.release()
        free()
        return prog

    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        prog = program(seed)
        ref = prog.reference()
        free()
        emit(seed=seed, run="program",
             numbers=check.compare(prog.readings, ref),
             loss=prog.readings.get("loss"), ref_loss=ref.get("loss"),
             seconds=time.perf_counter() - t)
        if i >= args.faulted:
            continue
        t = time.perf_counter()
        precision = CONTROL[prog.cfg["dtype"]]
        low = prog.reference(precision)
        free()
        emit(seed=seed, run=f"control_{precision}",
             numbers=check.compare(low, ref),
             seconds=time.perf_counter() - t)
        for fault in cell["faults"]:
            if fault == "frozen":
                continue
            t = time.perf_counter()
            bad = program(seed, (fault,))
            emit(seed=seed, run=f"fault_{fault}",
                 numbers=check.compare(bad.readings, ref),
                 seconds=time.perf_counter() - t)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
