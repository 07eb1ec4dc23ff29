#!/usr/bin/env python3
"""Time and profile the quickstart federation of one checkout on the GPU.

    python3 tools/quickstart_profile.py [--root DIR] [--label NAME]

Runs the port found under ``DIR/src`` (default: this checkout), with the
measuring code of this checkout's ``chipsmoke.federation``: 20 kernel-on
quickstart iterations (ms per iteration, the median of iterations
2..20, and group-mean launches per step), then ten steps traced by the
benchmark's reader (each layer's host and device ms, the aggregation's
kernel launches, the device's launches per step and busy share). Prints
one JSON line with the card's nvidia-smi name and power limit.

To compare two commits on one card, unpack each with ``git archive``
into a git-ignored directory and run this script on them in turns,
parent, change, change, parent, each in its own process, in one call.
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
    ap.add_argument("--root", type=Path, default=HERE,
                    help="checkout whose src/repro_torch is measured")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("quickstart_profile: no CUDA device")
    sys.path.insert(0, str(args.root.resolve() / "src"))
    sys.path.insert(1, str(HERE))
    from chipsmoke.common import smi_line
    from chipsmoke.federation import profile_quickstart, run_quickstart
    from repro_torch.core.federation import Federation
    from repro_torch.kernels import ops
    from repro_torch.quickstart import quickstart_config

    fed, _, accs, step_s, launches = run_quickstart(
        torch, Federation, quickstart_config(kernel_group_mean=True), ops)
    prof = profile_quickstart(torch)
    print(json.dumps({
        "label": args.label or str(args.root), "card": smi_line(),
        "ms_per_iteration": statistics.median(step_s[1:]) * 1e3,
        "step_ms": [t * 1e3 for t in step_s],
        "group_mean_launches_per_step": launches / len(step_s),
        "accuracy_every_5": accs, "comm_bytes": fed.comm_bytes,
        "profile": prof}), flush=True)


if __name__ == "__main__":
    main()
