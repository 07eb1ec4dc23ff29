"""What the card gate's phases share: the JSON lines and the checks, the
card's name, CUDA-event timing, the profile lines read from a
``portbench.trace.Summary`` (a ``portbench.device.traced`` window: busy
time is the union of the device's intervals, as the benchmark's
``device_idle`` reads it), nvcc's register report and the kernels
line."""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

from chipsmoke.refs import PORT_KERNELS

ROOT = Path(__file__).resolve().parent.parent
L2_FLUSH_BYTES = 256 << 20     # written before a timed call: > 50 MB L2


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, reps: int = 20, warmup: int = 3,
              flush=None, spin: int = 2_000_000) -> float:
    """Median device time of ``reps`` calls of ``fn``. Before each, the
    card spins for ``spin`` cycles, about a millisecond by default
    (``torch.cuda._sleep``), while the host queues the start event, the
    call and the end event, so the interval holds the call's kernels and
    not the host's Python (a call that queues many launches needs a
    longer spin). With ``flush`` (a tensor larger than the L2 cache) it
    is overwritten before each call, so the call finds its inputs in
    device memory as the model's layers do."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def top_kernels(summary, steps: int, n: int) -> list:
    """The ``n`` device operations of ``summary`` with the most time, per
    step."""
    top = sorted(summary.kernels.items(), key=lambda kv: -kv[1][1])[:n]
    return [{"name": k, "launches": c / steps, "device_us": us / steps}
            for k, (c, us) in top]


def device_profile(summary, steps: int) -> dict:
    """Per step of a traced window: wall and device-busy time, the busy
    share, device operations, the eight with the most time, and the
    port's own kernels (PORT_KERNELS) with their share of the busy
    time."""
    busy = summary.busy_us
    port = {}
    for stem in PORT_KERNELS:
        c, us = summary.kernel(stem)
        if c:
            port[stem] = {"launches": c / steps, "device_us": us / steps,
                          "share_of_busy": us / busy}
    return {"wall_ms_per_step": summary.window_us / steps / 1e3,
            "port_kernels_per_step": port,
            "device_busy_ms_per_step": busy / steps / 1e3,
            "device_busy_share": busy / summary.window_us,
            "kernel_launches_per_step":
                sum(c for c, _ in summary.kernels.values()) / steps,
            "top_kernels_per_step": top_kernels(summary, steps, 8)}


def label_profile(summary, label: str, steps: int) -> dict:
    """Per step of a traced window: the host time inside ``label``'s
    ranges, the kernel launches issued there and the device time of the
    work they queued, and that time's share of the busy time."""
    span = summary.span(label)
    check(span is not None and span.device_us > 0,
          f"profile: no device time under {label}")
    return {"label": label, "ranges_per_step": span.count / steps,
            "host_ms_per_step": span.host_us / steps / 1e3,
            "launches_per_step": span.launches / steps,
            "device_ms_per_step": span.device_us / steps / 1e3,
            "share_of_busy": span.device_us / summary.busy_us}


def ptxas_summary(report: dict, sources) -> list:
    """Registers, spill bytes and static shared memory of every kernel
    the named sources compiled, read from nvcc's ``-Xptxas -v`` log
    (dynamic shared memory is set at launch: see the sources)."""
    import re
    import shutil

    demangle = shutil.which("c++filt")
    out, cur = [], None
    for src in sources:
        for ln in report.get(src, {}).get("log", "").splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                name = m.group(1)
                if demangle:
                    name = subprocess.run([demangle, name], text=True,
                                          capture_output=True).stdout
                    name = name.replace("(anonymous namespace)::", "")
                    name = name.strip().split("(")[0].removeprefix("void ")
                cur = {"source": src, "kernel": name}
                out.append(cur)
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                cur["spill_stores"] = int(m.group(1))
                cur["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", ln)
                cur["static_smem"] = int(sm.group(1)) if sm else 0
    return out


#: the kernels line, in its order: each kernel's CUDA source
#: (``csrc/<name>.cu``) and what it replaces in the JAX package
KERNELS = {
    "group_mean": ("group_mean", "src/repro/kernels/group_mean.py:34"),
    "flash_attention": ("flash_attention",
                        "src/repro/kernels/flash_attention.py:76"),
    "paged_decode_attention": ("decode_attention",
                               "src/repro/kernels/paged_attention.py:76"),
    "decode_attention": ("decode_attention",
                         "src/repro/kernels/decode_attention.py:67"),
    "ssd_scan": ("ssd_scan", "src/repro/kernels/ssd_scan.py:70"),
    "ssd_scan_bwd": ("ssd_scan", "none: the Pallas scan has no backward"),
    "mar_rounds": ("mar_rounds", "src/repro/core/mar_allreduce.py:166"),
}


def launch_totals(paths) -> dict:
    """Each kernel of KERNELS with its launches summed over ``paths``,
    the ``{kernel: launches}`` of every main path that ran."""
    totals = dict.fromkeys(KERNELS, 0)
    for counts in paths:
        for name, n in counts.items():
            totals[name] += n
    return totals


def kernels_line(totals: dict, rows: dict) -> list:
    """One entry per kernel of KERNELS: its launches on the main paths
    (``totals``) and its phase's main-path row (``rows``; a row's own
    ``row`` names it where it is not the kernel's)."""
    out = []
    for name, (source, replaces) in KERNELS.items():
        row = rows[name]
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{source}.cu",
                 "replaces": replaces, "launches": totals[name],
                 "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": ("bytes" if row["bytes_ms"] >= row["ops_ms"]
                              else "operations"),
                 "library_ms": row["library_ms"]}
        if "row" in row:
            entry["row"] = row["row"]
        out.append(entry)
    return out
