"""What every entry does on the device: set up CUDA, build the cell's
kernels, synchronize, start the window, and trace a window of steps."""
from __future__ import annotations

import gc
import os
import subprocess
import time
from typing import Callable, Iterable, List, Tuple

import torch

from portbench import trace


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def init(device: torch.device) -> float:
    """Seconds to bring up the device's context."""
    t = time.perf_counter()
    torch.zeros(1, device=device)
    sync(device)
    return time.perf_counter() - t


def build_kernels(device: torch.device, names: Iterable[str]
                  ) -> Tuple[float, List[str]]:
    """Build those of the cell's CUDA libraries (``csrc/<name>.cu``) that
    are not built yet, one ``nvcc`` each in parallel, with the port's own
    flags and at the path where its ``kernels/_build.load`` looks, inside
    the checkout: only a checkout's first run builds. Returns the seconds
    it took and the names it compiled."""
    t = time.perf_counter()
    if device.type != "cuda":
        return time.perf_counter() - t, []
    from repro_torch.kernels import _build

    _build.BUILD_DIR.mkdir(exist_ok=True)
    jobs = {}
    for name in names:
        out = _build._library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp),
               str(_build.CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t, sorted(jobs)


def start_window(device: torch.device) -> int:
    """Collect the set-up's garbage and start the window's memory peak
    afresh. Returns the set-up's peak in bytes."""
    gc.collect()
    if device.type != "cuda":
        return 0
    sync(device)
    peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    return peak


def peak_bytes(device: torch.device) -> int:
    """The peak since the last reset (``start_window``)."""
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def traced(device: torch.device, steps: Callable[[], None],
           labels: Iterable[str]) -> trace.Summary:
    """``steps()`` under ``torch.profiler`` inside the window label,
    synchronized before the window closes."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW):
            steps()
            sync(device)
    return trace.summarize(prof.events(), labels)
