"""The traced run's reader: a ``torch.profiler`` window of the port's
steps reduced to what the per-layer metrics read.

The window is the harness's own label ``portbench.window`` around the
traced steps. Within it, for each of the port's ``record_function``
labels: its host time, the kernel launches issued under it, and the
device time of what those launches queued, matched to the device's
events by correlation id (kernels launched through ``ctypes`` count
too). Besides: device time by kernel name, the device's busy time (the
union of its kernel, copy and set intervals), and the ``breakdown``: the
device operations with the most time, and the device's idle time by what
the host was doing then. A window in which no operation ran on the
device raises: a CPU number is never reported under a device metric.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

WINDOW = "portbench.window"
_RUNTIME = ("LaunchKernel", "Memcpy", "Memset")
_TOP = 10


@dataclass
class Span:
    host_us: float = 0.0
    count: int = 0
    launches: int = 0
    device_us: float = 0.0


@dataclass
class Summary:
    window_us: float
    busy_us: float
    spans: Dict[str, Span]
    kernels: Dict[str, List[float]]          # name -> [count, device us]
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def span(self, label: str) -> Optional[Span]:
        s = self.spans.get(label)
        return s if s is not None and s.count else None

    def kernel(self, stem: str) -> Tuple[int, float]:
        """(launches, device us) of the kernels whose name holds
        ``stem``."""
        n, us = 0, 0.0
        for name, (c, t) in self.kernels.items():
            if stem in name:
                n += int(c)
                us += t
        return n, us

    def breakdown(self) -> Dict[str, List[List]]:
        return {"device_ops": [[n, s] for n, s in self.device_ops],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps]}


def _merge(intervals: Iterable[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events, labels: Iterable[str]) -> Summary:
    """``events``: ``prof.events()`` of a profile holding one
    ``portbench.window`` range; ``labels``: the port's labels to
    report."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    events = list(events)
    labels = set(labels)
    windows = [e for e in events if e.name == WINDOW
               and e.device_type == cpu]
    if len(windows) != 1:
        raise RuntimeError(f"trace holds {len(windows)} "
                           f"{WINDOW} ranges, expected 1")
    win = windows[0]
    w0, w1 = win.time_range.start, win.time_range.end
    thread = win.thread
    # names that are ranges, not device work: every host-side label
    annotations = {e.name for e in events if e.device_type == cpu
                   and getattr(e, "is_user_annotation", False)}
    annotations |= labels | {WINDOW}

    spans = {lab: Span() for lab in labels}
    by_label: Dict[str, List[Tuple[float, float]]] = {}
    host_ops = []
    runtime = []
    device = []
    for e in events:
        if e.device_type == cpu:
            a, b = e.time_range.start, e.time_range.end
            if b < w0 or a > w1:
                continue
            if e.name in labels:
                s = spans[e.name]
                s.host_us += b - a
                s.count += 1
                by_label.setdefault(e.name, []).append((a, b))
            if any(w in e.name for w in _RUNTIME):
                runtime.append(e)
            if e.thread == thread and e.name != WINDOW:
                host_ops.append(e)
        elif e.name not in annotations:
            device.append(e)
    # launches issued inside a label -> the label, by correlation id;
    # a label's own ranges never overlap, labels may nest in each other
    for r in by_label.values():
        r.sort()
    starts = {lab: [a for a, _ in r] for lab, r in by_label.items()}
    issued: Dict[int, List[str]] = {}
    for e in runtime:
        t = e.time_range.start
        hit = []
        for lab, r in by_label.items():
            i = bisect.bisect_right(starts[lab], t) - 1
            if i >= 0 and t <= r[i][1]:
                hit.append(lab)
                spans[lab].launches += "LaunchKernel" in e.name
        if hit:
            issued[e.id] = hit
    kernels: Dict[str, List[float]] = {}
    intervals = []
    for e in device:
        a, b = e.time_range.start, e.time_range.end
        if b < w0 or a > w1:
            continue
        us = b - a
        k = kernels.setdefault(e.name[:96], [0, 0.0])
        k[0] += 1
        k[1] += us
        intervals.append((max(a, w0), min(b, w1)))
        for lab in issued.get(e.id, ()):
            spans[lab].device_us += us
    busy = _merge(intervals)
    busy_us = sum(b - a for a, b in busy)
    if busy_us <= 0:
        raise RuntimeError("the profiler recorded no device time in the "
                           "window: no device metric can be read")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:_TOP]
    summary = Summary(window_us=w1 - w0, busy_us=busy_us, spans=spans,
                      kernels=kernels,
                      device_ops=[(n, t / 1e6) for n, (_, t) in top])
    summary.idle_gaps = _idle_by_host(busy, w0, w1, host_ops, labels)
    return summary


def _idle_by_host(busy, w0: float, w1: float, host_ops,
                  labels) -> List[Tuple[str, float]]:
    """The device's idle time in the window, summed by what the host's
    thread was doing at each gap's middle: the innermost of the port's
    labels and the innermost host operation, or ``python`` where no
    operation ran."""
    gaps = []
    t = w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    ops = sorted(host_ops, key=lambda e: (e.time_range.start,
                                          -e.time_range.end))
    by: Dict[str, float] = {}
    stack: list = []
    i = 0
    for a, b in gaps:           # gaps are in time order
        mid = (a + b) / 2
        while i < len(ops) and ops[i].time_range.start <= mid:
            e = ops[i]
            i += 1
            while stack and stack[-1].time_range.end < e.time_range.start:
                stack.pop()
            stack.append(e)
        while stack and stack[-1].time_range.end < mid:
            stack.pop()
        # nested ranges end in order, so every range left covers mid
        label = next((e.name for e in reversed(stack) if e.name in labels),
                     "-")
        inner = next((e.name for e in reversed(stack)
                      if e.name not in labels), "python")
        key = f"{label}/{inner}"[:96]
        by[key] = by.get(key, 0.0) + (b - a) / 1e6
    return sorted(by.items(), key=lambda kv: -kv[1])[:_TOP]
