"""Training metrics: a JSONL stream and rolling throughput summaries.

Port of the JAX package's ``repro/runtime/metrics.py``. Append-only
JSONL (one record per ``log`` call), so concurrent tails, crashes and
elastic restarts never corrupt history: a restart appends with a new
``run_id`` and :func:`read_metrics` reconciles by step.

Beside measured wall time (``wall_s``, ``step_ms``) the logger tracks
the *simulated* network time: pass ``sim_s`` (one iteration's
``Transcript.iteration_s``) and each record carries it with the
cumulative ``sim_total_s``. A tensor value is logged as
``float(v.item())``.
"""
from __future__ import annotations

import json
import os
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, window: int = 20):
        self.path = path
        self.run_id = uuid.uuid4().hex[:8]
        self._t0 = time.time()
        self._durations: deque = deque(maxlen=window)
        self._last: Optional[float] = None
        self.sim_total_s = 0.0
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, step: int, tokens: Optional[int] = None,
            sim_s: Optional[float] = None,
            **metrics: Any) -> Dict[str, Any]:
        now = time.time()
        if self._last is not None:
            self._durations.append(now - self._last)
        self._last = now
        rec: Dict[str, Any] = {
            "run_id": self.run_id, "step": int(step),
            "wall_s": round(now - self._t0, 3),
        }
        if sim_s is not None:
            self.sim_total_s += float(sim_s)
            rec["sim_s"] = round(float(sim_s), 6)
            rec["sim_total_s"] = round(self.sim_total_s, 6)
        if self._durations:
            avg = sum(self._durations) / len(self._durations)
            rec["step_ms"] = round(avg * 1e3, 1)
            if tokens:
                rec["tokens_per_s"] = round(tokens / max(avg, 1e-9), 1)
        for k, v in metrics.items():
            if hasattr(v, "item"):
                v = float(v.item())
            elif isinstance(v, (int, float)):
                v = float(v)
            rec[k] = v
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec


def read_metrics(path: str) -> List[Dict[str, Any]]:
    """Reconciled history: the newest record per step wins (restarts)."""
    by_step: Dict[int, Dict[str, Any]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rec = json.loads(line)
                by_step[rec["step"]] = rec
    return [by_step[s] for s in sorted(by_step)]
