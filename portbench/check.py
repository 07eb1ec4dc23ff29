"""The comparison that decides ``correct``.

The port's set-up drives its first steps from the seed through the
window's own step and feed, and reads from its state, before the window
takes it over: each step's loss, each leaf's norm of the first gradient
as the optimizer got it (``m_1 / (1 - mu)``: the momentum starts at 0)
and each leaf's norm of the parameters' change after the check steps.
The plain reference follows the same steps from the same seed and reads
the same. A number is the gap between the two readings:

* ``loss``    the largest relative gap of a step's loss;
* ``grad``    the worst leaf's gap of gradient norms, against the
  reference's norm of that leaf or of the median leaf, whichever is
  larger;
* ``change``  the same for the change of the parameters, over the leaves
  whose reference gradient is at least a thousandth of the median
  leaf's (a leaf with no gradient moves by round-off alone);
* ``bytes``   the largest gap of a step's ledger bytes (exact);
* ``rows``    the gap between the rows a peer holds, where the port
  derives them from the seed and the reference again (exact).

Every norm is summed in float64.
"""
from __future__ import annotations

import math
import statistics
from typing import Any, Dict, List, Optional

import torch

from portbench import weights

CHUNK = 1 << 24
#: a leaf counts for ``change`` when its reference gradient norm is at
#: least this share of the median leaf's
MOVING = 1e-3


def sumsq(x: torch.Tensor, y: Optional[torch.Tensor] = None) -> float:
    """Sum of squares of ``x`` (or of ``x - y``) in float64, in chunks
    that keep the temporaries small."""
    a = x.reshape(-1)
    b = None if y is None else y.reshape(-1)
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for i in range(0, a.numel(), CHUNK):
        c = a[i:i + CHUNK].double()
        if b is not None:
            c = c - b[i:i + CHUNK].double()
        total += c.square().sum()
    return float(total)


def grad_norms(momentum: Dict[str, torch.Tensor],
               mu: float) -> Dict[str, float]:
    """Each leaf's norm of the first gradient, from the momentum after
    one step (peers stacked on the leading axis)."""
    return {k: math.sqrt(sumsq(m)) / (1.0 - mu) for k, m in momentum.items()}


def change_norms(params: Dict[str, torch.Tensor], cfg: Dict[str, Any],
                 seed: int) -> Dict[str, float]:
    """Each leaf's norm of ``params - theta0`` over all peers, the initial
    weights drawn again leaf by leaf."""
    leaves, dt = weights.leaves_for(cfg), weights.dtype_of(cfg)
    out = {}
    for i, (path, *_) in enumerate(leaves):
        x = params[path]
        theta0 = weights.draw_leaf(leaves, i, seed, dt, x.device)
        out[path] = math.sqrt(sum(sumsq(x[p], theta0)
                                  for p in range(x.shape[0])))
        del theta0
    return out


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
                keep: Optional[List[str]] = None) -> float:
    paths = list(ref) if keep is None else keep
    if not paths:
        return math.inf
    med = statistics.median(ref[k] for k in paths)
    worst = 0.0
    for k in paths:
        p = prog.get(k, math.nan)
        if not math.isfinite(p):
            return math.inf
        worst = max(worst, abs(p - ref[k]) / max(ref[k], med, 1e-30))
    return worst


def compare(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """Each number of the cell, from the two sides' readings."""
    out: Dict[str, float] = {}
    if ref.get("loss") is not None:
        gaps = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf
                for p, r in zip(prog["loss"], ref["loss"])]
        out["loss"] = max(gaps)
    out["grad"] = _worst_leaf(prog["grad"], ref["grad"])
    med = statistics.median(ref["grad"].values())
    keep = [k for k, g in ref["grad"].items() if g >= MOVING * med]
    out["change"] = _worst_leaf(prog["change"], ref["change"], keep)
    if ref.get("n_rows") is not None:
        out["rows"] = abs(prog["n_rows"] - ref["n_rows"])
    if ref.get("bytes") is not None:
        out["bytes"] = max(abs(p - r) for p, r in zip(prog["bytes"],
                                                      ref["bytes"]))
    return out


def judge(numbers: Dict[str, float],
          limits: Dict[str, float]) -> List[Dict[str, Any]]:
    """``[{"name", "value", "limit"}]`` for every limited number; a
    number the cell limits but the run did not read is infinite."""
    return [{"name": k, "value": numbers.get(k, math.inf), "limit": lim}
            for k, lim in limits.items()]


def passed(checks: List[Dict[str, Any]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks)
