"""The paper's Figs. 1-5 on the port: the same configs and CSV rows as
the JAX package's ``benchmarks/fig{1_perf_gap,2_mkd,3_churn,4_dp,
5_parity}.py``, run through ``repro_torch``.

    python -m repro_torch.figures [--fig 1 2 3 4 5] [--smoke | --full]
                                  [--seed S] [--device cuda|cpu]

* Fig. 1 — bytes to a target accuracy for every technique, and the
  analytic per-iteration byte table (``fig1_scaling``, ``fig1_train``);
* Fig. 2 — MAR with and without Moshpit-KD (``fig2_mkd``);
* Fig. 3 — MAR under iid, sessions, correlated and replayed-trace
  churn, plus an elastic shrink-and-grow run (``fig3_churn``);
* Fig. 4 — DP noise sweep with adaptive clipping and RDP epsilon
  (``fig4_dp``);
* Fig. 5 — MAR = FedAvg = AR = RDFL under exact aggregation
  (``fig5_parity``, ``fig5_divergence``).

Each run also prints one ``fig_timing`` row: its ms per iteration (the
median over iterations 2..end, the device synchronized after each
step), its first step's ms, and the device. The default scale is the
reference scripts' (27 peers, 30 iterations, two local batches);
``--full`` is the paper's (125 peers, 150 iterations) and ``--smoke``
8 peers and 6 iterations. Runs on CUDA unless ``--device cpu``, with
every MAR round's group mean in the hand-written kernel
(``kernel_group_mean``), as the quickstart runs it.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core import topology
from repro_torch.core.dp import epsilon_estimate
from repro_torch.core.federation import (Federation, FederationConfig,
                                         run_federation)
from repro_torch.runtime.lifecycle import build_lifecycle, save_trace
from repro_torch.tree import tree_leaves

#: every row a run printed, in order, as a dict of its fields and "row"
Rows = List[Dict[str, Any]]


def emit(_row: str, **fields) -> None:
    """Print one ``name,key=value,...`` CSV row (the reference's format)."""
    print(",".join([_row] + [f"{k}={v}" for k, v in fields.items()]),
          flush=True)


def scale(full: bool, smoke: bool = False) -> Dict[str, int]:
    """(peers, iterations, eval_every, local batches) per mode."""
    if smoke:
        return dict(peers=8, iters=6, eval_every=3, local_batches=1)
    if full:
        return dict(peers=125, iters=150, eval_every=5, local_batches=1)
    return dict(peers=27, iters=30, eval_every=5, local_batches=2)


class _Runner:
    """Runs federations on one device and prints each run's timing."""

    def __init__(self, device: Optional[str], rows: Rows):
        self.device = device
        self.rows = rows

    def row(self, _row: str, **fields) -> None:
        emit(_row, **fields)
        self.rows.append({"row": _row, **fields})

    def timing(self, fig: str, label: str, n_peers: int,
               seconds: Sequence[float], device: torch.device) -> None:
        self.row("fig_timing", fig=fig, run=label, peers=n_peers,
                 iterations=len(seconds),
                 ms_per_iteration=statistics.median(seconds[1:]) * 1e3
                 if len(seconds) > 1 else seconds[0] * 1e3,
                 first_step_ms=seconds[0] * 1e3, device=str(device))

    def federate(self, fig: str, label: str, cfg: FederationConfig,
                 s: Dict[str, int]) -> Dict[str, List[Any]]:
        secs: List[float] = []
        hist = run_federation(cfg, s["iters"], eval_every=s["eval_every"],
                              device=self.device, step_seconds=secs)
        dev = torch.device(self.device) if self.device else \
            torch.device("cuda")
        self.timing(fig, label, cfg.n_peers, secs, dev)
        return hist


def _config(**fields) -> FederationConfig:
    """A figure's config with every MAR round's group mean in the
    hand-written kernel, as the quickstart runs it (on the CPU, the
    kernel's plain version)."""
    return FederationConfig(kernel_group_mean=True, **fields)


def _reached(hist, target: float):
    c = next((c for a, c in zip(hist["accuracy"], hist["comm_bytes"])
              if a >= target), None)
    return round(c / 1e6, 1) if c else "not_reached"


def fig1(run: _Runner, s: Dict[str, int], seed: int,
         target: float = 0.30) -> None:
    """Communication to reach a target accuracy, every technique."""
    for row in topology.complexity_table(
            model_bytes=10_000_000, peer_counts=(16, 64, 125, 512, 4096)):
        run.row("fig1_scaling", **row)
    for tech in ("fedavg", "hierarchical", "mar", "gossip", "rdfl", "ar"):
        cfg = _config(
            n_peers=s["peers"], technique=tech, task="text",
            local_batches=s["local_batches"], seed=seed)
        hist = run.federate("1", tech, cfg, s)
        run.row("fig1_train", technique=tech, peers=s["peers"],
                final_acc=round(hist["accuracy"][-1], 4),
                comm_mb=round(hist["comm_bytes"][-1] / 1e6, 1),
                sim_s=round(hist["sim_s"][-1], 3),
                mb_to_target=_reached(hist, target))


def fig2(run: _Runner, s: Dict[str, int], seed: int, task: str = "text",
         target: float = 0.30) -> None:
    """MKD: communication to a target accuracy with and without KD."""
    for use_kd, kd_iters in ((False, 0), (True, 6), (True, 12)):
        cfg = _config(
            n_peers=s["peers"], technique="mar", task=task,
            batch_size=64 if task == "vision" else 16,
            local_batches=s["local_batches"],
            use_kd=use_kd, kd_iterations=kd_iters, seed=seed)
        hist = run.federate("2", f"kd{kd_iters}", cfg, s)
        run.row("fig2_mkd", task=task, use_kd=use_kd, kd_iters=kd_iters,
                final_acc=round(hist["accuracy"][-1], 4),
                comm_mb=round(hist["comm_bytes"][-1] / 1e6, 1),
                mb_to_target=_reached(hist, target))


def fig3_scenarios(s: Dict[str, int], trace_path: str
                   ) -> Dict[str, Dict[str, Any]]:
    """The churn scenarios of Fig. 3 at scale ``s``."""
    n = s["peers"]
    third = max(1, s["iters"] // 3)
    return {
        "iid": dict(churn=None, participation_rate=0.7, dropout_rate=0.2),
        "sessions": dict(churn="sessions",
                         churn_params={"mean_up": 8.0, "mean_down": 3.0}),
        "correlated": dict(churn="correlated",
                           churn_params={"n_regions": max(2, n // 4),
                                         "outage_rate": 0.1,
                                         "mean_outage": 3.0}),
        "trace": dict(churn="trace", churn_params={"path": trace_path}),
        "elastic": dict(churn=None, participation_rate=0.9,
                        dropout_rate=0.1,
                        resize_schedule=((third, max(2, n // 2)),
                                         (2 * third, n - 1))),
    }


def record_trace(s: Dict[str, int], seed: int, path: str) -> None:
    """Run the sessions model standalone and save its event stream."""
    lc = build_lifecycle("sessions", s["peers"], seed=seed,
                         churn_params={"mean_up": 8.0, "mean_down": 3.0})
    for t in range(s["iters"]):
        lc.tick(t)
    save_trace(path, lc.event_log)


def fig3(run: _Runner, s: Dict[str, int], seed: int,
         smoke: bool = False) -> None:
    """Churn-scenario robustness matrix, with an elastic resize row."""
    techniques = ("mar",) if smoke else ("mar", "fedavg")
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = os.path.join(tmp, "sessions.jsonl")
        record_trace(s, seed, trace_path)
        for tech in techniques:
            for name, kw in fig3_scenarios(s, trace_path).items():
                cfg = _config(
                    n_peers=s["peers"], technique=tech, task="text",
                    local_batches=s["local_batches"], seed=seed, **kw)
                hist = run.federate("3", f"{tech}/{name}", cfg, s)
                run.row("fig3_churn", technique=tech, scenario=name,
                        final_acc=round(hist["accuracy"][-1], 4),
                        comm_mb=round(hist["comm_bytes"][-1] / 1e6, 1),
                        disagreement=f"{hist['disagreement'][-1]:.2e}",
                        peers_end=hist["n_peers"][-1],
                        events=hist["events"][-1])


def fig4(run: _Runner, s: Dict[str, int], seed: int) -> None:
    """DP noise-multiplier sweep with adaptive clipping + RDP epsilon."""
    for sigma in (0.0, 0.1, 0.3, 1.0):
        cfg = _config(
            n_peers=s["peers"], technique="mar", task="text",
            use_dp=sigma > 0, noise_multiplier=sigma,
            local_batches=s["local_batches"], seed=seed)
        hist = run.federate("4", f"sigma{sigma}", cfg, s)
        eps = (epsilon_estimate(s["iters"], sigma)
               if sigma > 0 else float("inf"))
        run.row("fig4_dp", noise_multiplier=sigma,
                final_acc=round(hist["accuracy"][-1], 4),
                epsilon=(round(eps, 1) if eps != float("inf") else "inf"),
                comm_mb=round(hist["comm_bytes"][-1] / 1e6, 1))


def fig5(run: _Runner, s: Dict[str, int], seed: int) -> None:
    """Exact-aggregation parity: MAR = FedAvg = AR = RDFL."""
    first = {}
    for tech in ("mar", "fedavg", "ar", "rdfl"):
        cfg = _config(n_peers=s["peers"], technique=tech, task="text",
                      local_batches=s["local_batches"], seed=seed)
        fed = Federation(cfg, device=run.device)
        state = fed.init_state()
        secs = []
        for _ in range(s["iters"] // 2):
            t0 = time.perf_counter()
            state = fed.step(state)
            if fed.device.type == "cuda":
                torch.cuda.synchronize(fed.device)
            secs.append(time.perf_counter() - t0)
        run.timing("5", tech, cfg.n_peers, secs, fed.device)
        acc = fed.evaluate(state)
        first[tech] = tree_leaves(state.params)[0]
        run.row("fig5_parity", technique=tech, acc=round(acc, 4))
    base = first["fedavg"]
    for tech in ("mar", "ar", "rdfl"):
        d = float((first[tech] - base).abs().max())
        run.row("fig5_divergence", technique=tech, vs="fedavg",
                max_param_diff=f"{d:.2e}")


FIGURES: Dict[str, Callable[..., None]] = {
    "1": fig1, "2": fig2, "3": fig3, "4": fig4, "5": fig5}


def run_figures(figs: Sequence[str], s: Dict[str, int], seed: int,
                device: Optional[str], smoke: bool = False) -> Rows:
    """Run the named figures at scale ``s``; returns every printed row
    as a dict (``"row"`` holds its name)."""
    rows: Rows = []
    run = _Runner(device, rows)
    for f in figs:
        if f == "3":
            fig3(run, s, seed, smoke=smoke)
        else:
            FIGURES[f](run, s, seed)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fig", nargs="+", choices=sorted(FIGURES),
                    default=sorted(FIGURES))
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--full", action="store_true",
                      help="paper-scale settings (125 peers, 150 iterations)")
    mode.add_argument("--smoke", action="store_true",
                      help="minimal settings (8 peers, 6 iterations)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    run_figures(args.fig, scale(args.full, args.smoke), args.seed,
                args.device, smoke=args.smoke)
    return 0


if __name__ == "__main__":
    sys.exit(main())
