"""Entry ``federation``: one MAR-FL iteration of the paper's federation
(``repro_torch.core.federation.Federation.step``), its rows handed in
through ``batch_indices`` from the seed.

Set-up builds the federation (the port derives the task, the split and
each peer's rows from the seed), hands it the benchmark's theta0
(``Federation.init_state(params)``), runs the cell's check steps through
the window's own call and feed and reads them (``check.py``); the window
takes the state over from there.
"""
from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import Any, Dict, Tuple

import torch

from portbench import check, device as dev, faults, gen, weights
from portbench.reference import fedmlp

LABELS = ("federation.transport", "federation.local_update",
          "federation.mkd", "federation.aggregate")


class Program:
    def __init__(self, bench, cell: Dict[str, Any], seed: int,
                 device: torch.device, planted=()):
        self.cfg = bench.config(cell["config"])
        self.mix = bench.traffic(cell["traffic"])
        self.cell, self.seed, self.device = cell, seed, device
        self.planted = tuple(planted)
        self.readings: Dict[str, Any] = {}
        self._faults = contextlib.ExitStack()
        self._window_step = 0
        self.built = []

    def setup(self) -> Dict[str, float]:
        from repro_torch.core.federation import Federation, FederationConfig

        parts = {"cuda_init": dev.init(self.device)}
        parts["kernel_build"], self.built = dev.build_kernels(
            self.device, self.cell.get("kernels", ()))
        t = time.perf_counter()
        cfg, mix = self.cfg, self.mix
        fcfg = FederationConfig(
            n_peers=mix["peers"], technique="mar", task=cfg["task"],
            local_batches=mix["local_batches"],
            batch_size=mix["batch_size"], lr=cfg["lr"],
            momentum=cfg["momentum"],
            participation_rate=mix["participation_rate"],
            dropout_rate=mix["dropout_rate"],
            kernel_group_mean=cfg["kernel_group_mean"], alpha=cfg["alpha"],
            transport=mix["transport"], seed=self.seed)
        self.fed = Federation(fcfg, device=self.device)
        if list(self.fed.plan.dims) != list(mix["grid"]):
            raise ValueError(f"the port plans {self.fed.plan.dims} for "
                             f"{mix['peers']} peers, the traffic states "
                             f"{mix['grid']}")
        self.n_rows = self.fed.data_x.shape[1]
        params = weights.nest(weights.draw(cfg, self.seed, self.device))
        self.state = self.fed.init_state(params)
        del params
        self._faults.enter_context(faults.planted("federation",
                                                  self.planted))
        dev.sync(self.device)
        parts["weights"] = time.perf_counter() - t
        t = time.perf_counter()
        self._check_steps()
        parts["check_steps"] = time.perf_counter() - t
        return parts

    def _indices(self, stream: int, step: int) -> torch.Tensor:
        return gen.batch_indices(self.mix, self.n_rows, self.seed, stream,
                                 step, self.device)

    def _check_steps(self) -> None:
        """The first steps and their readings: the ledger's bytes of each,
        the first gradient from the momentum after step 1, the change
        after the last. The port reports no loss."""
        nbytes = []
        for k in range(self.cell["check_steps"]):
            before = self.fed.ledger.total_bytes
            self.state = self.fed.step(self.state,
                                       batch_indices=self._indices(
                                           gen.CHECK, k))
            nbytes.append(self.fed.ledger.total_bytes - before)
            if k == 0:
                self.readings["grad"] = check.grad_norms(
                    weights.flatten(self.state.momentum),
                    self.cfg["momentum"])
        self.readings.update(loss=None, bytes=nbytes,
                             n_rows=self.n_rows)
        self.readings["change"] = check.change_norms(
            weights.flatten(self.state.params), self.cfg, self.seed)
        dev.sync(self.device)

    def _step(self) -> None:
        idx = self._indices(gen.WINDOW, self._window_step)
        self._window_step += 1
        self.state = self.fed.step(self.state, batch_indices=idx)

    def measure(self, seconds: float) -> Tuple[Dict[str, float], int, int]:
        """Iterations until ``seconds`` have passed, each timed on the
        host's clock ending in a synchronize, for the tail."""
        times = []
        dev.sync(self.device)
        t0 = t = time.perf_counter()
        while True:
            self._step()
            dev.sync(self.device)
            now = time.perf_counter()
            times.append((now - t) * 1e3)
            t = now
            if now - t0 >= seconds:
                break
        elapsed, n = t - t0, len(times)
        times.sort()
        p95 = times[min(n - 1, math.ceil(0.95 * n) - 1)]
        finite = all(torch.isfinite(x).all()
                     for x in weights.flatten(self.state.params).values())
        return ({"fed_iter_ms": elapsed / n * 1e3,
                 "fed_iter_p95_ms": p95}, n, 0 if finite else n)

    def traced(self) -> Tuple[Any, int]:
        n = self.cell["trace_steps"]

        def steps():
            for _ in range(n):
                self._step()
        return dev.traced(self.device, steps, LABELS), n

    def release(self) -> None:
        self._faults.close()
        self.state = self.fed = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "float32") -> Dict[str, Any]:
        return fedmlp.readings(self.cfg, self.mix, self.seed, self.device,
                               self.cell["check_steps"], precision)


def flops_per_step(cfg: Dict[str, Any], mix: Dict[str, Any]) -> float:
    """Model FLOPs of one iteration: 6 per parameter and row, every peer
    and local batch."""
    params = (cfg["feature_dim"] * cfg["hidden"] + cfg["hidden"]
              + cfg["hidden"] * cfg["num_classes"] + cfg["num_classes"])
    return (6.0 * params * mix["peers"] * mix["local_batches"]
            * mix["batch_size"])
