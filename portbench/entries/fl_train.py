"""Entry ``fl_train``: the MAR-FL training step of the LM trainer
(``repro_torch.core.fl_device.make_fl_train_step``), driven as
``launch/train.py`` drives it: one state built by ``init_fl_state`` from
the benchmark's weights, one step function over the MAR grid, each step
fed a fresh token batch and synchronized.

Set-up runs the cell's check steps through that same step and feed and
reads them (``check.py``); the window takes the state over from there.
"""
from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import Any, Dict, Tuple

import torch

from portbench import check, device as dev, faults, gen, weights
from portbench.reference import lm

LABELS = ("train.local_update", "train.aggregate")


def port_config(cfg: Dict[str, Any]):
    """The port's ``ModelConfig`` with the configuration file's sizes."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=cfg["name"], family=cfg["family"],
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["ffn_dim"],
        vocab_size=cfg["vocab_size"], head_dim=cfg["head_dim"],
        frontend=cfg.get("frontend", "none"), rope_theta=cfg["rope_theta"],
        norm_eps=cfg["norm_eps"], dtype=cfg["dtype"],
        attn_impl=cfg["attn_impl"], remat=cfg["remat"])


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

    def _batch(self, stream: int, step: int) -> Dict[str, torch.Tensor]:
        return gen.lm_batch(self.mix, self.cfg["vocab_size"], self.seed,
                            stream, step, self.device)

    def setup(self) -> Dict[str, float]:
        from repro_torch.core.fl_device import (init_fl_state,
                                                make_fl_train_step)
        from repro_torch.core.moshpit import plan_grid
        from repro_torch.models.model import Model

        parts = {"cuda_init": dev.init(self.device)}
        parts["kernel_build"], self.built = dev.build_kernels(
            self.device, self.cell.get("kernels", ()))
        t = time.perf_counter()
        model = Model(port_config(self.cfg))
        grid = plan_grid(self.mix["peers"])
        if list(grid.dims) != list(self.mix["grid"]):
            raise ValueError(f"the port plans {grid.dims} for "
                             f"{self.mix['peers']} peers, the traffic "
                             f"states {self.mix['grid']}")
        params = weights.nest(weights.draw(self.cfg, self.seed, self.device))
        self.state = init_fl_state(model, self.mix["peers"],
                                   device=self.device, params=params)
        del params
        self.step_fn = make_fl_train_step(model, grid, lr=self.cfg["lr"],
                                          mu=self.cfg["momentum"])
        self._faults.enter_context(faults.planted("fl_train", self.planted))
        dev.sync(self.device)
        parts["weights"] = time.perf_counter() - t
        t = time.perf_counter()
        self._check_steps()
        parts["check_steps"] = time.perf_counter() - t
        return parts

    def _check_steps(self) -> None:
        """The cell's first steps, through the window's step and feed,
        and their readings: every step's loss, the first gradient from
        the momentum after step 1, the change after the last."""
        losses = []
        for k in range(self.cell["check_steps"]):
            self.state, met = self.step_fn(self.state,
                                           self._batch(gen.CHECK, k))
            losses.append(float(met["loss"]))
            if k == 0:
                self.readings["grad"] = check.grad_norms(
                    weights.flatten(self.state["momentum"]),
                    self.cfg["momentum"])
        self.readings["loss"] = losses
        self.readings["change"] = check.change_norms(
            weights.flatten(self.state["params"]), self.cfg, self.seed)
        dev.sync(self.device)

    def _step(self) -> torch.Tensor:
        batch = self._batch(gen.WINDOW, self._window_step)
        self._window_step += 1
        self.state, met = self.step_fn(self.state, batch)
        return met["loss"]

    def measure(self, seconds: float) -> Tuple[Dict[str, float], int, int]:
        """Whole steps until ``seconds`` have passed, each ending in a
        synchronize; the window ends at a step boundary. The peak is the
        window's own: the harness starts it afresh (``device.start_window``)."""
        dev.sync(self.device)
        losses = []
        t0 = time.perf_counter()
        while True:
            losses.append(self._step())
            dev.sync(self.device)
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        n = len(losses)
        failed = sum(not math.isfinite(float(x)) for x in losses)
        return ({"train_step_ms": elapsed / n * 1e3,
                 "train_peak_gib": dev.peak_bytes(self.device) / 2**30},
                n, failed)

    def traced(self) -> Tuple[Any, int]:
        n = self.cell["trace_steps"]

        def steps():
            for _ in range(n):
                self._step()
        return dev.traced(self.device, steps, LABELS), n

    def release(self) -> None:
        self._faults.close()
        self.state = self.step_fn = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "float32") -> Dict[str, Any]:
        return lm.readings(self.cfg, self.mix, self.seed, self.device,
                           self.cell["check_steps"], precision)


def flops_per_step(cfg: Dict[str, Any], mix: Dict[str, Any]) -> float:
    """Model FLOPs of one FL step, remat's recompute not counted: 6 per
    matmul parameter and token (forward and backward), plus causal
    attention's score and value products, 4 h d s(s+1)/2 a layer and
    sequence forward, three times that with the backward."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    h, kvh, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    per_layer = d * h * hd * 2 + d * kvh * hd * 2 + 3 * d * cfg["ffn_dim"]
    matmul_params = L * per_layer + d * cfg["vocab_size"]
    seqs = (mix["peers"] * mix["local_steps"] * mix["micro_batches"]
            * mix["batch"])
    s = mix["seq"]
    attention = 3 * L * 4 * h * hd * s * (s + 1) / 2 * seqs
    return 6.0 * matmul_params * seqs * s + attention
