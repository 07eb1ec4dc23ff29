"""Entry ``fl_train_zamba2``: the MAR-FL training step of the LM trainer
on the published Zamba2 (``repro_torch.models.zamba2``), driven as
``fl_train`` drives the decoder-only LM: one state built by
``init_fl_state`` from the benchmark's weights, one step function over
the MAR grid, each step fed a fresh token batch and synchronized. The
window, its measure and the step are ``fl_train``'s own; this entry
brings the model, its leaves (``reference/zamba2.leaves``), their change
norms, the reference and the step's FLOPs.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict

from portbench import check, device as dev, faults, gen, spec, weights
from portbench.reference import zamba2 as ref

_BASE = spec._load_module(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "fl_train.py"), "entries_fl_train")

LABELS = _BASE.LABELS + ("ssd_scan.backward", "zamba2.shared_block")


def port_config(cfg: Dict[str, Any]):
    """The port's ``Zamba2Config`` with the configuration file's sizes."""
    from repro_torch.models.zamba2 import Zamba2Config
    return Zamba2Config(
        name=cfg["name"], family=cfg["family"],
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        head_dim=cfg["head_dim"], ssm_state=cfg["mamba_d_state"],
        ssm_conv_width=cfg["mamba_d_conv"], ssm_expand=cfg["mamba_expand"],
        rope_theta=cfg["rope_theta"], norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"], dtype=cfg["dtype"],
        attn_impl=cfg["attn_impl"], remat=cfg["remat"],
        layers_block_type=tuple(cfg["layers_block_type"]),
        num_mem_blocks=cfg["num_mem_blocks"],
        adapter_rank=cfg["adapter_rank"],
        attention_hidden_size=cfg["attention_hidden_size"],
        attention_head_dim=cfg["attention_head_dim"],
        mamba_heads=cfg["n_mamba_heads"],
        mamba_head_dim=cfg["mamba_headdim"],
        mamba_ngroups=cfg["mamba_ngroups"],
        mamba_conv_bias=cfg["use_conv_bias"],
        use_mem_rope=cfg["use_mem_rope"],
        use_shared_attention_adapter=cfg["use_shared_attention_adapter"],
        time_step_min=cfg["time_step_min"],
        pad_token_id=cfg["pad_token_id"])


class Program(_BASE.Program):
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
        params = weights.nest(ref.draw(self.cfg, self.seed, self.device))
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
        """``fl_train``'s readings, the change norms over this layout."""
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
        self.readings["change"] = ref.change_norms(
            weights.flatten(self.state["params"]), self.cfg, self.seed)
        dev.sync(self.device)

    def traced(self):
        n = self.cell["trace_steps"]

        def steps():
            for _ in range(n):
                self._step()
        return dev.traced(self.device, steps, LABELS), n

    def reference(self, precision: str = "float32") -> Dict[str, Any]:
        return ref.readings(self.cfg, self.mix, self.seed, self.device,
                            self.cell["check_steps"], precision)


def flops_per_step(cfg: Dict[str, Any], mix: Dict[str, Any]) -> float:
    """Model FLOPs of one FL step, remat's recompute not counted: 6 per
    matmul parameter and token (forward and backward), each shared-block
    application counted with its own adapter and linear, plus the shared
    attention's causal score and value products, 4 h d s(s+1)/2 an
    application and sequence forward, three times that with the
    backward. The scan's and the conv's operations are left out."""
    d = cfg["hidden_size"]
    nh, hd = cfg["n_mamba_heads"], cfg["mamba_headdim"]
    inner = nh * hd
    cdim = inner + 2 * cfg["mamba_d_state"]
    a, ff, r = (cfg["attention_hidden_size"], cfg["intermediate_size"],
                cfg["adapter_rank"])
    apps = cfg["layers_block_type"].count("hybrid")
    heads, ahd = cfg["num_attention_heads"], cfg["head_dim"]
    kv = cfg["num_key_value_heads"] * ahd
    mamba = d * (inner + cdim + nh) + inner * d
    block = (a * heads * ahd + 2 * a * kv + heads * ahd * d + 3 * d * ff
             + r * (d + 2 * ff) + d * d)
    matmul_params = (cfg["num_hidden_layers"] * mamba + apps * block
                     + d * cfg["vocab_size"])
    seqs = (mix["peers"] * mix["local_steps"] * mix["micro_batches"]
            * mix["batch"])
    s = mix["seq"]
    attention = 3 * apps * 4 * heads * ahd * s * (s + 1) / 2 * seqs
    return 6.0 * matmul_params * seqs * s + attention
