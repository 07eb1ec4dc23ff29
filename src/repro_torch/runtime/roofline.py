"""Roofline terms of a step from its op analysis (no card needed).

Port of the JAX package's ``repro/runtime/roofline.py``. For each
(arch x shape x mesh):

    compute term    = FLOPs per rank / peak FLOP/s
    memory term     = bytes per rank / HBM bytes/s
    collective term = collective bytes per rank / link bytes/s

The counts come from ``runtime/op_analysis.py`` run over one rank's
step (the reference reads them off the compiled per-device HLO): the
FLOPs and unfused operand+result bytes of every op the rank runs, and
the operand bytes of every collective it issues.

Hardware model: one NVIDIA H100 SXM5 80 GB, the published datasheet's
peaks (dense, without sparsity): 989 TFLOP/s bf16 on the tensor cores,
3.35 TB/s of HBM3, 450 GB/s of NVLink a direction (900 GB/s both
ways), 80 GB of HBM. A card set below its 700 W limit runs slower.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

PEAK_FLOPS = 989e12      # H100 SXM5 datasheet: dense bf16 FLOP/s
HBM_BW = 3.35e12         # H100 SXM5 datasheet: HBM3 bytes/s
LINK_BW = 450e9          # H100 SXM5 datasheet: NVLink bytes/s a direction
HBM_PER_CHIP = 80e9      # H100 SXM5 datasheet: 80 GB of HBM3


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_chip: float        # FLOPs of one rank's step
    hlo_bytes_per_chip: float        # its unfused operand+result bytes
    collective_bytes_per_chip: float
    collective_detail: Dict[str, Any]
    model_flops: float               # 6*N*D (active params for MoE)
    memory_per_chip: Dict[str, float]

    @property
    def compute_s(self) -> float:
        return self.hlo_flops_per_chip / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes_per_chip / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_chip / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline-model step time: max of the three terms (perfect
        overlap; the no-overlap sum is the pessimistic bound)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / total FLOPs: the remat and redundancy waste."""
        total = self.hlo_flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS * t)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops_per_chip": self.hlo_flops_per_chip,
            "hlo_bytes_per_chip": self.hlo_bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "collective_detail": self.collective_detail,
            "model_flops": self.model_flops,
            "memory_per_chip": self.memory_per_chip,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu": self.mfu,
        }


def memory_dict(argument_bytes: float, temp_bytes: float,
                output_bytes: float = 0.0, alias_bytes: float = 0.0
                ) -> Dict[str, float]:
    """One rank's memory in the reference's ``memory_analysis`` keys:
    ``argument_bytes`` its shards of the inputs, ``temp_bytes`` the peak
    of what the step allocates; ``hbm_fraction`` against the H100's
    80 GB."""
    out = {"argument_size_in_bytes": float(argument_bytes),
           "output_size_in_bytes": float(output_bytes),
           "temp_size_in_bytes": float(temp_bytes),
           "alias_size_in_bytes": float(alias_bytes)}
    out["total_bytes"] = (out["argument_size_in_bytes"]
                          + out["output_size_in_bytes"]
                          + out["temp_size_in_bytes"]
                          - out["alias_size_in_bytes"])
    out["hbm_fraction"] = out["total_bytes"] / HBM_PER_CHIP
    return out


def analyze(ops: Dict[str, Any], memory: Dict[str, float], *, arch: str,
            shape: str, mesh: str, chips: int,
            model_flops: float) -> RooflineReport:
    """The roofline report of one rank's step from its
    ``op_analysis`` counts (``OpAnalysis.analyze()``) and its memory
    (``memory_dict``)."""
    detail = {
        "bytes_by_op": ops["collective_by_op"],
        "counts": ops["collective_counts"],
        "total_bytes": ops["collective_bytes"],
        "layout_bytes_per_chip": ops["layout_bytes"],
    }
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        hlo_flops_per_chip=float(ops["flops"]),
        hlo_bytes_per_chip=float(ops["bytes"]),
        collective_bytes_per_chip=float(ops["collective_bytes"]),
        collective_detail=detail,
        model_flops=model_flops,
        memory_per_chip=memory,
    )


def model_flops_estimate(cfg, shape, kind: str) -> float:
    """6*N*D for training, 2*N*D for inference, N = active params."""
    n = cfg.active_param_count()
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
