"""Config system: model architecture + run shapes.

Every assigned architecture gets one module in ``repro_torch.configs``
exporting ``CONFIG`` (the exact published config) and ``smoke_config()``
(a reduced same-family config for CPU smoke tests). ``registry.py``
exposes them by id. The package is a verbatim copy of the JAX package's
``repro/configs`` with its imports rewritten (pure dataclasses).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (family-generic superset)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_capacity_factor: float = 1.25

    # --- SSM / recurrent ---
    ssm_state: int = 0          # mamba2 state dim per head
    ssm_conv_width: int = 4     # depthwise causal conv width
    ssm_expand: int = 2         # inner expansion factor
    slstm_every: int = 0        # xlstm: 1 sLSTM block per this many layers

    # --- hybrid (zamba2-style) ---
    attn_every: int = 0         # shared attention block period (0 = none)
    shared_attn_window: int = 4096  # sliding window for the shared attn cache

    # --- modality frontend stubs ---
    frontend: str = "none"      # none | vision_patches | audio_frames

    # --- common ---
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # attention implementation: "flash" (custom-vjp blockwise, default)
    # | "xla" (naive chunked; §Perf baseline) | "pallas" (TPU kernel)
    attn_impl: str = "flash"
    # activation rematerialization: "block" (checkpoint each layer,
    # default) | "none" (save everything: more memory, ~25% fewer FLOPs)
    remat: str = "block"
    # attention q/kv chunking for memory-bounded prefill
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 2048

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, self.name

    # ------------------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_recurrent(self) -> bool:
        """True when decode state is O(1) in sequence length (no KV cache)."""
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM and hybrid families only."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, L = self.d_model, self.num_layers
        hd = self.head_dim
        n_embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = n_embed
        for kind in self.block_pattern():
            if kind == "attn" or kind == "shared_attn":
                qkv = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd)
                o = (self.num_heads * hd) * d
                total += qkv + o + d  # + norm
                if kind == "attn":
                    total += self._ffn_params() + d
            elif kind == "moe":
                qkv = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd)
                o = (self.num_heads * hd) * d
                total += qkv + o + d
                total += self._moe_params() + d
            elif kind == "mamba":
                total += self._mamba_params() + d
            elif kind == "mlstm":
                total += self._mlstm_params() + d
            elif kind == "slstm":
                total += self._slstm_params() + d
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (differs from total for MoE)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        dense = self.param_count()
        all_expert = self.num_layers * self.num_experts * 3 * d * self.d_ff
        active_expert = self.num_layers * (
            (self.experts_per_token + self.num_shared_experts) * 3 * d * self.d_ff
        )
        return dense - all_expert + active_expert

    def _ffn_params(self) -> int:
        return 3 * self.d_model * self.d_ff  # SwiGLU: gate, up, down

    def _moe_params(self) -> int:
        d = self.d_model
        e = self.num_experts + self.num_shared_experts
        return self.num_experts * d + e * 3 * d * self.d_ff

    def _mamba_params(self) -> int:
        d = self.d_model
        inner = self.ssm_expand * d
        nheads = max(1, inner // 64)
        # in_proj -> (z, x, B, C, dt), conv, A/D, out_proj
        return (
            d * (2 * inner + 2 * self.ssm_state + nheads)
            + self.ssm_conv_width * (inner + 2 * self.ssm_state)
            + 2 * nheads
            + inner * d
        )

    def _mlstm_params(self) -> int:
        d = self.d_model
        inner = self.ssm_expand * d
        # up_proj(2x for gate), qkv projections on inner, i/f gates, out_proj
        return d * 2 * inner + 3 * inner * inner + 2 * inner * 2 + inner * d

    def _slstm_params(self) -> int:
        d = self.d_model
        return 4 * 2 * d * d + 4 * d + d * d  # 4 gates x (Wx, Rh) + bias + out

    def block_pattern(self) -> Tuple[str, ...]:
        """Per-layer block kinds, length == num_layers."""
        kinds = []
        for i in range(self.num_layers):
            if self.family == "moe":
                kinds.append("moe")
            elif self.family == "ssm":
                if self.slstm_every and (i + 1) % self.slstm_every == 0:
                    kinds.append("slstm")
                else:
                    kinds.append("mlstm")
            elif self.family == "hybrid":
                if self.attn_every and (i + 1) % self.attn_every == 0:
                    kinds.append("shared_attn")
                else:
                    kinds.append("mamba")
            else:  # dense / vlm / audio -> plain attention blocks
                kinds.append("attn")
        return tuple(kinds)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: (kind, seq_len, global_batch)."""

    name: str
    kind: str  # train | prefill | decode | long_decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "long_decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic attention (see DESIGN.md §4)."""
    if shape.kind == "long_decode":
        return cfg.supports_long_context
    return True


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Family-preserving reduced config for CPU smoke tests."""
    base = dict(
        num_layers=min(cfg.num_layers, 4 if cfg.family != "hybrid" else 6),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
    )
    if cfg.is_moe:
        base.update(num_experts=8, experts_per_token=2, d_ff=64,
                    num_shared_experts=min(cfg.num_shared_experts, 1))
    if cfg.family == "ssm":
        base.update(ssm_state=16, slstm_every=cfg.slstm_every and 2)
    if cfg.family == "hybrid":
        base.update(ssm_state=16, attn_every=3, shared_attn_window=64)
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)
