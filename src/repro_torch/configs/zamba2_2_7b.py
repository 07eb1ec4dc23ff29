"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf].

The JAX package's simplified hybrid, kept equal to it field for field:
54L, d_model=2560, one shared attn block (32H MHA of 80, d_ff=10240)
over the residual stream, applied as a layer of its own every 6 layers
with SHARED weights; the remaining layers are Mamba2 (ssd_state=64)
without conv bias or gated norm. Hybrid family -> long_500k applies; the
shared attention block uses a sliding-window KV cache for long decode.

The published Zamba2-2.7B (two shared blocks in turn on the concatenated
embedding, head dim 160, LoRA adapters, a linear per hybrid layer) is
``repro_torch.models.zamba2.Zamba2Config``, ``models/zamba2.py``.
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    attn_every=6,
    shared_attn_window=4096,
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG, num_heads=4, num_kv_heads=4, head_dim=32)
