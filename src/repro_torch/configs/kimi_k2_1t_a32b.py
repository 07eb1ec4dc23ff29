"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8
[arXiv:2501.kimi2 paper table].

Per the assignment table: 61L, d_model=7168, 64H (GQA kv=8), per-expert
d_ff=2048, vocab=163840, 384 experts top-8. One shared expert (Kimi-K2 /
DeepSeek-V3 lineage). head_dim=128 (MXU-aligned; q-dim 8192 != d_model is
standard for this lineage).
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    num_shared_experts=1,
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
