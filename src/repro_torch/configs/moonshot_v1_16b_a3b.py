"""moonshot-v1-16b-a3b [moe] — kimi/moonlight 64e top-6
[hf:moonshotai/Moonlight-16B-A3B].

48L, d_model=2048, 16H MHA (kv=16), per-expert d_ff=1408, vocab=163840,
64 experts top-6, 2 shared experts (Moonlight lineage).
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG, num_kv_heads=4)
