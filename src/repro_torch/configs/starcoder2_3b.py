"""starcoder2-3b [dense] — GQA, RoPE [arXiv:2402.19173; hf]."""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG, num_kv_heads=1)
