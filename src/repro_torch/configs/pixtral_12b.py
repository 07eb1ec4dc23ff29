"""pixtral-12b [vlm] — pixtral-ViT frontend (STUB) + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409].

The modality frontend is a stub per the brief: ``input_specs()`` feeds
precomputed patch embeddings alongside token embeddings; the backbone is
the mistral-nemo decoder (head_dim=128 with d_model=5120, as published).
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    frontend="vision_patches",
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
