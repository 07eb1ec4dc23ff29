"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].

48L, d_model=1536, 24H MHA, d_ff=6144, vocab=2048 (EnCodec codebook). The
EnCodec frontend is a STUB per the brief: ``input_specs()`` provides
precomputed frame embeddings; the codebook-interleave pattern is collapsed
to a single token stream (backbone-only scope, see DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    frontend="audio_frames",
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
