"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

24L, d_model=1024, 4 heads, vocab=50304, d_ff=0 (xLSTM blocks carry their
own up/down projections). Block pattern: 1 sLSTM per 8 layers, rest mLSTM
(matrix-memory linear recurrence). O(1) decode state -> long_500k applies.
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    ssm_expand=2,
    slstm_every=8,
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG, num_layers=4, slstm_every=2, head_dim=32)
