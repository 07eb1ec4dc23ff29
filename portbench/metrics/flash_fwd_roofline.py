"""The flash attention forward kernel's share of its roofline
(``kernels/flash_attention.py``, kernels named ``flash_fwd_*``), by
kernel name in the device trace: the least time of its calls over their
traced device time. Every call of a cell has the shape of one
micro-batch: the forward and remat's recompute of every layer and peer.
"""
UNIT = "%"
LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "train_step_ms"
BETTER = "higher"

STEM = "flash_fwd"


def call_cost(cfg, mix):
    """(FLOPs, bytes) of one causal call at the cell's micro-batch: the
    score and value products over the s(s+1)/2 causal pairs; q, k, v read
    once, o and the f32 log-sum-exp written once."""
    b, s = mix["batch"], mix["seq"]
    h, kvh, d = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    elt = {"bfloat16": 2, "float16": 2, "float32": 4}[cfg["dtype"]]
    flops = 4 * b * h * d * s * (s + 1) / 2
    nbytes = elt * (2 * b * s * h * d + 2 * b * s * kvh * d) + 4 * b * h * s
    return flops, nbytes


def least_seconds(cfg, mix):
    from portbench.peaks import least_seconds as least
    flops, nbytes = call_cost(cfg, mix)
    return least(flops, nbytes, cfg["dtype"])


def read(ctx):
    n, us = ctx.trace.kernel(STEM)
    if n == 0 or us <= 0:
        return None
    return 100.0 * n * least_seconds(ctx.cfg, ctx.mix) / (us / 1e6)
