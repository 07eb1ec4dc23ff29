"""The MAR group-mean round kernel's share of its roofline
(``kernels/group_mean.py``, kernels named ``group_mean_*``): the least
time of the traced iterations' rounds over the kernel's traced device
time. A round reads theta and m of every peer once and writes them once
(f32), and reads the peer mask.
"""
UNIT = "%"
LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "fed_iter_ms"
BETTER = "higher"

STEM = "group_mean"


def round_bytes(cfg, mix):
    params = (cfg["feature_dim"] * cfg["hidden"] + cfg["hidden"]
              + cfg["hidden"] * cfg["num_classes"] + cfg["num_classes"])
    return 2 * 2 * mix["peers"] * params * 4 + 4 * mix["peers"]


def least_seconds_per_round(cfg, mix):
    from portbench.peaks import HBM_BYTES_PER_S
    return round_bytes(cfg, mix) / HBM_BYTES_PER_S


def read(ctx):
    n, us = ctx.trace.kernel(STEM)
    if n == 0 or us <= 0:
        return None
    rounds = ctx.steps * len(ctx.mix["grid"])
    return 100.0 * rounds * least_seconds_per_round(ctx.cfg, ctx.mix) \
        / (us / 1e6)
