"""The in-place MAR rounds kernel's share of its roofline
(``kernels/mar_rounds.py``, kernels named ``mar_rounds_inplace*``): the
least time of the traced steps' aggregation over the kernel's traced
device time. Whatever implements the schedule has to read theta and m
of every peer once and write them once, so a step's least bytes are
2 x peers x parameters x (theta's bytes + m's bytes), however many
rounds run. None where no such kernel ran (the plain route).
"""
import math

UNIT = "%"
LAYER = "trainer aggregation"
SOURCE = "device_trace"
MOVES = "train_step_ms"
BETTER = "higher"

STEM = "mar_rounds_inplace"
_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def params(cfg):
    """Parameters a peer holds: the benchmark's own leaf layout."""
    from portbench import weights
    return sum(math.prod(shape) for _, shape, *_ in weights.leaves_for(cfg))


def step_bytes(cfg, mix):
    per_param = _BYTES[cfg["dtype"]] + _BYTES[cfg["momentum_dtype"]]
    return 2 * mix["peers"] * params(cfg) * per_param


def least_seconds_per_step(cfg, mix):
    from portbench.peaks import HBM_BYTES_PER_S
    return step_bytes(cfg, mix) / HBM_BYTES_PER_S


def read(ctx):
    n, us = ctx.trace.kernel(STEM)
    if n == 0 or us <= 0:
        return None
    return 100.0 * ctx.steps * least_seconds_per_step(ctx.cfg, ctx.mix) \
        / (us / 1e6)
