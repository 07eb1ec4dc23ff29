"""Device time a step of the work launched under ``train.aggregate``
(``core/mar_allreduce.mar_aggregate_device``: the MAR rounds over the
stacked theta and m)."""
UNIT = "ms/step"
LAYER = "trainer aggregation"
SOURCE = "device_trace"
MOVES = "train_step_ms"
BETTER = "lower"


def read(ctx):
    s = ctx.trace.span("train.aggregate")
    if s is None or s.device_us <= 0:
        return None
    return s.device_us / ctx.steps / 1e3
