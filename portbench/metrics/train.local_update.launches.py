"""Kernel launches a step issued under ``train.local_update``: the
host-bound lever (CUDA graphs, ``torch._foreach`` updates) cuts it."""
UNIT = "launches/step"
LAYER = "trainer local update"
SOURCE = "device_trace"
MOVES = "train_step_ms"
BETTER = "lower"


def read(ctx):
    s = ctx.trace.span("train.local_update")
    if s is None or s.launches <= 0:
        return None
    return s.launches / ctx.steps
