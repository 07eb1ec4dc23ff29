"""Device time a step of the work launched under the port's label
``zamba2.shared_block`` (``models/zamba2.shared_block``: each
application of a shared block, its concat, attention with the flash
forward kernel, MLP with its adapter and the layer's linear, in the
forward and in remat's recompute; its backward runs outside the label),
matched by correlation id."""
UNIT = "ms/step"
LAYER = "trainer local update"
SOURCE = "device_trace"
MOVES = "train_step_ms"
BETTER = "lower"


def read(ctx):
    s = ctx.trace.span("zamba2.shared_block")
    if s is None or s.device_us <= 0:
        return None
    return s.device_us / ctx.steps / 1e3
