"""Share of the traced window of federation iterations in which no
kernel, copy or set ran on the device."""
UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "fed_iter_ms"
BETTER = "lower"


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_us / ctx.trace.window_us)
