"""Model FLOPs of a federation iteration (6 per parameter, row, peer and
local batch) over the traced iteration's time at the peak of the
configuration's dtype (float32: 67 TFLOP/s)."""
UNIT = "%"
LAYER = "model step"
SOURCE = "host_clock"
MOVES = "fed_iter_ms"
BETTER = "higher"


def read(ctx):
    from portbench.peaks import PEAK_FLOPS
    peak = PEAK_FLOPS[ctx.cfg["dtype"]]
    return 100.0 * ctx.flops_per_step() / (ctx.step_s * peak)
