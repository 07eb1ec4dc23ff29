"""Model FLOPs of a training step (6 per matmul parameter and token, plus
causal attention; remat's recompute not counted: the entry's
``flops_per_step``) over the traced step's time at the peak of the
configuration's dtype."""
UNIT = "%"
LAYER = "model step"
SOURCE = "host_clock"
MOVES = "train_step_ms"
BETTER = "higher"


def read(ctx):
    from portbench.peaks import PEAK_FLOPS
    peak = PEAK_FLOPS[ctx.cfg["dtype"]]
    return 100.0 * ctx.flops_per_step() / (ctx.step_s * peak)
