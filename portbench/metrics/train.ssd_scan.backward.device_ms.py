"""Device time a step of the work launched under the port's label
``ssd_scan.backward`` (``kernels/ssd_scan._SsdScanFn.backward``: the
plain VJP of the chunked scan, ``kernels/ref.ssd_scan_bwd``, once a
Mamba2 layer and peer), matched by correlation id."""
UNIT = "ms/step"
LAYER = "trainer local update"
SOURCE = "device_trace"
MOVES = "train_step_ms"
BETTER = "lower"


def read(ctx):
    s = ctx.trace.span("ssd_scan.backward")
    if s is None or s.device_us <= 0:
        return None
    return s.device_us / ctx.steps / 1e3
