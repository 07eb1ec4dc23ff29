"""The SSD-scan forward kernel's share of its roofline
(``kernels/ssd_scan.py``, kernels named ``ssd_scan_*_kernel``), by
kernel name in the device trace: the least time of its calls over their
traced device time. Every call of a cell has the shape of one
micro-batch of one Mamba2 layer: the forward and remat's recompute of
every layer and peer.
"""
UNIT = "%"
LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "train_step_ms"
BETTER = "higher"

STEM = "ssd_scan_"


def call_cost(cfg, mix):
    """(FLOPs, bytes) of one call at the cell's micro-batch: q = C and
    k = B [b, S, dk] of the one group, broadcast over the heads and
    counted once, v = dt x [b, heads, S, dv] and log_a f32 read once,
    h0 read and h_final written in f32, y written once; the operations of the
    chunked scan (chunks of 256, halved until they divide S): per chunk
    q k^T, the gated product with v, q . H and the state update, two
    per multiply-add."""
    b, s = mix["batch"], mix["seq"]
    nh, dk, dv = (cfg["n_mamba_heads"], cfg["mamba_d_state"],
                  cfg["mamba_headdim"])
    elt = {"bfloat16": 2, "float16": 2, "float32": 4}[cfg["dtype"]]
    c = min(256, s)
    while s % c:
        c //= 2
    flops = b * nh * (s // c) * 2 * (c * c * dk + c * c * dv
                                     + 2 * c * dk * dv)
    nbytes = (elt * (2 * b * s * dk + 2 * b * nh * s * dv)
              + 4 * b * nh * s + 2 * 4 * b * nh * dk * dv)
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
