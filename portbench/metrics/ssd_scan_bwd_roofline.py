"""The SSD scan's backward kernel's share of its roofline
(``kernels/ssd_scan.py``, kernels named ``ssd_bwd_*``), by kernel name
in the device trace: the least time of its calls over their traced
device time. A call is one launch of ``ssd_bwd_chunk`` and whatever else
the stem ``ssd_bwd_`` names; every call of a cell has the shape of one
micro-batch of one Mamba2 layer, once a layer and peer a step. A program
without the kernel has nothing to read.
"""
UNIT = "%"
LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "train_step_ms"
BETTER = "higher"

STEM = "ssd_bwd_"
CALL = "ssd_bwd_chunk"


def call_cost(cfg, mix):
    """(FLOPs, bytes) of one backward call at the cell's micro-batch, at
    the chunk of ``ssd_scan_fwd_roofline`` (256, halved until it divides
    S): per chunk the c^2 products q k^T, dy v^T and the gated ones for
    dq, dk and dv (3 c^2 dk + 2 c^2 dv multiply-adds) and the c dk dv
    ones against the states (5), two flops each; B and C [b, S, dk] read
    once, v and dy read, dq and dk written per head, dv written, log_a
    read and dlog_a written in f32, h0 read in f32 (no dh0: the cell's h0
    takes no gradient). The kernel's own chunks are 64 steps: there the
    same products are 2.5 times fewer (26.8 GFLOP at the cell against
    67.1), and the bytes bound the call (64.1 us against 67.9), so this
    share reads ~6% above the kernel's share of its own bound."""
    b, s = mix["batch"], mix["seq"]
    nh, dk, dv = (cfg["n_mamba_heads"], cfg["mamba_d_state"],
                  cfg["mamba_headdim"])
    elt = {"bfloat16": 2, "float16": 2, "float32": 4}[cfg["dtype"]]
    c = min(256, s)
    while s % c:
        c //= 2
    flops = b * nh * (s // c) * 2 * (3 * c * c * dk + 2 * c * c * dv
                                     + 5 * c * dk * dv)
    nbytes = (elt * (2 * b * s * dk + 2 * b * nh * s * dv
                     + 2 * b * nh * s * dk + b * nh * s * dv)
              + 4 * (2 * b * nh * s + b * nh * dk * dv))
    return flops, nbytes


def least_seconds(cfg, mix):
    from portbench.peaks import least_seconds as least
    flops, nbytes = call_cost(cfg, mix)
    return least(flops, nbytes, cfg["dtype"])


def read(ctx):
    calls, _ = ctx.trace.kernel(CALL)
    _, us = ctx.trace.kernel(STEM)
    if calls == 0 or us <= 0:
        return None
    return 100.0 * calls * least_seconds(ctx.cfg, ctx.mix) / (us / 1e6)
