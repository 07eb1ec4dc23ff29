"""The kernels against their plain versions on the card, at the main
paths' shapes: the group mean and its round entry, the MAR rounds, the
attention kernels (flash, paged and dense decode) and the SSD scan with
its autograd Function and its backward kernel. Each phase that holds a
kernels-line kernel returns that kernel's main-path row."""
from __future__ import annotations

import math
import time

from chipsmoke.common import check, device_ms, emit
from chipsmoke.refs import (MOONSHOT_ATTN, RECURRENT, SERVE, STARCODER,
                            TRAIN_ATTN, ZAMBA2_ATTN, ZAMBA2_PUBLISHED,
                            ZAMBA2_PUBLISHED_ATTN, ZAMBA2_PUBLISHED_SCALE)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
MAIN_PATH_D = (98304, 128, 2560, 20)    # fc1.w, fc1.b, fc2.w, fc2.b


def bound_ms(nbytes: int, flops: int, bf16: bool = False) -> dict:
    """Least time for a call, the larger of two: its inputs read once and
    outputs written once over HBM (``bytes_ms``); the flops these inputs
    need over the peak rate of their type, the bf16 tensor cores or the
    f32 cores (``ops_ms``)."""
    rate = BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S
    return {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": flops / rate * 1e3}


def group_mean_bound_ms(g: int, m: int, d: int, itemsize: int) -> dict:
    """Least time for the masked group mean, the larger of two: x read
    once, mask read once and y written once over HBM (``bytes_ms``); a
    multiply-add per element read and a divide per column over the f32
    rate (``ops_ms``)."""
    return bound_ms(2 * g * m * d * itemsize + g * m * 4,
                    2 * g * m * d + g * d)


def phase_group_mean(torch, gm, ref, flush):
    """The [G, M, D] entry against its plain PyTorch version on the card,
    at the old per-leaf shapes (G=9, M=3, D in MAIN_PATH_D, f32), D=98304
    in bf16, a ragged tail (D=1000) and D=1, each with a fully dropped
    group, which must keep its rows; f32 within 2e-5, bf16 within 2e-2.
    Median times of 20 CUDA-event-timed calls, L2 flushed before each,
    beside the memory bound."""
    cases = [("path", d, torch.float32) for d in MAIN_PATH_D] + [
        ("bf16", 98304, torch.bfloat16), ("tail", 1000, torch.float32),
        ("d1", 1, torch.float32)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kind, d, dtype in cases:
        g, m = 9, 3
        x = torch.randn((g, m, d), generator=gen, device="cuda").to(dtype)
        mask = (torch.rand((g, m), generator=gen, device="cuda") < 0.7)
        mask = mask.float()
        mask[-1] = 0.0                  # a fully dropped group
        mask[0, 0] = 1.0
        y = gm.group_mean_fwd(x, mask)
        want = ref.group_mean_ref(x, mask)
        torch.cuda.synchronize()
        err = float((y.float() - want.float()).abs().max())
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        check(y.dtype == dtype and y.shape == x.shape,
              f"group_mean {kind} D={d}: bad output {y.dtype} {y.shape}")
        check(err <= tol, f"group_mean {kind} D={d} {dtype}: max abs err "
                          f"{err} > {tol}")
        check(torch.equal(y[-1], x[-1]),
              f"group_mean {kind} D={d}: dropped group changed")
        bound = group_mean_bound_ms(g, m, d, x.element_size())
        row = {"kind": kind, "G": g, "M": m, "D": d,
               "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err, "tol": tol,
               "kernel_ms": device_ms(
                   torch, lambda: gm.group_mean_fwd(x, mask), flush=flush),
               "plain_ms": device_ms(
                   torch, lambda: ref.group_mean_ref(x, mask), flush=flush),
               "bound_ms": max(bound.values()), **bound}
        row.update(shares(row["kernel_ms"], row["bound_ms"], None))
        emit("group_mean", **row)


# the quickstart's tree: theta and momentum of the MLP head 768->128->20
MLP_SHAPES = {"fc1": {"w": (768, 128), "b": (128,)},
              "fc2": {"w": (128, 20), "b": (20,)}}
# leaf widths of the >MAX_LEAVES tree: vector and scalar paths, d = 1
MIXED_D = (1, 3, 20, 128, 999, 1000, 2560, 4097)


def group_mean_round_bound_ms(leaves, cap: int, m: int) -> dict:
    """Least time for one MAR round over ``leaves`` ([n, ...] each), the
    larger of two: every leaf read once and written once, the mask [n]
    and the order [cap] read once, over HBM (``bytes_ms``); a
    multiply-add per element read and a divide per group column over
    the f32 rate (``ops_ms``). Virtual slots move nothing."""
    n = leaves[0].shape[0]
    nbytes = sum(2 * x.numel() * x.element_size() for x in leaves) \
        + n * 4 + cap * 8
    return bound_ms(nbytes, sum(2 * x.numel() + cap // m
                                * (x.numel() // max(n, 1)) for x in leaves))


def _round_tree(torch, gen, kind: str, n: int):
    """A tree of [n, ...] leaves on the card for one group_mean_round
    row: the quickstart's theta and momentum (f32 or bf16), or more than
    MAX_LEAVES leaves mixing f32 and bf16, with two offset views that
    are not 16-byte aligned."""
    from repro_torch.kernels.group_mean import MAX_LEAVES

    def draw(shape, dtype=torch.float32, offset=0):
        flat = torch.randn(n * math.prod(shape) + offset, generator=gen,
                           device="cuda").to(dtype)
        return flat[offset:].view((n,) + tuple(shape))

    if kind in ("quickstart", "virtual", "bf16"):
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        return {k: {layer: {name: draw(shape, dtype)
                            for name, shape in p.items()}
                    for layer, p in MLP_SHAPES.items()}
                for k in ("p", "m")}
    f32 = {f"f{i:02d}": draw((MIXED_D[i % len(MIXED_D)],))
           for i in range(MAX_LEAVES + 4)}
    f32["f_offset"] = draw((1000,), offset=1)
    bf16 = {f"h{i}": draw((d,), torch.bfloat16)
            for i, d in enumerate((1, 20, 2560))}
    bf16["h_offset"] = draw((2560,), torch.bfloat16, offset=3)
    return {"f32": f32, "bf16": bf16}


def _parent_route(torch, gm, x, order, inv, mask_g, n, cap, m):
    """One leaf through the route the round kernel replaced: pad, gather
    by order, the [G, M, D] entry, gather back by inv."""
    xf = x.reshape(n, -1)
    d = xf.shape[1]
    if cap > n:
        xf = torch.cat([xf, xf.new_zeros((cap - n, d))])
    out = gm.group_mean_fwd(xf[order].reshape(cap // m, m, d), mask_g)
    return out.reshape(cap, d)[inv][:n].reshape(x.shape)


def phase_group_mean_round(torch, flush):
    """The round kernel through ``_kernel_round`` (the main path's entry)
    against the round's plain version, at the quickstart's tree (N=27 on
    3x3x3, every round), N=26 on the same grid (virtual slots), the tree
    in bf16, and a tree of more than MAX_LEAVES leaves mixing f32 and
    bf16 (scalar and offset leaves too). Each mask drops one whole
    group, which must keep its rows bit for bit; f32 and bf16 must be
    bit-equal to the route the kernel replaced (gather, [G, M, D]
    entry, scatter); f32 within 2e-5 and bf16 within 2e-2 of the plain
    version; one launch per dtype batch. Times with L2 flushed: the
    kernel, that route, the plain version and the kernel-off route
    (grouped sums), beside the bound, and the host time of a round.
    Returns the kernels line's row: the quickstart's round 0, its error
    the largest over the three rounds."""
    from repro_torch.core import mar_allreduce as mar
    from repro_torch.core.moshpit import GridPlan
    from repro_torch.kernels import group_mean as gm
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import group_mean_round_ref
    from repro_torch.tree import tree_leaves

    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [("quickstart", 27, r) for r in range(3)] + \
        [("virtual", 26, r) for r in range(3)] + \
        [("bf16", 27, 0), ("mixed", 27, 1)]
    rows = []
    for kind, n, rnd in cases:
        plan = GridPlan(n, (3, 3, 3))
        cap, m = plan.capacity, plan.dims[rnd]
        state = _round_tree(torch, gen, kind, n)
        leaves = tree_leaves(state)
        ri = mar.round_index(plan, rnd, torch.device("cuda"))
        order, inv = ri.order, ri.inv
        mask = (torch.rand(n, generator=gen, device="cuda") < 0.7).float()
        # drop the whole group of the last slot (a virtual one at N=26)
        slots = order.tolist()
        g_drop = slots.index(cap - 1) // m
        drop_slots = slots[g_drop * m:(g_drop + 1) * m]
        drop = [p for p in drop_slots if p < n]
        mask[drop] = 0.0
        keep = [p for p in range(n) if p not in drop_slots]
        mask[keep[0]] = 1.0
        mask_g = torch.cat([mask, mask.new_zeros(cap - n)])[order] \
            .reshape(cap // m, m)

        ops.reset_launch_counts()
        out = tree_leaves(mar._kernel_round(state, plan, rnd, mask))
        torch.cuda.synchronize()
        launches = ops.launch_counts()["group_mean"]
        flat = [x.reshape(n, -1) for x in leaves]
        want = [None] * len(flat)
        for idx in gm.batches(flat):
            for i, y in zip(idx, group_mean_round_ref(
                    [flat[i] for i in idx], order, mask, m)):
                want[i] = y.reshape(leaves[i].shape)
        parent = [_parent_route(torch, gm, x, order, inv, mask_g, n, cap, m)
                  for x in leaves]
        torch.cuda.synchronize()
        err, tol = 0.0, 0.0
        for x, y, w, pr in zip(leaves, out, want, parent):
            t = _tol(torch, x.dtype)
            tol = max(tol, t)
            e = float((y.float() - w.float()).abs().max())
            err = max(err, e)
            check(y.dtype == x.dtype and y.shape == x.shape
                  and bool(torch.isfinite(y).all()),
                  f"group_mean_round {kind} r{rnd}: bad output {y.dtype} "
                  f"{tuple(y.shape)}")
            check(e <= t, f"group_mean_round {kind} r{rnd} {x.dtype}: max "
                          f"abs err {e} > {t}")
            check(torch.equal(y, pr), f"group_mean_round {kind} r{rnd} "
                                      f"{x.dtype}: not bit-equal to the "
                                      f"gather / [G, M, D] / scatter route")
            check(torch.equal(y[drop], x[drop]),
                  f"group_mean_round {kind} r{rnd}: dropped group changed")
        want_launches = len(gm.batches(flat))
        check(launches == want_launches,
              f"group_mean_round {kind} r{rnd}: {launches} launches, "
              f"expected {want_launches}")

        def kernel():
            return mar._kernel_round(state, plan, rnd, mask)

        def parent_route():
            return [_parent_route(torch, gm, x, order, inv, mask_g, n, cap,
                                  m) for x in leaves]

        def plain():
            return [group_mean_round_ref([flat[i] for i in idx], order,
                                         mask, m)
                    for idx in gm.batches(flat)]

        def kernel_off():
            return mar.mar_round_sim(state, plan, rnd, mask)

        host_us = {}
        for name, fn in (("kernel", kernel), ("parent_route", parent_route)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                fn()
            host_us[name] = (time.perf_counter() - t0) / 50 * 1e6
            torch.cuda.synchronize()
        spin = 20_000_000        # ~12 ms: the multi-launch routes' host
        bound = group_mean_round_bound_ms(leaves, cap, m)
        row = {"kind": kind, "n": n, "grid": list(plan.dims), "round": rnd,
               "leaves": len(leaves), "launches": launches,
               "dtypes": sorted({str(x.dtype).replace("torch.", "")
                                 for x in leaves}),
               "dropped_peers": drop, "max_abs_err": err, "tol": tol,
               "bit_equal_to_parent_route": True,
               "kernel_ms": device_ms(torch, kernel, flush=flush),
               "parent_route_ms": device_ms(torch, parent_route,
                                            flush=flush, spin=spin),
               "plain_ms": device_ms(torch, plain, flush=flush, spin=spin),
               "kernel_off_ms": device_ms(torch, kernel_off, flush=flush,
                                          spin=spin),
               "library_ms": None,
               "host_us_per_round": host_us["kernel"],
               "parent_route_host_us_per_round": host_us["parent_route"],
               "bound_ms": max(bound.values()), **bound}
        row.update(shares(row["kernel_ms"], row["bound_ms"], None))
        rows.append(row)
        emit("group_mean_round", **row)
    # the main path's row: the quickstart's round 0, its error the largest
    # over the quickstart's three rounds
    qs = [r for r in rows if r["kind"] == "quickstart"]
    return {**qs[0], "max_abs_err": max(r["max_abs_err"] for r in qs),
            "row": "group_mean_round quickstart round 0"}


def mar_rounds_bound_ms(leaves, rounds: int) -> dict:
    """Least time for the device MAR aggregation of ``leaves`` ([P, ...]
    each), the larger of two: every leaf read once and written once
    however many rounds run, and the mask once, over HBM
    (``bytes_ms``); a multiply-add and a divide per element and round
    over the f32 rate (``ops_ms``)."""
    nbytes = sum(2 * x.numel() * x.element_size() for x in leaves) \
        + leaves[0].shape[0] * 4
    return bound_ms(nbytes, 3 * rounds * sum(x.numel() for x in leaves))


def phase_mar_rounds(torch, flush):
    """The device MAR aggregation of the train phase's state through the
    in-place rounds kernel: theta (bf16) and m (f32) of 4 peers of
    musicgen-medium at full width (43.6 GB), random on the card, on the
    (2, 2) grid. Leaf by leaf, ``mar_rounds_`` (both rounds, one launch)
    against its plain version (``ref.mar_rounds_ref``, column block by
    column block) under a full mask and one that empties a group:
    bit-equal (groups of two). Then the whole state through
    ``mar_aggregate_device`` with the kernel and with the plain route
    (``_takes_kernel`` off), L2 flushed, beside the bound: one launch a
    leaf, and the kernel allocates nothing. Returns the row."""
    import gc
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.core import mar_allreduce as mar
    from repro_torch.core.fl_device import fl_state_shape
    from repro_torch.core.moshpit import plan_grid
    from repro_torch.kernels import mar_rounds
    from repro_torch.kernels.ref import mar_rounds_ref
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves

    n, plan = 4, plan_grid(4)
    dims, axes = plan.dims, tuple(range(plan.depth))
    check(dims == (2, 2), f"mar_rounds: grid {dims}")
    shape = fl_state_shape(Model(get_config("musicgen-medium")), n)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = {k: tuple(torch.randn(x.shape, generator=gen, device="cuda")
                      .to(x.dtype) for x in tree_leaves(shape[k]))
             for k in ("params", "momentum")}
    leaves = tree_leaves(state)
    empty = torch.ones(n, device="cuda")
    first = mar_rounds.groups(dims, (0,))[0][0]
    for q in range(n):
        if first >> q & 1:
            empty[q] = 0.0
    err, unequal = 0.0, []
    for name, mask in (("full", torch.ones(n, device="cuda")),
                       ("empty_group", empty)):
        for i, x in enumerate(leaves):
            x2 = x.view(n, -1)
            got = x2.clone()
            mar_rounds.launches = 0
            mar_rounds.mar_rounds_(got, dims, axes, mask)
            check(mar_rounds.launches == 1,
                  f"mar_rounds {name} leaf {i}: {mar_rounds.launches} "
                  f"launches")
            for c0 in range(0, x2.shape[1], 1 << 24):
                want = mar_rounds_ref(x2[:, c0:c0 + (1 << 24)], dims, axes,
                                      mask)
                blk = got[:, c0:c0 + (1 << 24)]
                err = max(err, float((blk.float() - want.float())
                                     .abs().max()))
                if not torch.equal(blk, want):
                    unequal.append(f"{name} leaf {i} {x.dtype} "
                                   f"{tuple(x.shape)} column {c0}")
                del want
            del got
    plain = mock.patch.object(mar, "_takes_kernel", lambda *a: False)

    def kernel_route():
        mar.mar_aggregate_device(state, plan)

    def plain_route():
        with plain:
            mar.mar_aggregate_device(state, plan)

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    mar_rounds.launches = 0
    kernel_route()
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - before
    launches = mar_rounds.launches
    # a spin of ~10 ms: the plain route queues thousands of launches
    kernel_ms = device_ms(torch, kernel_route, reps=10, warmup=1,
                          flush=flush, spin=20_000_000)
    plain_ms = device_ms(torch, plain_route, reps=3, warmup=1,
                         flush=flush, spin=20_000_000)
    bound = mar_rounds_bound_ms(leaves, len(axes))
    row = {"kind": "musicgen-medium theta and m, 4 peers on (2, 2)",
           "leaves": len(leaves),
           "params_per_peer": sum(x[0].numel() for x in state["params"]),
           "state_bytes": sum(x.numel() * x.element_size()
                              for x in leaves),
           "max_abs_err": err, "not_bit_equal": unequal[:8],
           "launches_a_call": launches, "allocated_by_call": allocated,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": None, "bound_ms": max(bound.values()), **bound}
    row.update(shares(kernel_ms, row["bound_ms"], None))
    emit("mar_rounds", **row)
    check(not unequal, f"mar_rounds: not bit-equal to the plain version "
                       f"(max abs err {err}): {unequal[:8]}")
    check(launches == len(leaves),
          f"mar_rounds: {launches} launches for {len(leaves)} leaves")
    check(allocated == 0, f"mar_rounds: the call allocated {allocated} B")
    del state, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def shares(kernel_ms, bound_ms, library_ms) -> dict:
    """``bound_share``: the bound over the kernel's time (1 at the
    bound); ``vs_library``: the kernel's time over the library call's
    (null where there is none, or the kernel was not timed)."""
    return {"bound_share": bound_ms / kernel_ms if kernel_ms else None,
            "vs_library": (kernel_ms / library_ms
                           if kernel_ms and library_ms else None)}


def _row(kind, dtype, err, tol, kernel_ms, plain_ms, library_ms, bound,
         **shape):
    bound_ms = max(bound.values())
    return {"kind": kind, **shape,
            "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
            "tol": tol, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, **bound,
            **shares(kernel_ms, bound_ms, library_ms)}


def _tol(torch, dtype) -> float:
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


def phase_flash(torch, flush):
    """The flash kernel against ``flash_attention_ref`` (o and lse) at the
    serving path's shape (starcoder2-3b, s=512) in bf16 and f32, ragged
    (s=24 and 1000) in both, and in bf16 one past a 64-row tile (s=65 and
    129), zamba2's shared attention (h=kvh=32, d=80) at s=512 and 200,
    and moonshot's (h=kvh=16, d=128: g=1) in both types. f32 within
    2e-5, bf16 within 2e-2: the kernel sums in another order than the
    plain version and rounds the probabilities to bf16 before P V.
    Median device times of the kernel, the plain version and SDPA (with
    ``is_causal`` and ``enable_gqa``, the library yardstick) beside the
    bound, L2 flushed before each; every row gives bound_share (bound /
    kernel time) and vs_library (kernel / library time). Then the rows
    at the trainers' shapes (``_flash_train_row``: 2t, 2h and 2p, with
    the plain backward beside SDPA's, not gated). Returns the first
    (bf16, serving-path) row."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref

    sc, za = STARCODER, ZAMBA2_ATTN
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for kind, s, dtype, heads in [
            ("path", SERVE["pad_len"], torch.bfloat16, sc),
            ("path", SERVE["pad_len"], torch.float32, sc),
            ("ragged", 24, torch.bfloat16, sc),
            ("ragged", 24, torch.float32, sc),
            ("ragged", 1000, torch.bfloat16, sc),
            ("ragged", 1000, torch.float32, sc),
            ("zamba2", RECURRENT["pad_len"], torch.bfloat16, za),
            ("tile_edge", 65, torch.bfloat16, sc),
            ("tile_edge", 129, torch.bfloat16, sc),
            ("zamba2_ragged", 200, torch.bfloat16, za),
            ("moonshot", SERVE["pad_len"], torch.bfloat16, MOONSHOT_ATTN),
            ("moonshot", SERVE["pad_len"], torch.float32, MOONSHOT_ATTN)]:
        h, kvh, d = heads["h"], heads["kvh"], heads["d"]
        q = torch.randn((1, s, h, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((1, s, kvh, d), generator=gen,
                        device="cuda").to(dtype)
        v = torch.randn((1, s, kvh, d), generator=gen,
                        device="cuda").to(dtype)
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        o_ref, lse_ref = flash_attention_ref(q, k, v, True)
        torch.cuda.synchronize()
        tol = _tol(torch, dtype)
        err = float((o.float() - o_ref.float()).abs().max())
        lse_err = float((lse - lse_ref).abs().max())
        check(o.dtype == dtype and o.shape == q.shape
              and lse.shape == (1, h, s), f"flash s={s}: bad outputs")
        check(err <= tol and lse_err <= tol,
              f"flash s={s} {dtype}: o err {err}, lse err {lse_err} > {tol}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        pairs = s * (s + 1) // 2                   # causal (i, j), j <= i
        bound = bound_ms(_nbytes(q, k, v, o, lse),
                                   4 * h * d * pairs,
                                   dtype == torch.bfloat16)
        row = _row(kind, dtype, err, tol,
                   device_ms(torch, lambda: fa.flash_attention_fwd(
                       q, k, v, True), flush=flush),
                   device_ms(torch, lambda: flash_attention_ref(
                       q, k, v, True), flush=flush),
                   device_ms(torch, lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True),
                       flush=flush),
                   bound, b=1, s=s, h=h, kvh=kvh, d=d)
        row["lse_max_abs_err"] = lse_err
        rows.append(row)
        emit("flash_attention", **row)
    _flash_train_row(torch, flush, gen, "2t", TRAIN_ATTN)
    _flash_train_row(torch, flush, gen, "2h", ZAMBA2_ATTN)
    _flash_train_row(torch, flush, gen, "2p", ZAMBA2_PUBLISHED_ATTN, b=1,
                     s=ZAMBA2_PUBLISHED["seq"], scale=ZAMBA2_PUBLISHED_SCALE)
    return rows[0]


def _flash_train_row(torch, flush, gen, tag: str, attn: dict, b: int = 2,
                     s: int = 128, scale=None):
    """A row at a trainer's shape (2t, musicgen-medium: b=2, s=128,
    h=kvh=24, d=64; 2h, zamba2's shared block: h=kvh=32, d=80; 2p, the
    published Zamba2's: b=1, s=4,096, h=kvh=32, d=160 at its scale, the
    template's d = 160 instance; bf16), gated as the other rows, the
    kernel, the plain route and SDPA at the same ``scale`` (1/sqrt(d)
    where it is None); beside it, for information, the plain backward
    (``attention_flash.flash_bwd``, the reference's blockwise recompute)
    against SDPA's backward on the same inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models.attention_flash import flash_bwd

    dtype = torch.bfloat16
    h, kvh, d = attn["h"], attn["kvh"], attn["d"]
    q, k, v = (torch.randn((b, s, n, d), generator=gen,
                           device="cuda").to(dtype) for n in (h, kvh, kvh))
    do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    o, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    o_ref, lse_ref = flash_attention_ref(q, k, v, True, scale)
    torch.cuda.synchronize()
    tol = _tol(torch, dtype)
    err = float((o.float() - o_ref.float()).abs().max())
    lse_err = float((lse - lse_ref).abs().max())
    check(err <= tol and lse_err <= tol,
          f"flash {tag}: o err {err}, lse err {lse_err} > {tol}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pairs = s * (s + 1) // 2
    bound = bound_ms(_nbytes(q, k, v, o, lse),
                               4 * b * h * d * pairs, True)
    row = _row("train", dtype, err, tol,
               device_ms(torch, lambda: fa.flash_attention_fwd(
                   q, k, v, True, scale), flush=flush),
               device_ms(torch, lambda: flash_attention_ref(
                   q, k, v, True, scale), flush=flush),
               device_ms(torch, lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, scale=scale), flush=flush),
               bound, b=b, s=s, h=h, kvh=kvh, d=d)
    row.update(lse_max_abs_err=lse_err, row=tag, scale=scale)
    lse4 = lse.view(b, kvh, h // kvh, s)
    row["plain_backward_ms"] = device_ms(
        torch, lambda: flash_bwd(q, k, v, o, lse4, do, True, scale=scale),
        flush=flush)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                         scale=scale)
    dot = do.transpose(1, 2)
    row["sdpa_backward_ms"] = device_ms(
        torch, lambda: torch.autograd.grad(out, (qg, kg, vg), dot,
                                           retain_graph=True),
        flush=flush)
    emit("flash_attention", **row)


def _decode_bytes_flops(q, cache_row_bytes, lengths_host, h, d):
    """Bytes (q read, out written, the K and V rows of every filled
    position read once) and flops (4 per filled position, head and head
    dim) of one decode attention call."""
    filled = int(sum(lengths_host))
    return (2 * q.numel() * q.element_size() + filled * cache_row_bytes,
            4 * h * d * filled)


def phase_paged(torch, flush):
    """The paged kernel against ``gather_dense_decode`` at the serving
    path's decode shapes (b=8, pages of 16, 36 table columns, 289 pages):
    lengths 1, full, mid-page and others, and one row whose table is all
    scratch page 0 (length 1), as an inactive engine row; starcoder2's
    heads (g=12) and moonshot's (g=1), in bf16 and f32 (within 2e-2 and
    2e-5: the plain path rounds the probabilities to v's dtype). Times
    as :func:`phase_flash`'s, with no library call. Returns the first
    (bf16, serving-path) row."""
    from repro_torch.kernels import paged_attention as pa

    b, bs = SERVE["max_batch"], SERVE["block_size"]
    nblk = -(-(SERVE["pad_len"] + SERVE["max_new"]) // bs)          # 36
    nb = 1 + nblk * b                                                 # 289
    lengths_host = [1, nblk * bs, 13 * bs + 7, bs, 300, 450, 17, 1]
    gen = torch.Generator(device="cuda").manual_seed(2)
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    tables = perm[:b * nblk].reshape(b, nblk).to(torch.int32)
    tables[-1] = 0                                 # the scratch-only row
    lengths = torch.tensor(lengths_host, dtype=torch.int32, device="cuda")
    rows = []
    for kind, heads, dtype in [("path", STARCODER, torch.bfloat16),
                               ("path", STARCODER, torch.float32),
                               ("moonshot", MOONSHOT_ATTN, torch.bfloat16),
                               ("moonshot", MOONSHOT_ATTN, torch.float32)]:
        h, kvh, d = heads["h"], heads["kvh"], heads["d"]
        q = torch.randn((b, h, d), generator=gen, device="cuda").to(dtype)
        kp = torch.randn((nb, bs, kvh, d), generator=gen,
                         device="cuda").to(dtype)
        vp = torch.randn((nb, bs, kvh, d), generator=gen,
                         device="cuda").to(dtype)
        out = pa.paged_decode_attention_fwd(q, kp, vp, tables, lengths)
        want = pa.gather_dense_decode(q, kp, vp, tables, lengths)
        torch.cuda.synchronize()
        tol = _tol(torch, dtype)
        err = float((out.float() - want.float()).abs().max())
        check(bool(torch.isfinite(out).all()), "paged: non-finite output")
        check(err <= tol, f"paged {kind} {dtype}: max abs err {err} > {tol}")
        nbytes, flops = _decode_bytes_flops(
            q, 2 * kvh * d * q.element_size(), lengths_host, h, d)
        nbytes += _nbytes(tables, lengths)
        bound = bound_ms(nbytes, flops, dtype == torch.bfloat16)
        row = _row(kind, dtype, err, tol,
                   device_ms(torch, lambda: pa.paged_decode_attention_fwd(
                       q, kp, vp, tables, lengths), flush=flush),
                   device_ms(torch, lambda: pa.gather_dense_decode(
                       q, kp, vp, tables, lengths), flush=flush),
                   None, bound, b=b, h=h, kvh=kvh, d=d, bs=bs, nblk=nblk,
                   num_blocks=nb, lengths=lengths_host)
        rows.append(row)
        emit("paged_decode", **row)
    return rows[0]


def phase_decode(torch, flush):
    """The dense decode kernel against ``decode_attention_ref`` on a
    cache of S=1000 (not a multiple of the tile), at the split edges: a
    cache of S=1, and rows of length 0 (which must be zeros), within 2e-5
    (f32) and 2e-2 (bf16); SDPA with a boolean length mask as the
    library yardstick. Times as :func:`phase_flash`'s. Returns the first
    (bf16, serving-path) row."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.ref import decode_attention_ref

    h, kvh, d = STARCODER["h"], STARCODER["kvh"], STARCODER["d"]
    b = SERVE["max_batch"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for kind, s, dtype, lengths_host in [
            ("S1000", 1000, torch.bfloat16, [1, 1000, 999, 500, 33, 640, 17,
                                             250]),
            ("S1000", 1000, torch.float32, [1, 1000, 999, 500, 33, 640, 17,
                                            250]),
            ("S1", 1, torch.bfloat16, [1, 0, 1, 1, 0, 1, 1, 1]),
            ("len0", 1000, torch.bfloat16, [0, 1000, 0, 999, 33, 640, 0,
                                            250])]:
        lengths = torch.tensor(lengths_host, dtype=torch.int32,
                               device="cuda")
        mask = (torch.arange(s, device="cuda")[None, :]
                < lengths[:, None])[:, None, None, :]      # [b, 1, 1, S]
        q = torch.randn((b, h, d), generator=gen, device="cuda").to(dtype)
        kc = torch.randn((b, s, kvh, d), generator=gen,
                         device="cuda").to(dtype)
        vc = torch.randn((b, s, kvh, d), generator=gen,
                         device="cuda").to(dtype)
        out = da.decode_attention_fwd(q, kc, vc, lengths)
        want = decode_attention_ref(q, kc, vc, lengths)
        torch.cuda.synchronize()
        tol = _tol(torch, dtype)
        # a row of length 0 gets zeros, as the TPU kernel gives; the plain
        # version's softmax over all-masked scores averages v instead
        filled = [i for i, n in enumerate(lengths_host) if n > 0]
        empty = [i for i, n in enumerate(lengths_host) if n == 0]
        err = float((out[filled].float() - want[filled].float()).abs().max())
        check(bool(torch.isfinite(out).all()),
              f"decode {kind} {dtype}: non-finite output")
        check(err <= tol, f"decode {kind} {dtype}: max abs err {err} > {tol}")
        check(not empty or not bool(out[empty].any()),
              f"decode {kind}: a row of length 0 is not all zeros")
        nbytes, flops = _decode_bytes_flops(
            q, 2 * kvh * d * q.element_size(), lengths_host, h, d)
        nbytes += _nbytes(lengths)
        bound = bound_ms(nbytes, flops, dtype == torch.bfloat16)
        q4, kt, vt = q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
        row = _row(kind, dtype, err, tol,
                   device_ms(torch, lambda: da.decode_attention_fwd(
                       q, kc, vc, lengths), flush=flush),
                   device_ms(torch, lambda: decode_attention_ref(
                       q, kc, vc, lengths), flush=flush),
                   device_ms(torch, lambda: F.scaled_dot_product_attention(
                       q4, kt, vt, attn_mask=mask, enable_gqa=True),
                       flush=flush),
                   bound, b=b, S=s, h=h, kvh=kvh, d=d, lengths=lengths_host)
        rows.append(row)
        emit("decode_attention", **row)
    return rows[0]


SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def ssd_flops(b: int, nh: int, s: int, dk: int, dv: int) -> int:
    """The reference's operations for one call: its chunk (256, halved
    until it divides S) and per chunk q k^T, the gated product with v,
    q . H and the state update, two flops per multiply-add."""
    c = min(256, s)
    while s % c:
        c //= 2
    return b * nh * (s // c) * 2 * (c * c * dk + c * c * dv + 2 * c * dk * dv)


def _ssd_inputs(torch, gen, arch, s, dtype, h0_scale, b=1):
    """Inputs shaped and scaled as the two families' prefill makes them.
    zamba2: B and C one [S, 64] draw broadcast over 80 heads (head stride
    0), v = x * dt, log_a = dt * A with A = -(1..80) per head and dt =
    softplus(N(0, 1)), so a reaches about -55 a step at the last heads.
    xlstm: q / sqrt(512), v with mLSTM's ones column (dv 513) times a
    sigmoid input gate, log_a = logsigmoid(N(0, 1))."""
    import torch.nn.functional as F

    dev = dict(device="cuda")
    if arch == "zamba2":
        nh, dk, dv = 80, 64, 64
        bc = torch.randn((2, b, 1, s, dk), generator=gen, **dev).to(dtype)
        q, k = (x.expand(b, nh, s, dk) for x in bc)
        dt = F.softplus(torch.randn((b, nh, s), generator=gen, **dev))
        a = -torch.arange(1, nh + 1, dtype=torch.float32, **dev)
        log_a = dt * a[None, :, None]
        v = (torch.randn((b, nh, s, dv), generator=gen, **dev)
             * dt[..., None]).to(dtype)
    else:
        nh, dk, dv = 4, 512, 513
        q = (torch.randn((b, nh, s, dk), generator=gen, **dev)
             / math.sqrt(dk)).to(dtype)
        k = torch.randn((b, nh, s, dk), generator=gen, **dev).to(dtype)
        v = torch.cat([torch.randn((b, nh, s, dk), generator=gen, **dev),
                       torch.ones((b, nh, s, 1), **dev)], dim=-1)
        gate = torch.sigmoid(torch.randn((b, nh, s), generator=gen, **dev))
        v = (v * gate[..., None]).to(dtype)
        log_a = F.logsigmoid(torch.randn((b, nh, s), generator=gen, **dev))
    h0 = torch.randn((b, nh, dk, dv), generator=gen, **dev) * h0_scale
    return q, k, v, log_a, h0


def _relayout(torch, arch, v, h0):
    """The bf16 kernel's other two v layouts: zamba2's v at an odd time
    stride (65: element-wise loads, 32-column tiles) and xlstm's cut to
    dv 512 (even strides: paired loads, 16-column tiles)."""
    if arch == "zamba2":
        return torch.cat([v, v[..., :1]], dim=-1)[..., :v.shape[-1]], h0
    return v[..., :512].contiguous(), h0[..., :512].contiguous()


def _storage_bytes(t) -> int:
    """Bytes a tensor's elements occupy, counting a broadcast (stride 0)
    axis once: what a call must read of it."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _worst_head_rel(torch, got, want):
    """The largest error of any (batch, head) relative to that head's own
    largest magnitude, and the flat index of that head. A head whose
    reference is all zero must come out exactly zero."""
    err = (got - want).abs().flatten(2).amax(-1).flatten()
    peak = want.abs().flatten(2).amax(-1).flatten()
    rel = torch.where(peak > 0, err / peak.clamp_min(1e-30),
                      torch.where(err > 0, torch.inf, 0.0))
    worst = int(rel.argmax())
    return float(rel[worst]), worst


def phase_ssd_scan(torch, flush):
    """The SSD-scan kernel against ``ssd_scan_ref`` (the sequential scan)
    at both families' prefill shapes, at the published Zamba2's training
    shape (``train_4k``: b=1, 80 heads, S=4,096, bf16, timed as the path
    rows), S=200 (ragged) and S=1, and in bf16 one past a 64-step
    chunk (zamba2, S=65 and 129) and with the bf16 entry's other two v
    layouts (``_relayout``), with a nonzero h0 in all but the path and
    train_4k rows. y and h_final each within 1e-4 (f32) or
    2e-2 (bf16) of the plain version, relative to its largest magnitude,
    over the whole tensor and in every (batch, head) on its own:
    the kernel sums each chunk's products in another order than the
    step-by-step scan, across 512 (or 4,096) steps; the bf16 kernel rounds the
    gated scores and w o v to bf16 and carries H's hi/lo split into
    q . H, and bf16 y rounds once more. No single PyTorch call computes
    a gated linear recurrence, so there is no library time. Returns the
    first (zamba2 path, bf16) row."""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.ref import ssd_scan_ref

    gen = torch.Generator(device="cuda").manual_seed(4)
    s_path = RECURRENT["pad_len"]
    rows = []
    for kind, arch, s, dtype, h0_scale in [
            ("path", "zamba2", s_path, torch.bfloat16, 0.0),
            ("path", "zamba2", s_path, torch.float32, 0.0),
            ("path", "xlstm", s_path, torch.bfloat16, 0.0),
            ("path", "xlstm", s_path, torch.float32, 0.0),
            ("train_4k", "zamba2", ZAMBA2_PUBLISHED["seq"], torch.bfloat16,
             0.0),
            ("ragged", "zamba2", 200, torch.bfloat16, 0.5),
            ("ragged", "xlstm", 200, torch.float32, 0.5),
            ("ragged", "xlstm", 200, torch.bfloat16, 0.5),
            ("edge", "zamba2", 65, torch.bfloat16, 0.5),
            ("edge", "zamba2", 129, torch.bfloat16, 0.5),
            ("layout", "zamba2", 200, torch.bfloat16, 0.5),
            ("layout", "xlstm", 200, torch.bfloat16, 0.5),
            ("s1", "zamba2", 1, torch.float32, 0.5),
            ("s1", "xlstm", 1, torch.bfloat16, 0.5)]:
        q, k, v, log_a, h0 = _ssd_inputs(torch, gen, arch, s, dtype,
                                         h0_scale)
        if kind == "layout":
            v, h0 = _relayout(torch, arch, v, h0)
        y, h = ss.ssd_scan_fwd(q, k, v, log_a, h0)
        y_ref, h_ref = ssd_scan_ref(q, k, v, log_a, h0)
        torch.cuda.synchronize()
        name = str(dtype).replace("torch.", "")
        tol = SSD_TOL[name]
        err = float((y.float() - y_ref.float()).abs().max())
        h_err = float((h - h_ref).abs().max())
        y_max = float(y_ref.float().abs().max())
        h_max = float(h_ref.abs().max())
        check(y.dtype == dtype and y.shape == v.shape
              and h.shape == h0.shape and h.dtype == torch.float32,
              f"ssd_scan {arch} S={s}: bad outputs")
        check(bool(torch.isfinite(y.float()).all())
              and bool(torch.isfinite(h).all()),
              f"ssd_scan {arch} S={s} {name}: non-finite output")
        check(err <= tol * max(y_max, 1e-30)
              and h_err <= tol * max(h_max, 1e-30),
              f"ssd_scan {arch} S={s} {name}: y err {err} (max {y_max}), "
              f"h err {h_err} (max {h_max}) beyond {tol} relative")
        # and each (batch, head) against its own largest magnitude, so a
        # head of small values (zamba2's fast decays) is held as tightly
        y_head, y_head_at = _worst_head_rel(torch, y.float(), y_ref.float())
        h_head, h_head_at = _worst_head_rel(torch, h, h_ref)
        check(y_head <= tol and h_head <= tol,
              f"ssd_scan {arch} S={s} {name}: per-head relative error y "
              f"{y_head} (head {y_head_at}), h {h_head} (head {h_head_at}) "
              f"beyond {tol}")
        b, nh, _, dk = q.shape
        dv = v.shape[3]
        nbytes = (sum(_storage_bytes(t) for t in (q, k, v, log_a, h0))
                  + _nbytes(y, h))
        bound = bound_ms(nbytes, ssd_flops(b, nh, s, dk, dv),
                                   dtype == torch.bfloat16)
        timed = kind in ("path", "train_4k")
        row = _row(kind, dtype, err, tol,
                   device_ms(torch, lambda: ss.ssd_scan_fwd(
                       q, k, v, log_a, h0), flush=flush) if timed else None,
                   device_ms(torch, lambda: ssd_scan_ref(
                       q, k, v, log_a, h0), reps=5, flush=flush)
                   if timed else None,
                   None, bound, arch=arch, b=b, nh=nh, S=s, dk=dk, dv=dv,
                   qk_head_stride=q.stride(1), v_time_stride=v.stride(2))
        row.update(y_rel_err=err / max(y_max, 1e-30), h_max_abs_err=h_err,
                   h_rel_err=h_err / max(h_max, 1e-30), y_max_abs=y_max,
                   h_max_abs=h_max,
                   y_ref_rms=float(y_ref.float().pow(2).mean().sqrt()),
                   h_ref_rms=float(h_ref.pow(2).mean().sqrt()),
                   y_head_rel_err=y_head, y_worst_head=y_head_at,
                   h_head_rel_err=h_head, h_worst_head=h_head_at,
                   h0_scale=h0_scale, tol_is_relative=True)
        rows.append(row)
        emit("ssd_scan", **row)
    return rows[0]


#: the trainer's scan shapes (train_recurrent: batch 2 of 128 tokens)
SSD_TRAIN = dict(b=2, s=128)


def phase_ssd_scan_grad(torch, flush):
    """The SSD scan's autograd Function on the card (``_SsdScanFn``: the
    kernel forward; the backward kernel for zamba2's bf16 calls,
    ``ssd_scan._bwd_takes_kernel``, the plain chunked scan's VJP for the
    others) against
    autograd of the plain sequential scan (``ssd_scan_ref``) at both
    trainer shapes (zamba2: b=2, 80 heads, S=128, dk=dv=64, B and C one
    [b, 1, S, 64] leaf broadcast at head stride 0; xlstm: b=2, 4 heads,
    dk 512, dv 513), in f32 and bf16, with a nonzero h0 and both
    cotangents (dy and dh_final). The forward (y and h_final, from the
    kernel) is held as ``phase_ssd_scan`` holds it: each (batch, head)
    within 1e-4 (f32) or 2e-2 (bf16) of its own largest magnitude. Each
    gradient is held by its own dtype (dB and dC summed over the heads
    by the broadcast): an f32 gradient
    (every one of an f32 call; dlog_a and dh0, whose inputs are f32, of
    a bf16 call) within 1e-4 of its largest magnitude; a bf16 one (dq,
    dk, dv of a bf16 call) within 2e-2 of its own largest magnitude in
    every (batch, head), the forward gate's measure. dlog_a is not held
    per head: a head of fast decays (zamba2's last heads, a ~ -55 a
    step) has a near-zero dlog_a, the sum of large terms of both signs,
    so the chunked and sequential f32 sums part there by their rounding
    (1.7e-2 of such a head's own peak, 1.1e-5 of the whole, on the CPU
    at these shapes). Prints the forward kernel's, the plain
    backward's (``ssd_scan_bwd``) and the plain forward's device times
    beside the forward's bound."""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.ref import ssd_scan_bwd, ssd_scan_ref

    gen = torch.Generator(device="cuda").manual_seed(5)
    for arch in ("zamba2", "xlstm"):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, log_a, h0 = _ssd_inputs(
                torch, gen, arch, SSD_TRAIN["s"], dtype, 0.5,
                b=SSD_TRAIN["b"])
            leaves = [(x[:, :1] if arch == "zamba2" and i < 2 else x)
                      .detach().clone().requires_grad_()
                      for i, x in enumerate((q, k, v, log_a, h0))]
            dy = torch.randn(v.shape, generator=gen, device="cuda"
                             ).to(dtype)
            dh = torch.randn(h0.shape, generator=gen, device="cuda")

            def grads(fn):
                qq, kk = (x.expand(q.shape) for x in leaves[:2])
                y, h = fn(qq, kk, *leaves[2:])
                g = torch.autograd.grad((y, h), leaves, (dy, dh))
                return y.detach(), h.detach(), g

            y, h, got = grads(ss.ssd_scan_fwd)
            y_ref, h_ref, want = grads(ssd_scan_ref)
            torch.cuda.synchronize()
            name = str(dtype).replace("torch.", "")
            # the forward the trainer runs at this shape, as phase_ssd_scan
            # holds it: y and h_final in every (batch, head)
            tol = SSD_TOL[name]
            check(y.dtype == dtype and y.shape == v.shape
                  and h.dtype == torch.float32 and h.shape == h0.shape,
                  f"ssd_scan_grad {arch} {name}: bad forward outputs")
            check(bool(torch.isfinite(y.float()).all())
                  and bool(torch.isfinite(h).all()),
                  f"ssd_scan_grad {arch} {name}: non-finite forward")
            y_head, y_head_at = _worst_head_rel(torch, y.float(),
                                                y_ref.float())
            h_head, h_head_at = _worst_head_rel(torch, h, h_ref)
            check(y_head <= tol and h_head <= tol,
                  f"ssd_scan_grad {arch} {name}: forward per-head relative "
                  f"error y {y_head} (head {y_head_at}), h {h_head} "
                  f"(head {h_head_at}) beyond {tol}")
            fwd = {"y_max_abs_err": float((y.float() - y_ref.float())
                                          .abs().max()),
                   "y_head_rel_err": y_head, "y_worst_head": y_head_at,
                   "h_max_abs_err": float((h - h_ref).abs().max()),
                   "h_head_rel_err": h_head, "h_worst_head": h_head_at,
                   "tol": tol}
            errs = {}
            for gname, g, w in zip(("dq", "dk", "dv", "dlog_a", "dh0"),
                                   got, want):
                check(g.dtype == w.dtype and g.shape == w.shape,
                      f"ssd_scan_grad {arch} {name}: {gname} is "
                      f"{g.dtype} {tuple(g.shape)}")
                check(bool(torch.isfinite(g.float()).all()),
                      f"ssd_scan_grad {arch} {name}: {gname} not finite")
                err = float((g.float() - w.float()).abs().max())
                peak = float(w.float().abs().max())
                gtol = SSD_TOL[str(g.dtype).replace("torch.", "")]
                if g.dtype == torch.bfloat16:
                    rel, _ = _worst_head_rel(torch, g.float(), w.float())
                else:
                    rel = err / max(peak, 1e-30)
                errs[gname] = {"max_abs_err": err, "rel_err": rel,
                               "tol": gtol, "ref_max_abs": peak}
                check(rel <= gtol, f"ssd_scan_grad {arch} {name}: {gname} "
                                   f"relative error {rel} > {gtol}")
            b, nh, s, dk = q.shape
            dv = v.shape[3]
            nbytes = (sum(_storage_bytes(t) for t in (q, k, v, log_a, h0))
                      + _nbytes(v, h0.float()))
            bound = bound_ms(nbytes, ssd_flops(b, nh, s, dk, dv),
                                       dtype == torch.bfloat16)
            row = {"arch": arch, "dtype": name, "b": b, "nh": nh, "S": s,
                   "dk": dk, "dv": dv, "forward": fwd, "grads": errs,
                   "fwd_kernel_ms": device_ms(torch, lambda: ss._launch(
                       q, k, v, log_a, h0), flush=flush),
                   "bwd_plain_ms": device_ms(torch, lambda: ssd_scan_bwd(
                       q, k, v, log_a, h0, dy, dh), flush=flush),
                   "fwd_plain_ms": device_ms(torch, lambda: ssd_scan_ref(
                       q, k, v, log_a, h0), reps=5, flush=flush),
                   "fwd_bound_ms": max(bound.values()), **bound}
            emit("ssd_scan_grad", **row)


def phase_ssd_scan_bwd(torch, flush, ptxas=()):
    """The SSD scan's backward kernel (``ssd_scan._bwd_launch``, kernels
    ``ssd_bwd_*``, two launches) against the plain ``ssd_scan_bwd`` on
    the same inputs at the call of the cell zamba2-2.7b.fl_train_4k: b 1,
    S 4,096, 80 heads, dk = dv = 64, bf16, B and C one [S, 64] draw at
    head stride 0 (``_ssd_inputs``), h0 zero and no dh_final, as the
    trainer's Mamba2 layers call it. Gates: dq, dk and dv within 8e-3 of
    each (batch, head)'s own peak (a one-ulp bf16 flip is at most 2^-7
    of it), dlog_a within 2e-3 of its whole peak, and ptxas's report of
    both ``ssd_bwd_`` kernels (``ptxas``: the ``ptxas_summary`` entries;
    ``main`` rebuilds every library to have them) present and without
    spills. Prints the kernel's time (L2 flushed) beside its bound
    (FLOPs, 67.9 us: ``ssd_scan_bwd_roofline``'s cost of the cell's
    call, at the forward's 256-step chunks; at the kernel's own 64-step
    chunks the bytes bound it, at 64.1 us), the plain
    backward's time, and those kernels' registers."""
    from portbench import spec
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.ref import ssd_scan_bwd

    gen = torch.Generator(device="cuda").manual_seed(6)
    s = ZAMBA2_PUBLISHED["seq"]
    q, k, v, log_a, h0 = _ssd_inputs(torch, gen, "zamba2", s,
                                     torch.bfloat16, 0.0)
    dy = torch.randn(v.shape, generator=gen, device="cuda").to(v.dtype)
    check(ss._bwd_takes_kernel(q, v, log_a, h0),
          "ssd_scan_bwd: the cell's call does not take the kernel")
    got = ss._bwd_launch(q, k, v, log_a, h0, dy, None, False)
    want = ssd_scan_bwd(q, k, v, log_a, h0, dy, None)
    torch.cuda.synchronize()
    errs = {}
    for name, g, w, tol in zip(("dq", "dk", "dv", "dlog_a"), got, want,
                               (8e-3, 8e-3, 8e-3, 2e-3)):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"ssd_scan_bwd: {name} is {g.dtype} {tuple(g.shape)}")
        check(bool(torch.isfinite(g.float()).all()),
              f"ssd_scan_bwd: {name} not finite")
        peak = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        if name == "dlog_a":
            rel, at = err / max(peak, 1e-30), None
        else:
            rel, at = _worst_head_rel(torch, g.float(), w.float())
        errs[name] = {"max_abs_err": err, "rel_err": rel, "worst_head": at,
                      "tol": tol, "ref_max_abs": peak}
        check(rel <= tol, f"ssd_scan_bwd: {name} relative error {rel} "
                          f"(head {at}) > {tol}")
    kernels = [r for r in ptxas if "ssd_bwd_" in r["kernel"]]
    for stem in ("ssd_bwd_states_kernel", "ssd_bwd_chunk_kernel"):
        check(any(stem in r["kernel"] for r in kernels),
              f"ssd_scan_bwd: ptxas reported no {stem}: {kernels}")
    for r in kernels:
        check(r.get("spill_stores", 0) == 0 and r.get("spill_loads", 0) == 0,
              f"ssd_scan_bwd: {r['kernel']} spills: {r}")
    b, nh, _, dk = q.shape
    bench = spec.Bench()
    flops, nbytes = bench.reader("ssd_scan_bwd_roofline").call_cost(
        bench.config(ZAMBA2_PUBLISHED["config"]), {"batch": b, "seq": s})
    bound = bound_ms(nbytes, flops, True)
    kernel_ms = device_ms(torch, lambda: ss._bwd_launch(
        q, k, v, log_a, h0, dy, None, False), flush=flush)
    plain_ms = device_ms(torch, lambda: ssd_scan_bwd(
        q, k, v, log_a, h0, dy, None), reps=5, flush=flush,
        spin=20_000_000)
    row = {"b": b, "nh": nh, "S": s, "dk": dk, "dv": v.shape[3],
           "dtype": "bfloat16", "qk_head_stride": q.stride(1),
           "grads": errs, "max_abs_err": max(e["max_abs_err"]
                                             for e in errs.values()),
           "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": max(bound.values()), **bound,
           **shares(kernel_ms, max(bound.values()), None),
           "ptxas": kernels}
    emit("ssd_scan_bwd", **row)
    return row
