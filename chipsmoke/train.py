"""Training on the card: musicgen-medium, the recurrent families and the
published Zamba2-2.7B at full width through the port's trainer, each
family's steps against the CPU's at reduced depth in f32, and the
sharded step on a DTensor state. Each phase on a main path returns its
``{kernel: launches}``."""
from __future__ import annotations

import json
import math
import statistics
import sys
import time
from pathlib import Path

from chipsmoke.common import (ROOT, check, device_profile, emit,
                              label_profile, launch_totals)
from chipsmoke.refs import (TRAIN_ARGS, TRAIN_ATTN, TRAIN_CLI_BASE,
                            TRAIN_CLI_CASES, TRAIN_CLI_COMM, TRAIN_COMM_BYTES,
                            TRAIN_FLASH_PER_STEP, TRAIN_LAYERS,
                            TRAIN_MAR_ROUNDS_PER_STEP, TRAIN_MESH_COMM_BYTES,
                            TRAIN_MESH_PEAK_BYTES, TRAIN_MESH_STEPS,
                            TRAIN_PARAMS, TRAIN_RECURRENT,
                            TRAIN_TOKENS_PER_STEP, ZAMBA2_PUBLISHED)


def _peers_bit_equal(torch, tree_leaves, state) -> bool:
    """Every peer's slice of every leaf of theta and m equal to peer 0's,
    bit for bit."""
    return all(torch.equal(x[i], x[0]) for x in tree_leaves(
        {"p": state["params"], "m": state["momentum"]})
        for i in range(1, x.shape[0]))


def _check_steps(what: str, steps, launches, expect, peak, total) -> None:
    """The training runs' gates: every step's loss finite and its peers
    bit-equal, each kernel of ``expect`` launched that often in all, and
    the peak under the card's memory."""
    check(all(math.isfinite(st["loss"]) for st in steps),
          f"{what}: a loss is not finite: {[st['loss'] for st in steps]}")
    check(all(st["peers_bit_equal"] for st in steps),
          f"{what}: the peers' theta or m differ after a step")
    for name, want in expect.items():
        check(launches[name] == want, f"{what}: {name} launched "
                                      f"{launches[name]} times, expected "
                                      f"{want}")
    check(peak < total, f"{what}: peak {peak} >= the card's {total}")


def state_digests(torch, tree_leaves, state) -> list:
    """Per leaf of theta then m, per peer: the sums of the bit patterns
    and of their squares, mod 2^64 (exact, so in any order), taken in
    blocks so no leaf-sized int64 copy is made. Equal states give equal
    digests."""
    out = []
    for x in tree_leaves(state["params"]) + tree_leaves(state["momentum"]):
        if hasattr(x, "to_local"):
            x = x.to_local()
        bits = {2: torch.int16, 4: torch.int32}[x.element_size()]
        for i in range(x.shape[0]):
            flat = x[i].reshape(-1).view(bits)
            s1 = torch.zeros((), dtype=torch.int64, device=x.device)
            s2 = torch.zeros((), dtype=torch.int64, device=x.device)
            for c0 in range(0, flat.numel(), 1 << 26):
                b = flat[c0:c0 + (1 << 26)].long()
                s1 += b.sum()
                s2 += (b * b).sum()
                del b
            out.append((int(s1), int(s2)))
    return out


def _train_full_width(torch, smi, phase: str, args, expect: dict,
                      record=None) -> dict:
    """One full-width run of ``launch.train.main`` in process (``args``:
    its command line), the state updated in place. After every step
    every peer's theta and m are bit-equal (full participation over
    (2, 2) is a global mean broadcast to all); each kernel of ``expect``
    (``{kernel: launches a step}``; ``ssd_scan_bwd``: the SSD backward
    kernel's) launches that often a step; the
    ledger is ``expect["comm_bytes"]``; the peak is under the card's
    memory. Then one more step under ``torch.profiler`` (with the SSD
    scan's backward under its own label where the scan runs).
    With ``record`` (a dict), the state's digests after each of the
    first TRAIN_MESH_STEPS steps go to ``record["digests"]`` and the
    median ms a step to ``record["median_ms"]``, for train_mesh.
    Returns the main path's launch counts."""
    import gc

    from portbench.device import traced
    from repro_torch.core.fl_device import SPAN_AGGREGATE, SPAN_LOCAL
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    n_steps = int(args[args.index("--steps") + 1])
    steps, seen = [], {}

    def on_step(info):
        state = info["state"]
        steps.append({"step": info["t"] + 1,
                      "loss": float(info["metrics"]["loss"]),
                      "ms": info["seconds"] * 1e3,
                      "peers_bit_equal": _peers_bit_equal(
                          torch, tree_leaves, state)})
        emit(f"{phase}_step", **steps[-1])
        if record is not None and info["t"] < TRAIN_MESH_STEPS:
            record.setdefault("digests", []).append(
                state_digests(torch, tree_leaves, state))
        if info["t"] + 1 < n_steps:
            return
        # the main path ends here: read its counts before the extra step
        seen["launches"] = {**ops.launch_counts(),
                            "ssd_scan_bwd": ss.backward_launches}
        seen["ledger"] = info["ledger"].total_bytes
        seen["peak"] = torch.cuda.max_memory_allocated()
        seen["params_per_peer"] = sum(x[0].numel() for x in
                                      tree_leaves(state["params"]))
        summary = traced(torch.device("cuda"),
                         lambda: info["step_fn"](state, info["batch"]),
                         (SPAN_LOCAL, SPAN_AGGREGATE, ss.SPAN_BACKWARD))
        seen["profile"] = {
            "local_update": label_profile(summary, SPAN_LOCAL, 1),
            "aggregate": label_profile(summary, SPAN_AGGREGATE, 1),
            **device_profile(summary, 1)}
        if expect.get("ssd_scan"):      # the scan's backward
            seen["profile"]["ssd_scan_backward"] = label_profile(
                summary, ss.SPAN_BACKWARD, 1)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ss.backward_launches = 0
    t0 = time.perf_counter()
    check(train.main(list(args), on_step=on_step) == 0,
          f"{phase}: main did not return 0")
    run_s = time.perf_counter() - t0
    ms = [st["ms"] for st in steps]
    med = statistics.median(ms[1:])
    launches = seen["launches"]
    total = torch.cuda.get_device_properties(0).total_memory
    want = {k: v * len(steps) for k, v in expect.items() if k in launches}
    arch = args[args.index("--arch") + 1]
    emit(phase, arch=arch, args=list(args),
         params_per_peer_tree=seen["params_per_peer"],
         losses=[st["loss"] for st in steps], first_step_ms=ms[0],
         median_ms_steps_2_6=med,
         tokens_per_s=TRAIN_TOKENS_PER_STEP / (med / 1e3),
         peak_memory_bytes=seen["peak"],
         peak_gb=seen["peak"] / 1e9, card_memory_bytes=total,
         launches=launches, expected_launches=want,
         comm_total_bytes=seen["ledger"], run_s=run_s, card=smi)
    emit(f"{phase}_profile", arch=arch, **seen["profile"], card=smi)
    check(len(steps) == n_steps, f"{phase}: {len(steps)} steps ran")
    _check_steps(f"{phase} {arch}", steps, launches, want, seen["peak"],
                 total)
    check(seen["ledger"] == expect["comm_bytes"],
          f"{phase} {arch}: ledger {seen['ledger']} != the reference's "
          f"{expect['comm_bytes']}")
    check(seen["params_per_peer"] == expect.get("params",
                                                seen["params_per_peer"]),
          f"{phase} {arch}: {seen['params_per_peer']} parameters a peer, "
          f"expected {expect.get('params')}")
    if record is not None:
        record["median_ms"] = med
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches[k] for k in want}


def phase_train(torch, smi, record=None):
    """musicgen-medium at full width through the port's trainer: 48
    layers, d 1536, 24 MHA heads of 64, gated FFN 6144, vocab 2048,
    bf16; 4 peers on the (2, 2) grid, each a materialized copy of
    1,818,379,776 parameters (f32 momentum), batch 2 of 128 tokens a
    peer, one local step, 6 steps, seed 0, through
    ``launch.train.main``, the state updated in place. Prints every
    step's loss and ms, the median ms of steps 2-6, tokens/s and the
    peak memory, then one more step under ``torch.profiler``. Gates
    (``_train_full_width``): finite losses, every peer's theta and m
    bit-equal after each step, flash launched 48 layers x 4 peers x 2
    (forward and remat recompute) a step, mar_rounds 26 a step (one a
    leaf), the ledger TRAIN_COMM_BYTES, the peak under the card's
    memory."""
    from repro_torch.configs import get_config

    cfg = get_config("musicgen-medium")
    check(cfg.family == "audio" and cfg.num_layers == TRAIN_LAYERS
          and cfg.dtype == "bfloat16" and cfg.attn_impl == "flash"
          and cfg.remat == "block" and cfg.param_count() == TRAIN_PARAMS
          and (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
          == (TRAIN_ATTN["h"], TRAIN_ATTN["kvh"], TRAIN_ATTN["d"]),
          f"unexpected config {cfg}")
    return _train_full_width(torch, smi, "train", TRAIN_ARGS, {
        "flash_attention": TRAIN_FLASH_PER_STEP, "ssd_scan": 0,
        "ssd_scan_bwd": 0, "mar_rounds": TRAIN_MAR_ROUNDS_PER_STEP,
        "comm_bytes": TRAIN_COMM_BYTES}, record)


def phase_train_recurrent(torch, smi):
    """zamba2-2.7b (54 layers: 45 Mamba2 and 9 applications of one shared
    attention block, d 2560; 2,063,209,520 parameters) and xlstm-350m
    (21 mLSTM + 3 sLSTM, d 1024; 518,640,640) trained at full width,
    bf16, seed 0, with the musicgen run's traffic (TRAIN_ARGS): the
    SSD-scan kernel in every Mamba2 / mLSTM layer's forward and remat
    recompute, flash in zamba2's shared block, the scan's backward
    through its kernel (zamba2's Mamba2: dk = dv = 64, two launches a
    layer and peer) or the plain
    chunked scan's VJP (xlstm's mLSTM: dk 512) (``_train_full_width``'s
    gates, the launch counts of TRAIN_RECURRENT). Returns the summed
    launch counts."""
    from repro_torch.configs import get_config

    paths = []
    for arch, want in TRAIN_RECURRENT.items():
        cfg = get_config(arch)
        check(cfg.family in ("ssm", "hybrid") and cfg.dtype == "bfloat16"
              and cfg.attn_impl == "flash" and cfg.remat == "block",
              f"unexpected config {cfg}")
        args = ("--arch", arch, *TRAIN_ARGS[2:])
        paths.append(_train_full_width(torch, smi, "train_recurrent", args, {
            "ssd_scan": want["ssd_per_step"],
            "ssd_scan_bwd": want["ssd_bwd_per_step"],
            "flash_attention": want["flash_per_step"],
            "mar_rounds": want["mar_rounds_per_step"],
            "comm_bytes": want["comm_bytes"], "params": want["params"]}))
    return launch_totals(paths)


def phase_train_zamba2(torch, smi):
    """The published Zamba2-2.7B (``models/zamba2.py``) at the shape of
    ``zamba2-2.7b.fl_train_4k`` (ZAMBA2_PUBLISHED): the port's own init
    (seed 0), ``init_fl_state`` and ``make_fl_train_step`` over the grid
    (2,), as the benchmark's entry drives them, bf16, 3 steps of fresh
    token batches. Gates: the counted parameters, a finite loss, both
    peers' theta and m bit-equal after every step (a group of two means
    to one value), the launch counts of flash (d = 160 at Zamba2's
    scale), ssd_scan, the SSD backward kernel (``ssd_scan_bwd``, two
    launches a call) and mar_rounds, counted from 0 just before the
    first step, and the peak under the card's memory. Returns the launch
    counts."""
    import gc

    from portbench import spec
    from repro_torch.core.fl_device import init_fl_state, make_fl_train_step
    from repro_torch.core.moshpit import plan_grid
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves

    z = ZAMBA2_PUBLISHED
    bench = spec.Bench()
    cfg = bench.entry("fl_train_zamba2").port_config(
        bench.config(z["config"]))
    check(cfg.param_count() == z["params"] and cfg.head_dim == 160
          and cfg.dtype == "bfloat16" and cfg.remat == "block",
          f"unexpected config {cfg}")
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(cfg)
    peers, seq = z["peers"], z["seq"]
    state = init_fl_state(model, peers, seed=0, device="cuda")
    step_fn = make_fl_train_step(model, plan_grid(peers))
    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = []
    for _ in range(z["steps"]):
        ids = torch.randint(0, cfg.vocab_size, (peers, 1, 1, 1, seq + 1),
                            generator=gen, device="cuda")
        batches.append({"tokens": ids[..., :-1].int().contiguous(),
                        "labels": ids[..., 1:].int().contiguous()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ss.backward_launches = 0
    steps = []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        state, met = step_fn(state, batch)
        torch.cuda.synchronize()
        steps.append({"step": i + 1, "loss": float(met["loss"]),
                      "ms": (time.perf_counter() - t0) * 1e3,
                      "peers_bit_equal": _peers_bit_equal(
                          torch, tree_leaves, state)})
        emit("train_zamba2_step", **steps[-1])
    launches = {**ops.launch_counts(), "ssd_scan_bwd": ss.backward_launches}
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    n = len(steps)
    expect = {"flash_attention": z["flash_per_step"] * n,
              "ssd_scan": z["ssd_per_step"] * n,
              "ssd_scan_bwd": z["ssd_bwd_per_step"] * n,
              "mar_rounds": z["mar_rounds_per_step"] * n}
    emit("train_zamba2", config=z, leaves=len(tree_leaves(state["params"])),
         losses=[st["loss"] for st in steps], first_step_ms=steps[0]["ms"],
         median_ms_steps_2_3=statistics.median(st["ms"] for st in steps[1:]),
         peak_memory_bytes=peak, card_memory_bytes=total, launches=launches,
         expected_launches=expect, card=smi)
    _check_steps("train_zamba2", steps, launches, expect, peak, total)
    del state, step_fn, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches[k] for k in expect}


def _parity_batches(np, cfg, n: int, steps: int, prefix: int):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (n, 2, 2, 1, 32))
        b = {"tokens": toks.astype(np.int32),
             "labels": np.roll(toks, -1, -1).astype(np.int32)}
        if prefix:
            b["prefix_embeds"] = rng.normal(
                size=(n, 2, 2, 1, prefix, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def phase_train_parity(torch):
    """The trainer's checks at reduced depth: starcoder2-3b's and
    musicgen-medium's smoke configs (the latter with prefix embeddings)
    at 2 layers in f32, one theta^0 and one batch stream (2 local steps
    of 2 microbatches), ``make_fl_train_step`` on the card and on the
    CPU for 3 steps, under full participation and under U != A masks
    with int8 EF and a bf16 wire: every loss within 1e-4, the final
    theta within 1e-4 (with int8, a rounding within the two devices'
    f32 differences of a half-quantum may become a quantum: such flips
    <= 0.5% of a leaf and <= 2 quanta of the leaf's largest value). Then
    a ``--resize-at`` CLI run on the card with the survivors bit-exact
    across the resize and the reference's comm line.
    """
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    for arch in ("starcoder2-3b", "musicgen-medium"):
        cfg = dataclasses.replace(get_smoke_config(arch), num_layers=2,
                                  dtype="float32")
        _card_vs_cpu(torch, "train_parity", cfg,
                     ("full", "int8_ef_bf16"))

    # --resize-at on the card: survivors bit-exact, the reference's line
    seen = []
    real = train.apply_membership

    def spy(state, change, pipeline=None):
        before = [x.clone() for x in tree_leaves(state["params"])
                  + tree_leaves(state["momentum"])]
        out = real(state, change, pipeline)
        after = tree_leaves(out[0]["params"]) \
            + tree_leaves(out[0]["momentum"])
        seen.append(all(torch.equal(a[j], b[int(s)])
                        for a, b in zip(after, before)
                        for j, s in enumerate(change.survivors)))
        return out

    import contextlib
    import io

    buf = io.StringIO()
    train.apply_membership = spy
    try:
        with contextlib.redirect_stdout(buf):
            train.main(["--arch", "starcoder2-3b", *TRAIN_CLI_BASE,
                        *TRAIN_CLI_CASES["resize"]])
    finally:
        train.apply_membership = real
    line = next(ln for ln in buf.getvalue().splitlines()
                if ln.startswith("[train] comm total="))
    emit("train_resize", survivors_bit_exact=seen, comm_line=line)
    check(seen == [True], f"train_resize: survivors {seen}")
    check(line == TRAIN_CLI_COMM["starcoder2-3b resize"],
          f"train_resize: {line!r} is not the reference's")


def _card_vs_cpu(torch, phase: str, cfg, cases) -> None:
    """3 steps of ``make_fl_train_step`` from one theta^0 and one batch
    stream (2 local steps of 2 microbatches) on the card and on the CPU,
    for each case (``"full"``, or ``"int8_ef_bf16"``: U != A masks, int8
    EF over a bf16 wire): losses within 1e-4, the final theta within
    1e-4 (int8: the flip rule of ``phase_train_parity``)."""
    import numpy as np

    from repro_torch.core.aggregation import build_pipeline
    from repro_torch.core.fl_device import init_fl_state, make_fl_train_step
    from repro_torch.core.moshpit import plan_grid
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import PREFIX_LEN
    from repro_torch.tree import tree_leaves

    masks = {1: ([1, 0, 1, 1], [1, 0, 0, 1]), 2: ([1, 1, 1, 1],
                                                  [1, 1, 0, 1])}
    arch = cfg.name
    model = Model(cfg)
    prefix = PREFIX_LEN.get(cfg.frontend, 0)
    theta0 = model.init(seed=0, device="cpu")
    batches = _parity_batches(np, cfg, 4, 3, prefix)
    for case in cases:
        wire = (dict(compress="int8_ef", comm_dtype="bfloat16")
                if case != "full" else {})
        runs = {}
        for dev in ("cpu", "cuda"):
            grid = plan_grid(4)
            pipe = build_pipeline("mar", grid, backend="device", **wire)
            st = init_fl_state(model, 4, device=dev, pipeline=pipe,
                               params=theta0)
            step = make_fl_train_step(model, grid, lr=0.1, pipeline=pipe)
            losses = []
            for t, b in enumerate(batches):
                mk = {}
                if case != "full" and t in masks:
                    mk = {"mask": torch.tensor(masks[t][0],
                                               dtype=torch.float32),
                          "agg_mask": torch.tensor(
                              masks[t][1], dtype=torch.float32)}
                st, met = step(st, {k: torch.from_numpy(v)
                                    for k, v in b.items()}, **mk)
                losses.append(float(met["loss"]))
            runs[dev] = (losses, [x.cpu() for x in
                                  tree_leaves(st["params"])])
        loss_err = max(abs(a - b) for a, b in zip(runs["cpu"][0],
                                                  runs["cuda"][0]))
        theta_err, flips = 0.0, 0.0
        for c, g in zip(runs["cpu"][1], runs["cuda"][1]):
            d = (c - g).abs()
            theta_err = max(theta_err, float(d.max()))
            flips = max(flips, float((d > 1e-4).float().mean()))
            if case == "full":
                check(float(d.max()) <= 1e-4,
                      f"{phase} {arch} {case}: theta {d.max()}")
            else:
                check(flips <= 5e-3 and float(d.max())
                      <= 1e-4 + 2 * float(c.abs().max()) / 127,
                      f"{phase} {arch} {case}: theta "
                      f"{float(d.max())}, flips {flips}")
        emit(phase, arch=arch, layers=cfg.num_layers, case=case,
             losses_cpu=runs["cpu"][0], losses_cuda=runs["cuda"][0],
             loss_max_abs_err=loss_err, theta_max_abs_err=theta_err,
             theta_flip_share=flips, prefix=prefix)
        check(loss_err <= 1e-4, f"{phase} {arch} {case}: loss err "
                                f"{loss_err}")


def phase_train_recurrent_parity(torch):
    """The recurrent families' smoke configs at 2 layers in f32 (zamba2:
    one Mamba2 layer and the shared attention block, attn_every 2;
    xlstm: one mLSTM and one sLSTM layer): 3 steps on the card (the
    SSD-scan kernel forward, the plain VJP backward) and on the CPU
    (the plain scan both ways) from one theta^0, losses and theta
    within 1e-4 (``_card_vs_cpu``), 96 SSD-scan launches on the card."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops

    for arch, kw in (("zamba2-2.7b", dict(attn_every=2)),
                     ("xlstm-350m", dict(slstm_every=2))):
        cfg = dataclasses.replace(get_smoke_config(arch), num_layers=2,
                                  dtype="float32", **kw)
        ops.reset_launch_counts()
        _card_vs_cpu(torch, "train_recurrent_parity", cfg, ("full",))
        n = ops.launch_counts()["ssd_scan"]
        # 3 steps x 4 peers x 2 local steps x 2 microbatches, one scan
        # layer, forward and remat recompute
        check(n == 3 * 4 * 4 * 2, f"train_recurrent_parity {arch}: "
                                  f"{n} SSD-scan launches, expected 96")


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _mesh_state(torch, model, n_peers: int, mesh, cfg, device: str,
                rules: bool = True):
    """``init_fl_state`` from seed 0 as DTensors on ``mesh``: laid out by
    the sharding rules (peers over "data", TP over "model"), or with
    ``rules=False`` the peer dim split over "data" and nothing else
    (several peers a rank, which the rules give only with one peer a
    rank)."""
    from repro_torch.core.fl_device import init_fl_state
    from repro_torch.runtime.sharding import (NamedSharding, make_shard_plan,
                                              shard_tree, state_shardings)
    from repro_torch.tree import tree_map

    plain = init_fl_state(model, n_peers, seed=0, device=device)
    pm = {"params": plain["params"], "momentum": plain["momentum"]}
    if rules:
        sh = state_shardings(pm, make_shard_plan(mesh, ("data",)),
                             head_dim=cfg.head_dim, num_heads=cfg.num_heads,
                             num_kv_heads=cfg.num_kv_heads)
    else:
        sh = tree_map(lambda x: NamedSharding(
            mesh, ("data",) + (None,) * (x.dim() - 1)), pm)
    state = shard_tree(pm, sh)
    state["step"] = plain["step"]
    return state


def _train_mesh_full_width(torch, smi, record: dict) -> dict:
    """(a) and (c) of train_mesh on a one-rank NCCL world. Returns the
    launch counts of the TRAIN_MESH_STEPS steps."""
    import gc

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import topology
    from repro_torch.core.aggregation import CommLedger, build_pipeline
    from repro_torch.core.fl_device import make_fl_train_step
    from repro_torch.core.moshpit import plan_grid
    from repro_torch.data.synthetic import lm_token_stream
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import Model
    from repro_torch.runtime import roofline
    from repro_torch.runtime.op_analysis import OpAnalysis
    from repro_torch.tree import tree_leaves

    args = train._parser().parse_args(list(TRAIN_ARGS))
    cfg = get_config(args.arch)
    model = Model(cfg)
    n = args.peers
    grid = plan_grid(n)
    check(grid.dims == (2, 2), f"train_mesh: grid {grid.dims}")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"), device_type="cuda")
        pipeline = build_pipeline("mar", grid, backend="device")
        step = make_fl_train_step(model, grid, lr=args.lr,
                                  pipeline=pipeline)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = _mesh_state(torch, model, n, mesh, cfg, "cuda")
        leaf = tree_leaves(state["params"])[0]
        check(type(leaf).__name__ == "DTensor"
              and leaf.device_mesh is mesh, "train_mesh: not DTensors")
        stream = lm_token_stream(cfg.vocab_size, n * args.local_steps
                                 * args.batch, args.seq, seed=args.seed)
        ledger = CommLedger()
        peer_bytes = (topology.pytree_bytes(state["params"])
                      + topology.pytree_bytes(state["momentum"])) // n
        steps = []
        ops.reset_launch_counts()
        for t in range(TRAIN_MESH_STEPS):
            batch = {k: v.reshape(n, args.local_steps, 1, args.batch,
                                  args.seq) for k, v in next(stream).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            pipeline.record_iteration(ledger, n, peer_bytes)
            same = state_digests(torch, tree_leaves, state) \
                == record["digests"][t]
            steps.append({"step": t + 1, "loss": loss, "ms": ms,
                          "bit_equal_to_train": same})
            emit("train_mesh_step", **steps[-1])
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        med = statistics.median(st["ms"] for st in steps[1:])
        emit("train_mesh", what="(a) musicgen-medium, the train phase's "
             "traffic, state as DTensors on a one-rank NCCL DeviceMesh",
             mesh={"shape": list(mesh.shape),
                   "names": list(mesh.mesh_dim_names)},
             losses=[st["loss"] for st in steps],
             median_ms_steps_2_3=med, train_median_ms=record["median_ms"],
             launches=launches, comm_total_bytes=ledger.total_bytes,
             peak_memory_bytes=peak, peak_gb=peak / 1e9, card=smi)
        check(all(st["bit_equal_to_train"] for st in steps),
              "train_mesh (a): theta or m differ from the train phase's "
              f"after a step: {[st['bit_equal_to_train'] for st in steps]}")
        check(all(math.isfinite(st["loss"]) for st in steps),
              f"train_mesh (a): a loss is not finite: {steps}")
        check(launches["flash_attention"]
              == TRAIN_FLASH_PER_STEP * TRAIN_MESH_STEPS,
              f"train_mesh (a): {launches['flash_attention']} flash "
              f"launches, expected {TRAIN_FLASH_PER_STEP} a step")
        check(launches["mar_rounds"]
              == TRAIN_MAR_ROUNDS_PER_STEP * TRAIN_MESH_STEPS,
              f"train_mesh (a): {launches['mar_rounds']} mar_rounds "
              f"launches, expected {TRAIN_MAR_ROUNDS_PER_STEP} a step "
              f"(both rounds lie inside the one rank)")
        check(ledger.total_bytes == TRAIN_MESH_COMM_BYTES,
              f"train_mesh (a): ledger {ledger.total_bytes} != the "
              f"reference's {TRAIN_MESH_COMM_BYTES}")
        check(peak < TRAIN_MESH_PEAK_BYTES,
              f"train_mesh (a): peak {peak} bytes >= 80 GB")

        # (c): one more step, untimed, under the op analysis
        batch = {k: v.reshape(n, args.local_steps, 1, args.batch, args.seq)
                 for k, v in next(stream).items()}
        with OpAnalysis() as analysis:
            step(state, batch)
        torch.cuda.synchronize()
        args_bytes = sum(x.numel() * x.element_size() for x in
                         tree_leaves(state["params"])
                         + tree_leaves(state["momentum"]))
        shape = type("Shape", (), {"global_batch": n * args.batch,
                                   "seq_len": args.seq})
        rep = roofline.analyze(
            analysis.analyze(),
            roofline.memory_dict(args_bytes, peak - args_bytes),
            arch=args.arch, shape=f"train b={n * args.batch} s={args.seq}",
            mesh="one-rank-1x1", chips=1,
            model_flops=roofline.model_flops_estimate(cfg, shape, "train"))
        r = rep.to_dict()
        emit("train_mesh_roofline", what="(c) op_analysis of one more "
             "step of (a); H100 SXM5 datasheet peaks; the hand-written "
             "kernels (ctypes) are not counted",
             flops=r["hlo_flops_per_chip"], bytes=r["hlo_bytes_per_chip"],
             collective_bytes=r["collective_bytes_per_chip"],
             compute_s=r["compute_s"], memory_s=r["memory_s"],
             collective_s=r["collective_s"], dominant=r["dominant"],
             roofline_ms=r["step_time_s"] * 1e3, measured_ms=med,
             roofline_share=r["step_time_s"] * 1e3 / med,
             model_flops=r["model_flops"],
             useful_flops_fraction=r["useful_flops_fraction"],
             hbm_fraction=r["memory_per_chip"]["hbm_fraction"], card=smi)
        check(r["hlo_flops_per_chip"] > 0 and r["hlo_bytes_per_chip"] > 0,
              "train_mesh (c): the analysis counted nothing")
        del state, step, analysis
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _mesh_rank(rank: int, port: int, out_dir: str) -> None:
    """(b) of train_mesh, one of two ranks on the one card (gloo)."""
    import dataclasses
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2,
                            timeout=timedelta(seconds=120))
    try:
        import numpy as np
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch.configs import get_smoke_config
        from repro_torch.core import mar_allreduce as mar
        from repro_torch.core.fl_device import (init_fl_state,
                                                make_fl_train_step)
        from repro_torch.core.moshpit import plan_grid
        from repro_torch.models.model import Model
        from repro_torch.runtime.op_analysis import OpAnalysis
        from repro_torch.tree import tree_leaves

        torch.cuda.set_device(0)
        cfg = dataclasses.replace(get_smoke_config("musicgen-medium"),
                                  dtype="float32")
        model = Model(cfg)
        grid = plan_grid(4)
        mesh = DeviceMesh("cuda", torch.arange(2), mesh_dim_names=("data",))
        rng = np.random.default_rng(3)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                            (4, 1, 1, 2, 32)))
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, -1)}
        step = make_fl_train_step(model, grid, lr=0.05)
        ref, ref_m = step(init_fl_state(model, 4, seed=0, device="cuda"),
                          batch)
        state = _mesh_state(torch, model, 4, mesh, cfg, "cuda", rules=False)
        state, metrics = step(state, batch)
        first = mar.peer_layout(tree_leaves(state["params"])[0]).first
        err = {}
        for key in ("params", "momentum"):
            err[key] = max(float((x.to_local().float()
                                  - y[first:first + 2].float())
                                 .abs().max())
                           for x, y in zip(tree_leaves(state[key]),
                                           tree_leaves(ref[key])))
        agg = {"p": state["params"], "m": state["momentum"]}
        seen = {}
        for name, fn in (
                ("round0", lambda: mar.mar_round_device(agg, grid, 0)),
                ("round1", lambda: mar.mar_round_device(agg, grid, 1)),
                ("one_shot", lambda: mar.mar_aggregate_device(
                    agg, grid, one_shot=True))):
            with OpAnalysis() as a:
                fn()
            torch.cuda.synchronize()
            seen[name] = a.collectives
        out = {"rank": rank, "peers": [first, first + 2],
               "theta_err": err["params"], "m_err": err["momentum"],
               "loss": float(metrics["loss"]), "ref_loss": float(ref_m[
                   "loss"]), "collectives": seen,
               "local_shape": list(tree_leaves(
                   state["params"])[0].to_local().shape)}
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def phase_train_mesh(torch, smi, record: dict) -> dict:
    """The multi-rank device backend.

    (a) musicgen-medium at full width with the train phase's traffic for
    TRAIN_MESH_STEPS steps through ``make_fl_train_step`` on a state laid
    out as DTensors by the sharding rules on a one-rank NCCL
    ``DeviceMesh`` (data=1, model=1): after each step theta and m equal
    the train phase's bit for bit (``state_digests``, recorded by its
    ``on_step``), finite losses, 384 flash and 26 mar_rounds launches a
    step (both rounds lie inside the rank), the reference's ledger for
    those steps, the peak under 80 GB; ms a step beside the train
    phase's. (b) two processes on the one card over gloo (NCCL refuses
    two ranks on one card): musicgen's smoke config in f32, 2 peers a
    rank on (2, 2), so round 0 crosses ranks and round 1 is local; theta
    and m within 1e-6 of the unsharded step, round 0 one all_reduce over
    2 ranks, round 1 none, ``one_shot`` one over 2. Not a multi-card
    result. (c) the roofline line of (a)'s step: ``OpAnalysis`` over one
    more, untimed step against the H100 datasheet terms, beside the
    measured ms. Returns (a)'s launches."""
    import tempfile

    import torch.multiprocessing as mp

    launches = _train_mesh_full_width(torch, smi, record)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_mesh_rank, args=(_free_port(), tmp), nprocs=2, join=True)
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(2)]
    emit("train_mesh_two_ranks", what="(b) two processes on the one card "
         "over gloo, musicgen-medium smoke config in f32, 2 peers a rank "
         "on (2, 2); not a multi-card result", ranks=ranks,
         run_s=time.perf_counter() - t0, card=smi)
    for r in ranks:
        check(r["theta_err"] <= 1e-6 and r["m_err"] <= 1e-6,
              f"train_mesh (b) rank {r['rank']}: theta {r['theta_err']}, "
              f"m {r['m_err']} from the unsharded step")
        check(abs(r["loss"] - r["ref_loss"]) <= 1e-6,
              f"train_mesh (b) rank {r['rank']}: loss {r['loss']} vs "
              f"{r['ref_loss']}")
        sizes = {k: [(op, g) for op, _, g in v]
                 for k, v in r["collectives"].items()}
        check(sizes == {"round0": [("all-reduce", 2)], "round1": [],
                        "one_shot": [("all-reduce", 2)]},
              f"train_mesh (b) rank {r['rank']}: collectives {sizes}")
    return {k: launches[k] for k in ("flash_attention", "mar_rounds")}
