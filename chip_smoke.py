#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device     — the card (nvidia-smi name and power limit, capability
                >= 9.0, torch and CUDA versions); TF32 is switched off
                for matmuls and cuDNN so f32 means f32.
2. build      — nvcc builds every kernel under
                src/repro_torch/kernels/csrc/, one process per source.
3. group_mean — the CUDA kernel against its plain PyTorch version on the
                card, at the main path's leaf shapes (G=9, M=3,
                D in {98304, 128, 2560, 20}, f32), D=98304 in bf16, a
                ragged tail (D=1000) and D=1, each with a fully dropped
                group; f32 within 2e-5, bf16 within 2e-2; median times
                of 20 CUDA-event-timed calls beside the memory bound.
4. vision     — 16 peers on the vision task (the CNN), 3 iterations,
                kernel on: finite loss, disagreement <= 1e-10.
5. federation — the quickstart config (27 peers, text task, MLP head
                768->128->20, kernel on) for 20 iterations on the card:
                accuracy >= 0.30, peer disagreement <= 1e-10, the ledger
                exactly as the reference's (2,618,231,040 bytes,
                0.89577216 simulated seconds), 480 kernel launches; then
                the same run with the kernel off must end within 1e-5.
6. profile    — ten quickstart steps under ``torch.profiler``: host and
                device time of each layer ``Federation.step`` labels
                (transport, local update, aggregation), the device's
                busy share, the kernels that fill it.
7. kernels    — one JSON object per kernel: launches on the main path,
                max error, times, bound.

Then the card's nvidia-smi line and, last, ``{"ok": true, "device":
...}``. Any failed check exits non-zero before the last line; so does a
host without CUDA, or a directory without the repo's ``src/``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
QUICKSTART_BYTES = 2_618_231_040
QUICKSTART_SIM_S = 0.89577216
MAIN_PATH_D = (98304, 128, 2560, 20)    # fc1.w, fc1.b, fc2.w, fc2.b


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``reps`` calls of ``fn``. Before each, the
    card spins for about a millisecond (``torch.cuda._sleep``) while the
    host queues the start event, the call and the end event, so the
    interval holds the call's kernels and not the host's Python."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def group_mean_bound_ms(g: int, m: int, d: int, itemsize: int) -> dict:
    """Least time for the masked group mean, the larger of two: x read
    once, mask read once and y written once over HBM (``bytes_ms``); a
    multiply-add per element read and a divide per column over the f32
    rate (``ops_ms``)."""
    nbytes = 2 * g * m * d * itemsize + g * m * 4
    flops = 2 * g * m * d + g * d
    return {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": flops / F32_FLOP_PER_S * 1e3}


def phase_group_mean(torch, gm, ref):
    cases = [("path", d, torch.float32) for d in MAIN_PATH_D] + [
        ("bf16", 98304, torch.bfloat16), ("tail", 1000, torch.float32),
        ("d1", 1, torch.float32)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
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
                   torch, lambda: gm.group_mean_fwd(x, mask)),
               "plain_ms": device_ms(
                   torch, lambda: ref.group_mean_ref(x, mask)),
               "bound_ms": max(bound.values()), **bound}
        rows.append(row)
        emit("group_mean", **row)
    return rows


def run_quickstart(torch, Federation, cfg, ops, iterations: int = 20):
    fed = Federation(cfg)           # the default device: cuda
    state = fed.init_state()
    accs, step_s = [], []
    ops.reset_launch_counts()
    for t in range(iterations):
        t0 = time.perf_counter()
        state = fed.step(state)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if (t + 1) % 5 == 0:
            accs.append(fed.evaluate(state))
    launches = ops.launch_counts()["group_mean"]
    return fed, state, accs, step_s, launches


def phase_federation(torch, smi):
    from repro_torch.core.federation import Federation
    from repro_torch.kernels import ops
    from repro_torch.quickstart import quickstart_config
    from repro_torch.tree import tree_leaves

    cfg = quickstart_config(kernel_group_mean=True)
    fed, state, accs, step_s, launches = run_quickstart(
        torch, Federation, cfg, ops)
    n_leaves = 2 * len(tree_leaves(state.params))        # theta and m
    want_launches = 20 * fed.plan.depth * n_leaves
    dis = fed.peer_disagreement(state)
    out = {"n_peers": cfg.n_peers, "grid": list(fed.plan.dims),
           "accuracy_every_5": accs, "disagreement": dis,
           "comm_bytes": fed.comm_bytes, "sim_seconds": fed.sim_seconds,
           "launches": launches, "expected_launches": want_launches,
           "first_step_ms": step_s[0] * 1e3,
           "ms_per_iteration": statistics.median(step_s[1:]) * 1e3,
           "card": smi}
    emit("federation", **out)
    check(want_launches == 480, f"expected 480 launches, plan gives "
                                f"{want_launches}")
    check(launches == want_launches,
          f"group_mean launched {launches} times on the main path, "
          f"expected {want_launches}")
    check(accs[-1] >= 0.30, f"accuracy {accs[-1]} < 0.30 at iteration 20")
    check(dis <= 1e-10, f"peer disagreement {dis} > 1e-10")
    check(fed.comm_bytes == QUICKSTART_BYTES,
          f"comm_bytes {fed.comm_bytes} != {QUICKSTART_BYTES}")
    check(abs(fed.sim_seconds - QUICKSTART_SIM_S) <= 1e-9,
          f"sim_seconds {fed.sim_seconds} != {QUICKSTART_SIM_S}")

    _, state_off, accs_off, step_off, launches_off = run_quickstart(
        torch, Federation, quickstart_config(kernel_group_mean=False), ops)
    diff = max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(state.params), tree_leaves(state_off.params)))
    emit("federation_kernel_off", max_param_diff_vs_kernel=diff,
         accuracy_every_5=accs_off, launches=launches_off,
         ms_per_iteration=statistics.median(step_off[1:]) * 1e3, card=smi)
    check(launches_off == 0, f"kernel-off run launched {launches_off}")
    check(diff <= 1e-5, f"kernel on/off params differ by {diff} > 1e-5")
    return launches


def phase_vision(torch):
    import torch.nn.functional as F

    from repro_torch.core.federation import Federation, FederationConfig
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves, tree_map

    cfg = FederationConfig(n_peers=16, technique="mar", task="vision",
                           kernel_group_mean=True)
    fed = Federation(cfg)
    state = fed.init_state()
    ops.reset_launch_counts()
    for _ in range(3):
        state = fed.step(state)
    launches = ops.launch_counts()["group_mean"]
    with torch.no_grad():
        p0 = tree_map(lambda x: x[:1], state.params)
        logits = fed.apply_fn(p0, fed.test["x"].unsqueeze(0))[0]
        loss = float(F.cross_entropy(logits, fed.test["y"]))
    dis = fed.peer_disagreement(state)
    want = 3 * fed.plan.depth * 2 * len(tree_leaves(state.params))
    emit("vision", n_peers=16, grid=list(fed.plan.dims), test_loss=loss,
         accuracy=fed.evaluate(state), disagreement=dis, launches=launches,
         expected_launches=want)
    check(math.isfinite(loss), f"vision loss {loss} is not finite")
    check(all(bool(torch.isfinite(x).all())
              for x in tree_leaves(state.params)), "vision params not finite")
    check(dis <= 1e-10, f"vision disagreement {dis} > 1e-10")
    check(launches == want, f"vision launches {launches} != {want}")


def phase_profile(torch):
    """Where a kernel-on quickstart step's time goes.

    Ten ``Federation.step`` calls under ``torch.profiler``. The step's
    own labels (transport, local update, aggregation) give each layer's
    host time and the device time of the kernels it launched; the
    kernels give the device's busy share of the wall time. The profiler
    slows the host, so these times are shares, not the step's speed
    (that is the federation phase's). ``label_us`` is what one label
    costs with no profiler running, as every plain step pays it.
    """
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core.federation import (SPAN_AGGREGATE,
                                             SPAN_LOCAL_UPDATE,
                                             SPAN_TRANSPORT, Federation)
    from repro_torch.quickstart import quickstart_config

    fed = Federation(quickstart_config(kernel_group_mean=True))
    state = fed.init_state()
    for _ in range(3):
        state = fed.step(state)
    torch.cuda.synchronize()
    steps = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state = fed.step(state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    cpu = torch.autograd.DeviceType.CPU
    cuda = torch.autograd.DeviceType.CUDA
    names = {SPAN_TRANSPORT: "transport", SPAN_LOCAL_UPDATE: "local_update",
             SPAN_AGGREGATE: "aggregate"}
    spans = {v: {"host_ms": 0.0, "device_ms": 0.0, "count": 0}
             for v in names.values()}
    kernels: dict = {}
    for e in prof.events():
        if e.name in names:
            if e.device_type == cpu:
                s = spans[names[e.name]]
                s["host_ms"] += e.time_range.elapsed_us() / steps / 1e3
                s["device_ms"] += e.device_time_total / steps / 1e3
                s["count"] += 1
        elif e.device_type == cuda:
            k = kernels.setdefault(e.name[:60], [0, 0.0])
            k[0] += 1
            k[1] += e.self_device_time_total
    for v, s in spans.items():
        check(s["count"] == steps, f"profile: label {v} seen {s['count']} "
                                   f"times in {steps} steps")
    busy_us = sum(us for _, us in kernels.values())
    check(busy_us > 0, "profile: no device time recorded")

    n = 10_000
    t0 = time.perf_counter()
    for _ in range(n):
        with record_function(SPAN_TRANSPORT):
            pass
    label_us = (time.perf_counter() - t0) / n * 1e6

    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:5]
    emit("profile", steps=steps, wall_ms_per_step=wall_us / steps / 1e3,
         spans_per_step={v: {"host_ms": s["host_ms"],
                             "device_ms": s["device_ms"]}
                         for v, s in spans.items()},
         device_busy_ms_per_step=busy_us / steps / 1e3,
         device_busy_share=busy_us / wall_us, label_us=label_us,
         top_kernels_per_step=[{"name": k, "launches": c / steps,
                                "device_us": us / steps}
                               for k, (c, us) in top])


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build
        from repro_torch.kernels import group_mean as gm
        from repro_torch.kernels import ref
    except ImportError as e:
        fail(f"cannot import repro_torch from {ROOT / 'src'}: {e}")

    smi = smi_line()
    cap = torch.cuda.get_device_capability(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         capability=list(cap), torch=torch.__version__,
         cuda=torch.version.cuda, tf32_matmul=False, tf32_cudnn=False)
    check(cap >= (9, 0), f"capability {cap} < (9, 0): the kernels are "
                         f"built for sm_90a")

    t0 = time.perf_counter()
    report = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         sources=_build.sources(),
         ptxas={k: [ln for ln in v["log"].splitlines() if "ptxas" in ln]
                for k, v in report.items()})

    rows = phase_group_mean(torch, gm, ref)
    phase_vision(torch)
    launches = phase_federation(torch, smi)
    phase_profile(torch)

    # one call at each main-path leaf shape (G=9, M=3, the four D, f32),
    # times and bounds summed over the four
    path = [r for r in rows if r["kind"] == "path"]
    print(json.dumps({"kernels": [{
        "name": "group_mean", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/group_mean.cu",
        "replaces": "src/repro/kernels/group_mean.py:34",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in path),
        "ms": sum(r["kernel_ms"] for r in path),
        "plain_ms": sum(r["plain_ms"] for r in path),
        "bound_ms": sum(r["bound_ms"] for r in path),
        "bound_by": ("bytes" if sum(r["bytes_ms"] for r in path)
                     >= sum(r["ops_ms"] for r in path) else "operations"),
        "library_ms": None}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
