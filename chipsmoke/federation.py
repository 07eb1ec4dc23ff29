"""The paper's federation on the card, the group mean in its kernel: the
vision task, the quickstart with every protocol extension, the smoke
figures, the large-N engines, the socket transport and the quickstart's
profile. Each phase on a main path returns its ``{kernel: launches}``."""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

from chipsmoke.common import ROOT, check, emit, top_kernels
from chipsmoke.refs import (EXTENSION_REF, FIGURE_EXT_ROWS, FIGURE_ROWS,
                            KERNEL_OFF_GATED, LARGE_N_REF, LARGE_N_RUNS,
                            QUICKSTART_BYTES, QUICKSTART_SIM_S, SOCKET_LOSSY,
                            SOCKET_REF, TRAIN_CLI_BASE, TRAIN_CLI_CASES,
                            TRAIN_CLI_COMM, TRAIN_CLI_RANKS,
                            figure_ext_mismatches, wall_masked)


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
    """The quickstart config (27 peers, text task, MLP head 768->128->20,
    kernel on) for 20 iterations on the card: accuracy >= 0.30, peer
    disagreement <= 1e-10, the ledger exactly the reference's
    (QUICKSTART_BYTES, QUICKSTART_SIM_S), 60 kernel launches (one per
    round: 20 x 3 rounds x 1 f32 batch); then the same run with the
    kernel off, which must end within 1e-5 and launch nothing."""
    from repro_torch.core.federation import Federation
    from repro_torch.kernels import ops
    from repro_torch.kernels.group_mean import batches
    from repro_torch.quickstart import quickstart_config
    from repro_torch.tree import tree_leaves

    cfg = quickstart_config(kernel_group_mean=True)
    fed, state, accs, step_s, launches = run_quickstart(
        torch, Federation, cfg, ops)
    # one launch per round for each dtype batch of theta and m's leaves
    per_round = len(batches(tree_leaves({"p": state.params,
                                         "m": state.momentum})))
    want_launches = 20 * fed.plan.depth * per_round
    dis = fed.peer_disagreement(state)
    out = {"n_peers": cfg.n_peers, "grid": list(fed.plan.dims),
           "accuracy_every_5": accs, "disagreement": dis,
           "comm_bytes": fed.comm_bytes, "sim_seconds": fed.sim_seconds,
           "launches": launches, "expected_launches": want_launches,
           "first_step_ms": step_s[0] * 1e3,
           "ms_per_iteration": statistics.median(step_s[1:]) * 1e3,
           "card": smi}
    emit("federation", **out)
    check(want_launches == 60, f"expected 60 launches, plan gives "
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
    return {"group_mean": launches}


def _socket_quickstart(torch, cfg, ops, each=None, iterations: int = 20
                       ) -> dict:
    """The quickstart config ``cfg`` over the socket transport for
    ``iterations`` steps, the counts set to 0 just before and read just
    after; ``each(t, fed, state)`` runs after every step, outside the
    timed region. Returns the federation, the state, step seconds, the
    accuracy at the end, the group-mean launches and the frames' payload
    bytes."""
    from repro_torch.core.federation import Federation

    fed = Federation(cfg)
    state = fed.init_state()
    step_s, payload = [], 0
    ops.reset_launch_counts()
    for t in range(iterations):
        t0 = time.perf_counter()
        state = fed.step(state)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        payload += fed.last_transcript.payload_bytes
        if each is not None:
            each(t, fed, state)
    launches = ops.launch_counts()["group_mean"]
    return {"fed": fed, "state": state, "step_s": step_s,
            "accuracy": fed.evaluate(state), "launches": launches,
            "payload_bytes": payload}


def _socket_trainer(torch, smi, tmp: str) -> dict:
    """``launch.train`` over the socket transport at starcoder2-3b's
    smoke config: once in process (flash counted), then as two rank
    processes of one loopback book on the card. Each comm-total line,
    wall-clock masked, is the reference's. Returns the in-process run's
    flash and mar_rounds launches."""
    import contextlib
    import io
    import os

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.runtime.socket_transport import AddressBook

    argv = ["--arch", "starcoder2-3b", *TRAIN_CLI_BASE,
            *TRAIN_CLI_CASES["socket"]]
    cfg = get_smoke_config("starcoder2-3b")
    # 3 steps x 4 peers x every layer, forward and remat recompute
    want_flash = 3 * 4 * cfg.num_layers * (2 if cfg.remat == "block" else 1)
    buf = io.StringIO()
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    counts = {k: ops.launch_counts()[k]
              for k in ("flash_attention", "mar_rounds")}
    flash = counts["flash_attention"]
    one_s = time.perf_counter() - t0
    line = wall_masked(next(ln for ln in buf.getvalue().splitlines()
                            if ln.startswith("[train] comm total=")))
    check(rc == 0, "federation_socket trainer: main did not return 0")
    check(line == TRAIN_CLI_COMM["starcoder2-3b socket"],
          f"federation_socket trainer: {line!r}")
    check(flash == want_flash, f"federation_socket trainer: flash launched "
                               f"{flash} times, expected {want_flash}")

    book = os.path.join(tmp, "book.json")
    AddressBook.loopback(4, world_size=2).to_json(book)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *argv,
         "--peer-hosts", book, "--rank", str(r)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    two_s = time.perf_counter() - t0
    lines = [[wall_masked(ln) for ln in out.splitlines()
              if ln.startswith("[train] comm total=")] for out, _ in outs]
    emit("federation_socket_trainer", args=argv, flash_launches=flash,
         mar_rounds_launches=counts["mar_rounds"],
         in_process_s=one_s, two_rank_s=two_s,
         rank_lines=lines, rank_rcs=[p.returncode for p in procs],
         card=smi)
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"federation_socket rank {r} exited "
                                 f"{p.returncode}: {err[-2000:]}")
        check(lines[r] == [TRAIN_CLI_RANKS["starcoder2-3b"][r]],
              f"federation_socket rank {r}: {lines[r]}")
    return counts


def phase_federation_socket(torch, smi):
    """The federation and the trainer over the real TCP transport.

    1. The quickstart (kernel on) over ``transport="socket"`` in
       loopback mode, 20 iterations: theta and m after every iteration
       bit-equal to the sim route's (a lossless transport changes no
       mask), the reference's ledger, 60 group-mean launches, accuracy
       >= 0.30, the frames' payload bytes equal to the billed bytes, and
       the blobs of iteration 0 encoded on the card byte-equal to the
       same state's encoded on the CPU; ms per iteration beside the sim
       route's.
    2. The same under injected loss (SOCKET_LOSSY): each iteration's
       lost senders and the ledger by source the reference's
       (SOCKET_REF), accuracy in its band, 60 launches.
    3. ``run_multiprocess`` (two spawned ranks on a loopback book) over
       the quickstart's mar, ar and fedavg plans, byte-exact against the
       sim; then ``python -m repro_torch.transport_calibration --smoke``
       exits 0.
    4. The trainer over socket, in process and as two rank processes
       (``_socket_trainer``).
    Returns the group-mean launches of 1 and 2 and the in-process
    trainer's flash and mar_rounds launches."""
    import dataclasses
    import os
    import tempfile

    import numpy as np

    from repro_torch.core.aggregation import build_pipeline
    from repro_torch.core.federation import Federation
    from repro_torch.kernels import ops
    from repro_torch.quickstart import quickstart_config
    from repro_torch.runtime.socket_transport import (encode_state_payloads,
                                                      run_multiprocess)
    from repro_torch.runtime.transport_base import build_transport
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = quickstart_config(kernel_group_mean=True)
    sim = Federation(cfg)
    state = sim.init_state()
    sim_s, sim_trees = [], []
    for _ in range(20):
        t0 = time.perf_counter()
        state = sim.step(state)
        torch.cuda.synchronize()
        sim_s.append(time.perf_counter() - t0)
        sim_trees.append([x.clone() for x in tree_leaves(
            {"p": state.params, "m": state.momentum})])

    first = Federation(dataclasses.replace(cfg, transport="socket"))
    params0 = first.init_state().params
    blobs_card = encode_state_payloads(params0)
    blobs_cpu = encode_state_payloads(tree_map(lambda x: x.cpu(), params0))
    diverged = []

    def same_as_sim(t, fed, st):
        got = tree_leaves({"p": st.params, "m": st.momentum})
        if not all(torch.equal(x, y) for x, y in zip(got, sim_trees[t])):
            diverged.append(t)

    run = _socket_quickstart(torch, dataclasses.replace(
        cfg, transport="socket"), ops, each=same_as_sim)
    fed = run["fed"]
    out = {"n_peers": cfg.n_peers, "grid": list(fed.plan.dims),
           "comm_bytes": fed.comm_bytes,
           "payload_bytes": run["payload_bytes"],
           "wall_clock_comm_s": fed.sim_seconds,
           "accuracy": run["accuracy"], "launches": run["launches"],
           "diverged_iterations": diverged,
           "blob_bytes": len(blobs_card[0]),
           "blobs_card_equal_cpu": blobs_card == blobs_cpu,
           "first_step_ms": run["step_s"][0] * 1e3,
           "ms_per_iteration": statistics.median(run["step_s"][1:]) * 1e3,
           "sim_ms_per_iteration": statistics.median(sim_s[1:]) * 1e3,
           "card": smi}
    emit("federation_socket", **out)
    check(not diverged, f"federation_socket: theta or m differ from the "
                        f"sim route after iterations {diverged}")
    check(fed.comm_bytes == QUICKSTART_BYTES,
          f"federation_socket: comm_bytes {fed.comm_bytes}")
    check(run["payload_bytes"] == fed.comm_bytes,
          f"federation_socket: payload {run['payload_bytes']} != billed "
          f"{fed.comm_bytes}")
    check(run["launches"] == 60,
          f"federation_socket: {run['launches']} group-mean launches")
    check(run["accuracy"] >= 0.30,
          f"federation_socket: accuracy {run['accuracy']} < 0.30")
    check(blobs_card == blobs_cpu and len(blobs_card) == cfg.n_peers,
          "federation_socket: the card's payload blobs differ from the "
          "CPU's")
    launches = run["launches"]

    lost = []
    lossy = _socket_quickstart(
        torch, dataclasses.replace(cfg, **SOCKET_LOSSY), ops,
        each=lambda t, f, st: lost.append(sum(
            1 << int(i) for i in f.last_transcript.lost_senders.nonzero()[0])))
    lo, hi = SOCKET_REF["band"]
    emit("federation_socket_lossy", link_params=SOCKET_LOSSY["link_params"],
         lost_senders=lost, by_source=dict(lossy["fed"].ledger.by_source),
         accuracy=lossy["accuracy"], band=[lo, hi],
         launches=lossy["launches"],
         ms_per_iteration=statistics.median(lossy["step_s"][1:]) * 1e3,
         card=smi)
    check(lost == SOCKET_REF["lost_senders"],
          f"federation_socket lossy: lost senders {lost}")
    check(dict(lossy["fed"].ledger.by_source) == SOCKET_REF["by_source"],
          f"federation_socket lossy: ledger {lossy['fed'].ledger.by_source}")
    check(lo <= lossy["accuracy"] <= hi,
          f"federation_socket lossy: accuracy {lossy['accuracy']} outside "
          f"[{lo}, {hi}]")
    check(lossy["launches"] == 60,
          f"federation_socket lossy: {lossy['launches']} launches")
    launches += lossy["launches"]

    mask = np.ones(cfg.n_peers, np.float32)
    techs = ("mar", "ar", "fedavg")
    plans = [build_pipeline(t, sim.plan).message_plan(
        mask, sim.model_bytes, cfg.n_peers) for t in techs]
    t0 = time.perf_counter()
    merged = run_multiprocess(cfg.n_peers, plans, world_size=2)
    mp_s = time.perf_counter() - t0
    net = build_transport("sim", cfg.n_peers, profile="uniform")
    exact = {}
    for tech, p, tr in zip(techs, plans, merged):
        ref = net.run(p)
        exact[tech] = (tr.total_bytes == ref.total_bytes
                       and tr.bytes_by_round == ref.bytes_by_round
                       and tr.bytes_by_link == ref.bytes_by_link
                       and tr.n_messages == ref.n_messages)
    t0 = time.perf_counter()
    cal = subprocess.run(
        [sys.executable, "-m", "repro_torch.transport_calibration",
         "--smoke"], env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=600)
    emit("federation_socket_2proc", plans=list(techs), byte_exact=exact,
         bytes=[int(tr.total_bytes) for tr in merged], seconds=mp_s,
         calibration_rc=cal.returncode,
         calibration_s=time.perf_counter() - t0,
         calibration_summary=cal.stdout.strip().splitlines()[-1:],
         card=smi)
    check(all(exact.values()), f"federation_socket 2proc: {exact}")
    check(cal.returncode == 0, f"transport_calibration --smoke exited "
                               f"{cal.returncode}: {cal.stderr[-2000:]}")

    with tempfile.TemporaryDirectory() as tmp:
        trainer = _socket_trainer(torch, smi, tmp)
    emit("federation_socket_phase", seconds=time.perf_counter() - t_phase)
    return {"group_mean": launches, **trainer}


def phase_vision(torch):
    """16 peers on the vision task (the CNN), 3 iterations, kernel on:
    finite loss and params, disagreement <= 1e-10, 12 kernel launches
    (3 iterations x 4 rounds x 1 batch)."""
    import torch.nn.functional as F

    from repro_torch.core.federation import Federation, FederationConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.group_mean import batches
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
    want = 3 * fed.plan.depth * len(batches(tree_leaves(
        {"p": state.params, "m": state.momentum})))
    emit("vision", n_peers=16, grid=list(fed.plan.dims), test_loss=loss,
         accuracy=fed.evaluate(state), disagreement=dis, launches=launches,
         expected_launches=want)
    check(math.isfinite(loss), f"vision loss {loss} is not finite")
    check(all(bool(torch.isfinite(x).all())
              for x in tree_leaves(state.params)), "vision params not finite")
    check(dis <= 1e-10, f"vision disagreement {dis} > 1e-10")
    check(want == 12, f"expected 12 vision launches, plan gives {want}")
    check(launches == want, f"vision launches {launches} != {want}")


def run_extension(torch, cfg, ops, iterations: int = 20) -> dict:
    """``iterations`` steps of one config on the card: ms per step, the
    group-mean launches, the grid depth and fleet size of every step,
    accuracy at iteration 20, and every membership change the federation
    applied, with the state just before and just after it."""
    from repro_torch.core.federation import Federation

    fed = Federation(cfg)           # the default device: cuda
    changes = []
    apply = fed.apply_membership

    def spy(state, change):         # observe the membership entry point
        out = apply(state, change)
        changes.append((change, state, out))
        return out

    fed.apply_membership = spy
    state = fed.init_state()
    clip0 = float(state.dp["clip"]) if state.dp else None
    step_s, depths, sizes = [], [], []
    ops.reset_launch_counts()
    for _ in range(iterations):
        t0 = time.perf_counter()
        state = fed.step(state)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        depths.append(fed.plan.depth)
        sizes.append(fed.cfg.n_peers)
    launches = ops.launch_counts()["group_mean"]
    return {"fed": fed, "state": state, "step_s": step_s, "depths": depths,
            "sizes": sizes, "launches": launches, "changes": changes,
            "accuracy": fed.evaluate(state), "clip0": clip0}


def _kernel_vs_plain_every_aggregation(torch, cfg, iterations: int = 20
                                       ) -> float:
    """One more run of ``cfg`` on the card in which every MAR
    aggregation is computed twice from the same input, by the kernel and
    by the kernel-off route; the run goes on with the kernel's
    result. Returns the largest difference over every leaf (DP's
    indicator and smoothed deltas included) of every aggregation."""
    from repro_torch.core import mar_allreduce as mar
    from repro_torch.core.federation import Federation
    from repro_torch.tree import tree_leaves

    worst = [0.0]
    route = mar.mar_aggregate_sim

    def both(state, plan, mask=None, num_rounds=None, use_kernel=False):
        out = route(state, plan, mask, num_rounds=num_rounds,
                    use_kernel=use_kernel)
        plain = route(state, plan, mask, num_rounds=num_rounds,
                      use_kernel=False)
        worst[0] = max([worst[0]] + [
            float((a.float() - b.float()).abs().max())
            for a, b in zip(tree_leaves(out), tree_leaves(plain))])
        return out

    mar.mar_aggregate_sim = both
    try:
        fed = Federation(cfg)
        state = fed.init_state()
        for _ in range(iterations):
            state = fed.step(state)
    finally:
        mar.mar_aggregate_sim = route
    return worst[0]


def phase_federation_extensions(torch, smi) -> dict:
    """The quickstart under each protocol extension (quickstart.EXTENSIONS)
    on the card, kernel on, 20 iterations: Moshpit-KD (kd_iterations 6),
    DP at sigma 0.3, DP with the clipping indicator securely aggregated,
    int8 error feedback, staleness-1 async, all of them composed, and
    elastic membership (27 -> 13 peers at iteration 7, -> 26 at 14, iid
    churn at 0.9 participation and 0.1 dropout). Each run's ledger
    exactly the reference's (EXTENSION_REF), one group-mean launch per
    MAR round (60 a run, 67 for the elastic one: depths 3, 4 and 3),
    finite params, accuracy at iteration 20 in the band, the DP clip
    moved, int8's bytes a quarter of the quickstart's, the elastic run's
    fleet 27 -> 13 -> 26 with its survivors bit-exact across each change
    and its joiners within 1e-6 of the f32 mean; a kernel-off rerun of
    each, within 1e-5 for KERNEL_OFF_GATED and printed for the others;
    and one more run of each in which every aggregation is also computed
    by the kernel-off route from the same input, within 1e-5 of the
    kernel's. Each row gives first_step_ms, ms_per_iteration and the
    card. Returns the group-mean launches of the gated runs."""
    from repro_torch.core.compression import INT8_RATIO
    from repro_torch.kernels import ops
    from repro_torch.quickstart import EXTENSIONS, extension_config
    from repro_torch.tree import tree_leaves

    total = 0
    for name in EXTENSIONS:
        want_bytes, want_s, (acc_lo, acc_hi) = EXTENSION_REF[name]
        cfg = extension_config(name)
        r = run_extension(torch, cfg, ops)
        fed, state = r["fed"], r["state"]
        # one launch per MAR round: every aggregated tree here (theta and
        # m, plus DP's smoothed deltas and indicator) is one f32 batch
        want_launches = sum(r["depths"])
        row = {"extension": name, "n_peers": r["sizes"],
               "grid_end": list(fed.plan.dims),
               "stages": list(fed.pipeline.stage_names),
               "comm_bytes": fed.comm_bytes, "sim_seconds": fed.sim_seconds,
               "by_source": fed.ledger.by_source,
               "launches": r["launches"], "expected_launches": want_launches,
               "accuracy_20": r["accuracy"], "accuracy_band": [acc_lo, acc_hi],
               "first_step_ms": r["step_s"][0] * 1e3,
               "ms_per_iteration": statistics.median(r["step_s"][1:]) * 1e3,
               "card": smi}
        if cfg.use_kd:          # the distilling steps after the first
            row["kd_step_ms"] = statistics.median(
                r["step_s"][1:cfg.kd_iterations]) * 1e3
        if state.dp:
            row.update(clip_start=r["clip0"], clip_end=float(state.dp["clip"]))
        check(want_launches == (67 if name == "elastic" else 60),
              f"{name}: the grids give {want_launches} rounds")
        check(r["launches"] == want_launches,
              f"{name}: group_mean launched {r['launches']} times, expected "
              f"{want_launches}")
        check(fed.comm_bytes == want_bytes,
              f"{name}: comm_bytes {fed.comm_bytes} != {want_bytes}")
        check(abs(fed.sim_seconds - want_s) <= 1e-9,
              f"{name}: sim_seconds {fed.sim_seconds} != {want_s}")
        check(all(bool(torch.isfinite(x).all())
                  for x in tree_leaves(state.params)),
              f"{name}: params not finite")
        check(acc_lo <= r["accuracy"] <= acc_hi,
              f"{name}: accuracy {r['accuracy']} at iteration 20 outside "
              f"[{acc_lo}, {acc_hi}]")
        if state.dp:
            check(row["clip_end"] != r["clip0"], f"{name}: the clip never "
                                                 f"moved")
        if name == "int8_ef":
            check(fed.comm_bytes == QUICKSTART_BYTES / INT8_RATIO,
                  f"int8_ef bytes {fed.comm_bytes} != a quarter of "
                  f"{QUICKSTART_BYTES}")
        if name == "elastic":
            row.update(_elastic_checks(torch, tree_leaves, r))
        off = run_extension(torch, extension_config(
            name, kernel_group_mean=False), ops)
        diff = max(float((x - y).abs().max()) for x, y in zip(
            tree_leaves(state.params), tree_leaves(off["state"].params)))
        row.update(kernel_off_max_param_diff=diff,
                   kernel_off_launches=off["launches"],
                   kernel_off_ms_per_iteration=statistics.median(
                       off["step_s"][1:]) * 1e3)
        check(off["launches"] == 0, f"{name}: kernel-off run launched "
                                    f"{off['launches']}")
        if name in KERNEL_OFF_GATED:
            check(diff <= 1e-5, f"{name}: kernel on/off params differ "
                                f"by {diff} > 1e-5")
        shadow = _kernel_vs_plain_every_aggregation(torch, cfg)
        row["kernel_vs_kernel_off_every_aggregation_max_diff"] = shadow
        check(shadow <= 1e-5, f"{name}: the kernel's aggregation differs "
                              f"from the kernel-off route's by {shadow} > "
                              f"1e-5")
        emit("federation_extensions", **row)
        total += r["launches"]
    return {"group_mean": total}


def _run_large_n(torch, cfg, ops, iterations: int = 20) -> dict:
    """``iterations`` steps of one large-N config on the card: ms per
    step, and per step the group-mean launches and the depth of the grid
    in force (a regroup lands after its step)."""
    from repro_torch.core.federation import Federation

    fed = Federation(cfg)           # the default device: cuda
    state = fed.init_state()
    step_s, depths, per_step = [], [], []
    ops.reset_launch_counts()
    for _ in range(iterations):
        depths.append(fed.plan.depth)
        before = ops.launch_counts()["group_mean"]
        t0 = time.perf_counter()
        state = fed.step(state)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append(ops.launch_counts()["group_mean"] - before)
    return {"fed": fed, "state": state, "step_s": step_s, "depths": depths,
            "per_step": per_step, "launches": sum(per_step),
            "accuracy": fed.evaluate(state)}


def phase_federation_large_n(torch, smi) -> dict:
    """The large-N engines and controllers on the card (LARGE_N_RUNS, the
    group mean in the kernel, 20 iterations): adaptive group sizing at
    N = 125 (5 x 5 x 5) on the wireless profile under each transport,
    and clustered placement at N = 64 on shuffled regions. Each run's
    ledger by source, sim_seconds (within 1e-9), regroup_log and
    placement_log are the reference's (LARGE_N_REF); the three
    transports' ledgers equal each other; the adaptive runs regroup
    twice, onto grids with virtual slots (5x5x5 -> 3^5 over 243 slots ->
    2^7 over 128); every step launches the group mean once per round of
    the grid in force; accuracy at 20
    within the reference's band; and a second run of each, in which
    every aggregation is also computed by the kernel-off route from the
    same input, agrees within 1e-5. Returns the main runs' launches."""
    from repro_torch.core.federation import FederationConfig
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves

    total, ledgers = 0, {}
    for name, kw in LARGE_N_RUNS.items():
        ref = LARGE_N_REF[name]
        cfg = FederationConfig(kernel_group_mean=True, **kw)
        r = _run_large_n(torch, cfg, ops)
        fed, state = r["fed"], r["state"]
        by_source = dict(fed.ledger.by_source)
        regroups = [[t, list(a), list(b)] for t, a, b in fed.regroup_log]
        placements = [list(x) for x in fed.placement_log]
        row = {"run": name, "n_peers": cfg.n_peers,
               "transport": cfg.transport, "grid_end": list(fed.plan.dims),
               "comm_bytes": fed.comm_bytes, "sim_seconds": fed.sim_seconds,
               "by_source": by_source, "regroup_log": regroups,
               "placement_log": placements, "depths": r["depths"],
               "launches_per_step": r["per_step"],
               "launches": r["launches"], "accuracy_20": r["accuracy"],
               "accuracy_band": ref["band"],
               "first_step_ms": r["step_s"][0] * 1e3,
               "ms_per_iteration": statistics.median(r["step_s"][1:]) * 1e3,
               "card": smi}
        check(by_source == ref["by_source"]
              and fed.comm_bytes == ref["comm_bytes"],
              f"{name}: ledger {by_source} != the reference's "
              f"{ref['by_source']}")
        check(abs(fed.sim_seconds - ref["sim_seconds"]) <= 1e-9,
              f"{name}: sim_seconds {fed.sim_seconds} != "
              f"{ref['sim_seconds']}")
        check(regroups == ref["regroup_log"],
              f"{name}: regroups {regroups} != {ref['regroup_log']}")
        check(placements == ref["placement_log"],
              f"{name}: placements {placements} != {ref['placement_log']}")
        if cfg.adaptive_m:
            check(regroups, f"{name}: no regroup")
            ledgers[name] = (by_source, fed.sim_seconds, regroups)
        else:
            check(placements and by_source.get("placement_probe", 0) > 0,
                  f"{name}: no placement regroup or no probe traffic")
        check(r["per_step"] == r["depths"],
              f"{name}: group_mean launches per step {r['per_step']} != "
              f"the rounds of the grid in force {r['depths']}")
        check(all(bool(torch.isfinite(x).all())
                  for x in tree_leaves(state.params)),
              f"{name}: params not finite")
        lo, hi = ref["band"]
        check(lo <= r["accuracy"] <= hi,
              f"{name}: accuracy {r['accuracy']} at iteration 20 outside "
              f"[{lo}, {hi}]")
        shadow = _kernel_vs_plain_every_aggregation(torch, cfg)
        row["kernel_vs_kernel_off_every_aggregation_max_diff"] = shadow
        check(shadow <= 1e-5, f"{name}: the kernel's aggregation differs "
                              f"from the kernel-off route's by {shadow}")
        emit("federation_large_n", **row)
        total += r["launches"]
    check(len({json.dumps(v, sort_keys=True) for v in ledgers.values()})
          == 1, f"federation_large_n: the transports' ledgers differ: "
                f"{ledgers}")
    return {"group_mean": total}


def _elastic_checks(torch, tree_leaves, r) -> dict:
    """The elastic run: 27 peers, 13 from iteration 7, 26 from 14;
    survivors bit-exact across each change, joiners at the f32 mean."""
    sizes = r["sizes"]
    check(sizes == [27] * 7 + [13] * 7 + [26] * 6,
          f"elastic: n_peers per step {sizes}")
    check(len(r["changes"]) == 2, f"elastic: {len(r['changes'])} changes")
    out = []
    for change, before, after in r["changes"]:
        k = len(change.survivors)
        joiner_err = 0.0
        for old, new in ((before.params, after.params),
                         (before.momentum, after.momentum)):
            for x, y in zip(tree_leaves(old), tree_leaves(new)):
                check(torch.equal(y[:k], x[:k]),
                      f"elastic: survivors changed at {change.old_n} -> "
                      f"{change.new_n}")
                if change.new_n > k:
                    mean = x.double().mean(0, keepdim=True)
                    joiner_err = max(joiner_err, float(
                        (y[k:].double() - mean).abs().max()))
        check(joiner_err <= 1e-6, f"elastic: joiners {joiner_err} from the "
                                  f"f32 mean")
        out.append({"old_n": change.old_n, "new_n": change.new_n,
                    "grid": list(change.new_plan.dims),
                    "survivors_bit_exact": True,
                    "joiner_max_err_vs_mean": joiner_err})
    # the steps that began with a change: 7 and 14
    return {"membership_changes": out,
            "resize_step_ms": [r["step_s"][t] * 1e3 for t in (7, 14)]}


def _rerun_diff(torch, cfg, steps: int) -> float:
    """Two runs of one config from one seed on the card: the largest
    difference of their params after ``steps`` steps (0: exact from
    run to run)."""
    from repro_torch.core.federation import Federation
    from repro_torch.tree import tree_leaves

    runs = []
    for _ in range(2):
        fed = Federation(cfg)
        state = fed.init_state()
        for _ in range(steps):
            state = fed.step(state)
        runs.append(tree_leaves(state.params))
    return max(float((a - b).abs().max()) for a, b in zip(*runs))


def phase_figures(torch, smi) -> dict:
    """``repro_torch.figures --smoke`` (Figs. 1-5, 8 and 11, 8 peers, 6
    iterations) on the card, every MAR round's group mean in the kernel,
    each run's ms per iteration: every row's comm_mb and sim_s equal the
    reference's (FIGURE_ROWS), and Fig. 5's divergence within 1e-5;
    Figs. 8 and 11 as ``figure_ext_mismatches`` holds them
    (FIGURE_EXT_ROWS: partition statistics and comm_mb equal, accuracy
    in its band). Then Fig. 5's MAR (kernel on and off) and FedAvg
    configs at N=125 twice each: every route must be exact from run to
    run. Returns the kernel's launches in the figure runs."""
    import contextlib
    import io

    from repro_torch.core.federation import FederationConfig
    from repro_torch.figures import run_figures, scale
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        rows = run_figures(["1", "2", "3", "4", "5", "8", "11"],
                           scale(False, True), 0, None, smoke=True)
    launches = ops.launch_counts()["group_mean"]
    seconds = time.perf_counter() - t0
    ext = {name for name, _ in FIGURE_EXT_ROWS}
    got = [r for r in rows if r["row"] not in ("fig1_scaling", "fig_timing")
           and r["row"] not in ext]
    bad = figure_ext_mismatches(rows)
    check(not bad, f"figures: Figs. 8 and 11 part from the reference: "
                   f"{bad}")
    check(len(got) == len(FIGURE_ROWS),
          f"figures: {len(got)} rows, the reference prints "
          f"{len(FIGURE_ROWS)}")
    for r, (name, comm_mb, sim_s) in zip(got, FIGURE_ROWS):
        check(r["row"] == name, f"figures: row {r['row']} where the "
                                f"reference has {name}")
        for key, want in (("comm_mb", comm_mb), ("sim_s", sim_s)):
            check(want is None or str(r.get(key)) == want,
                  f"figures: {name} {key} {r.get(key)} != {want}")
        if name == "fig5_divergence":
            check(float(r["max_param_diff"]) <= 1e-5,
                  f"figures: Fig. 5 {r['technique']} diverges from FedAvg "
                  f"by {r['max_param_diff']} > 1e-5")
    check(launches > 0, "figures: the group-mean kernel never launched")
    timing = [r for r in rows if r["row"] == "fig_timing"]

    full = scale(True)
    base = dict(n_peers=full["peers"], task="text",
                local_batches=full["local_batches"], seed=0)
    rerun = {label: _rerun_diff(torch, FederationConfig(**base, **kw), 10)
             for label, kw in (
                 ("mar_kernel", dict(technique="mar",
                                     kernel_group_mean=True)),
                 ("mar_kernel_off", dict(technique="mar")),
                 ("fedavg", dict(technique="fedavg")))}
    emit("figures", seconds=seconds, rows=got,
         ext_rows=[r for r in rows if r["row"] in ext], launches=launches,
         ms_per_iteration={f"{r['fig']}/{r['run']}": r["ms_per_iteration"]
                           for r in timing},
         rerun_max_param_diff_n125_10_steps=rerun, card=smi)
    check(all(v == 0.0 for v in rerun.values()),
          f"figures: a route differs between two runs of one config: "
          f"{rerun}")
    return {"group_mean": launches}


def profile_quickstart(torch, steps: int = 10, cfg=None) -> dict:
    """Where a kernel-on quickstart step's time goes.

    ``steps`` ``Federation.step`` calls of ``cfg`` (the quickstart by
    default) traced by the benchmark's reader
    (``portbench.device.traced``), after three untraced ones. The step's
    own labels (transport, local update, aggregation, and MKD where the
    config distills) give each layer's host time, its kernel launches
    and the device time of the work they queued; each label must be seen
    once a step it runs. The
    device's busy time (the union of its intervals) gives the busy share
    of the window and the labelled share of the busy time. The profiler
    slows the host, so these times are shares, not the step's speed
    (that is :func:`run_quickstart`'s). ``label_us`` is what one label
    costs with no profiler running, as every plain step pays it.
    """
    from torch.profiler import record_function

    from portbench.device import traced
    from repro_torch.core.federation import (SPAN_AGGREGATE,
                                             SPAN_LOCAL_UPDATE, SPAN_MKD,
                                             SPAN_TRANSPORT, Federation)
    from repro_torch.quickstart import quickstart_config

    if cfg is None:
        cfg = quickstart_config(kernel_group_mean=True)
    fed = Federation(cfg)
    state = fed.init_state()
    for _ in range(3):
        state = fed.step(state)

    def run():
        nonlocal state
        for _ in range(steps):
            state = fed.step(state)

    names = {SPAN_TRANSPORT: "transport", SPAN_LOCAL_UPDATE: "local_update",
             SPAN_AGGREGATE: "aggregate"}
    # the steps that run each label: MKD only in the first kd_iterations
    counts = dict.fromkeys(names.values(), steps)
    if cfg.use_kd:
        names[SPAN_MKD] = "mkd"
        counts["mkd"] = sum(t < cfg.kd_iterations
                            for t in range(3, 3 + steps))
    summary = traced(torch.device("cuda"), run, names)
    spans = {v: summary.spans[k] for k, v in names.items()}
    for v, span in spans.items():
        check(span.count == counts[v], f"profile: label {v} seen "
                                       f"{span.count} times in {steps} "
                                       f"steps, expected {counts[v]}")

    n = 10_000
    t0 = time.perf_counter()
    for _ in range(n):
        with record_function(SPAN_TRANSPORT):
            pass
    label_us = (time.perf_counter() - t0) / n * 1e6

    busy = summary.busy_us
    return {"steps": steps, "label_counts": counts,
            "wall_ms_per_step": summary.window_us / steps / 1e3,
            "spans_per_step": {v: {"host_ms": s.host_us / steps / 1e3,
                                   "device_ms": s.device_us / steps / 1e3,
                                   "launches": s.launches / steps}
                               for v, s in spans.items()},
            "device_launches_per_step":
                sum(c for c, _ in summary.kernels.values()) / steps,
            "device_busy_ms_per_step": busy / steps / 1e3,
            "device_busy_share": busy / summary.window_us,
            "labelled_share_of_busy": sum(s.device_us for s in
                                          spans.values()) / busy,
            "label_us": label_us,
            "top_kernels_per_step": top_kernels(summary, steps, 5)}


def phase_profile(torch):
    """:func:`profile_quickstart` of the quickstart, then of the DP+secagg
    and MKD configs, the latter with the MKD rounds' own label (three of
    its ten profiled steps distill)."""
    from repro_torch.quickstart import extension_config

    emit("profile", config="quickstart", **profile_quickstart(torch))
    for name in ("dp_secagg", "mkd"):
        emit("profile", config=name,
             **profile_quickstart(torch, cfg=extension_config(name)))
