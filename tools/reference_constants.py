#!/usr/bin/env python3
"""Compute, from the JAX reference on the CPU, the constants that
``chip_smoke.py`` and the port's tests hold the port to.

    JAX_PLATFORMS=cpu PYTHONPATH=src:. python3 tools/reference_constants.py \
        [extensions] [figures] [train_cli] [train_chip] [large_n]
        [train_recurrent] [train_cli_large_n] [figures_ext] [socket]
        [train_cli_ranks]

For each protocol extension of the quickstart
(``repro_torch.quickstart.EXTENSIONS``: 27 peers, text task, two local
batches, 20 iterations, the group-mean kernel on) it runs the
reference's ``Federation`` at seeds 0, 1 and 2 and prints one JSON line:
``comm_bytes`` and ``sim_seconds`` after 20 iterations (seed 0, the
seed the port runs) and the test accuracy at iteration 20 for each
seed. Then it runs the reference's figure scripts
(``benchmarks/fig{1_perf_gap,2_mkd,3_churn,4_dp,5_parity}.py``) at the
smoke scale (8 peers, 6 iterations, one local batch) for seeds 0, 1 and
2 and prints each row's ``comm_mb`` and ``sim_s`` (seed 0) and the
largest spread of any row's accuracy over the seeds. Last, the LM
trainer's communication ledger (``repro.launch.train``): the comm-total
line of each CPU CLI case the port's tests run (``TRAIN_CLI_CASES``, at
the smoke configs), and the ledger's total bytes of the chip's full-width
musicgen-medium run (4 peers, 6 steps), computed from
``core/topology.py`` over ``jax.eval_shape`` of the FL state without
building the model. Then the large-N federation runs of
``chip_smoke.py``'s ``federation_large_n`` phase (``LARGE_N_RUNS``: the
text model at N = 125 under adaptive group sizing on each transport, and
clustered placement at N = 64, 20 iterations): the ledger by source,
``sim_seconds``, ``regroup_log`` and ``placement_log`` at seed 0 and
the accuracy at iteration 20 for seeds 0-2; the full-width zamba2-2.7b
and xlstm-350m trainer ledgers (``TRAIN_RECURRENT``, 4 peers, 6 steps);
and the regroup and comm-total lines of the trainer's large-N CLI cases
(``TRAIN_CLI_LARGE_N``). Then Figs. 8 and 11
(``benchmarks/fig{8_noniid,11_approx_agg}.py``) at the smoke scale for
seeds 0-2: each row's fields at seed 0 and the largest spread of a
row's accuracy over the seeds. Then the quickstart over the socket
transport under injected loss (``SOCKET_LOSSY``, 20 iterations): each
iteration's lost senders, the ledger by source and ``comm_bytes`` at
seed 0, and the accuracy at 20 for seeds 0-2 (the socket's loss draws
depend only on the seed and the iteration). Last, the comm-total line
of each rank of the trainer's two-rank socket world
(``TRAIN_CLI_BASE`` plus ``--transport socket --peer-hosts BOOK --rank
R``, two processes on a loopback book). Wall-clock seconds print as
``comm_s=<wall>`` (``chip_smoke.wall_masked``). Needs jax; takes
several minutes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SMOKE = dict(peers=8, iters=6, eval_every=3, local_batches=1)
FIGS = ("fig1_perf_gap", "fig2_mkd", "fig3_churn", "fig4_dp", "fig5_parity")
FIGS_EXT = ("fig8_noniid", "fig11_approx_agg")
#: the archs of the LM trainer's CLI cases (chip_smoke.TRAIN_CLI_CASES)
TRAIN_CLI_ARCHS = ("starcoder2-3b", "musicgen-medium")
#: the chip's full-width run: chip_smoke.py's train phase (TRAIN_ARGS)
TRAIN_CHIP = dict(arch="musicgen-medium", peers=4, steps=6)


def extension_runs(iterations: int = 20) -> None:
    from repro.core.federation import Federation, FederationConfig

    from repro_torch.quickstart import EXTENSIONS, quickstart_config

    base = {f.name: getattr(quickstart_config(), f.name)
            for f in dataclasses.fields(quickstart_config())}
    base["pallas_group_mean"] = base.pop("kernel_group_mean")
    for name, kw in EXTENSIONS.items():
        out = {"extension": name, "accuracy_by_seed": []}
        for seed in (0, 1, 2):
            fed = Federation(FederationConfig(**{**base, **kw,
                                                 "seed": seed}))
            state = fed.init_state()
            for _ in range(iterations):
                state = fed.step(state)
            out["accuracy_by_seed"].append(fed.evaluate(state))
            if seed == 0:
                out.update(comm_bytes=fed.comm_bytes,
                           sim_seconds=fed.sim_seconds,
                           n_peers_end=fed.cfg.n_peers)
        print(json.dumps(out), flush=True)


def _rows(seed: int, figs=FIGS):
    rows = []
    for f in figs:
        mod = importlib.import_module("benchmarks." + f)
        mod.scale = lambda full, smoke=False: dict(SMOKE)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(["--seed", str(seed)]
                     + (["--smoke"] if f == "fig3_churn" else []))
        for line in buf.getvalue().splitlines():
            if line.startswith("fig") and not line.startswith(
                    "fig1_scaling"):
                name, *kv = line.split(",")
                rows.append((name, dict(x.split("=", 1) for x in kv)))
    return rows


def figure_rows() -> None:
    runs = [_rows(seed) for seed in (0, 1, 2)]
    spread = 0.0
    for by_seed in zip(*runs):
        accs = [float(f.get("final_acc", f.get("acc", "nan")))
                for _, f in by_seed]
        if all(a == a for a in accs):
            spread = max(spread, max(accs) - min(accs))
    print(json.dumps({"figure_rows": [
        [name] + [f.get(k) for k in ("comm_mb", "sim_s")]
        for name, f in runs[0]], "max_accuracy_spread": spread}),
        flush=True)


def figures_ext_rows() -> None:
    runs = [_rows(seed, FIGS_EXT) for seed in (0, 1, 2)]
    spread = max(
        max(accs) - min(accs) for accs in (
            [float(f["final_acc"]) for _, f in by_seed]
            for by_seed in zip(*runs) if "final_acc" in by_seed[0][1]))
    print(json.dumps({"figures_ext_rows": runs[0],
                      "max_accuracy_spread": spread}), flush=True)


def comm_line(out: str) -> str:
    """The ``[train] comm total=...`` line of a trainer's output, its
    wall-clock seconds masked."""
    from chip_smoke import wall_masked

    return wall_masked(next(ln for ln in out.splitlines()
                            if ln.startswith("[train] comm total=")))


def train_cli_lines() -> None:
    from chip_smoke import TRAIN_CLI_BASE, TRAIN_CLI_CASES
    from repro.launch import train

    lines = {}
    for arch in TRAIN_CLI_ARCHS:
        for name, extra in TRAIN_CLI_CASES.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                train.main(["--arch", arch, *TRAIN_CLI_BASE, *extra])
            lines[f"{arch} {name}"] = comm_line(buf.getvalue())
    print(json.dumps({"train_cli_comm": lines}), flush=True)


def _train_ledger(arch: str, peers: int, steps: int) -> dict:
    """The trainer's ledger after ``steps`` full-participation steps of
    ``arch`` at full width, from ``jax.eval_shape`` of the FL state."""
    import jax

    from repro.configs.registry import get_config
    from repro.core import topology
    from repro.core.aggregation import CommLedger, build_pipeline
    from repro.core.fl_device import init_fl_state
    from repro.core.moshpit import plan_grid
    from repro.models.model import Model

    model = Model(get_config(arch))
    shape = jax.eval_shape(
        lambda: init_fl_state(model, peers, jax.random.PRNGKey(0)))
    peer_model_bytes = (topology.pytree_bytes(shape["params"])
                        + topology.pytree_bytes(shape["momentum"])
                        ) // peers
    grid = plan_grid(peers)
    pipeline = build_pipeline("mar", grid, backend="device")
    ledger = CommLedger()
    for _ in range(steps):
        pipeline.record_iteration(ledger, peers, peer_model_bytes)
    return {"arch": arch, "peers": peers, "steps": steps,
            "grid": list(grid.dims), "peer_model_bytes": peer_model_bytes,
            "params": model.cfg.param_count(),
            "comm_total_bytes": ledger.total_bytes}


def train_chip_bytes() -> None:
    print(json.dumps({"train_chip": _train_ledger(
        TRAIN_CHIP["arch"], TRAIN_CHIP["peers"], TRAIN_CHIP["steps"])}),
        flush=True)


def train_recurrent_bytes() -> None:
    from chip_smoke import TRAIN_RECURRENT

    for arch in TRAIN_RECURRENT:
        print(json.dumps({"train_recurrent": _train_ledger(arch, 4, 6)}),
              flush=True)


def large_n_runs(iterations: int = 20) -> None:
    from chip_smoke import LARGE_N_RUNS
    from repro.core.federation import Federation, FederationConfig

    for name, kw in LARGE_N_RUNS.items():
        out = {"run": name, "accuracy_by_seed": []}
        for seed in (0, 1, 2):
            fed = Federation(FederationConfig(**kw, seed=seed))
            state = fed.init_state()
            for _ in range(iterations):
                state = fed.step(state)
            out["accuracy_by_seed"].append(fed.evaluate(state))
            if seed == 0:
                out.update(comm_bytes=fed.comm_bytes,
                           sim_seconds=fed.sim_seconds,
                           by_source=dict(fed.ledger.by_source),
                           regroup_log=fed.regroup_log,
                           placement_log=fed.placement_log)
        print(json.dumps(out), flush=True)


def train_cli_large_n_lines() -> None:
    from chip_smoke import (TRAIN_CLI_LARGE_N, TRAIN_CLI_LARGE_N_BASE,
                            TRAIN_CLI_LARGE_N_SCHEDULE)
    from repro.core import adaptive
    from repro.launch import train

    real = adaptive.build_controller
    lines = {}
    for name, (flags, _) in TRAIN_CLI_LARGE_N.items():
        if name == "schedule":     # the scripted controller, as the tests
            adaptive.build_controller = (
                lambda n, plan, **kw: real(
                    n, plan, schedule=TRAIN_CLI_LARGE_N_SCHEDULE, **kw))
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                train.main([*TRAIN_CLI_LARGE_N_BASE, *flags])
        finally:
            adaptive.build_controller = real
        lines[name] = [ln for ln in buf.getvalue().splitlines()
                       if "regroup" in ln or ln.startswith("[train] comm")]
    print(json.dumps({"train_cli_large_n": lines}), flush=True)


def socket_runs(iterations: int = 20) -> None:
    from chip_smoke import SOCKET_LOSSY
    from repro.core.federation import Federation, FederationConfig

    from repro_torch.quickstart import quickstart_config

    base = {f.name: getattr(quickstart_config(), f.name)
            for f in dataclasses.fields(quickstart_config())}
    base["pallas_group_mean"] = base.pop("kernel_group_mean")
    out = {"run": "socket_lossy", "accuracy_by_seed": []}
    for seed in (0, 1, 2):
        fed = Federation(FederationConfig(**{**base, **SOCKET_LOSSY,
                                             "seed": seed}))
        state = fed.init_state()
        lost = []       # each iteration's lost senders as a bit mask
        for _ in range(iterations):
            state = fed.step(state)
            lost.append(sum(1 << int(i) for i in np.flatnonzero(
                fed.last_transcript.lost_senders)))
        out["accuracy_by_seed"].append(fed.evaluate(state))
        if seed == 0:
            out.update(comm_bytes=fed.comm_bytes,
                       by_source=dict(fed.ledger.by_source),
                       lost_senders=lost)
    print(json.dumps(out), flush=True)


def train_cli_rank_lines(arch: str = "starcoder2-3b") -> None:
    """The reference's two-rank socket trainer: two processes on one
    loopback book, each printing its rank's comm-total line."""
    import os
    import subprocess
    import tempfile

    from chip_smoke import TRAIN_CLI_BASE
    from repro.runtime.socket_transport import AddressBook

    with tempfile.TemporaryDirectory() as tmp:
        book = os.path.join(tmp, "book.json")
        AddressBook.loopback(4, world_size=2).to_json(book)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro.launch.train", "--arch", arch,
             *TRAIN_CLI_BASE, "--transport", "socket", "--peer-hosts", book,
             "--rank", str(r)], env=env, stdout=subprocess.PIPE, text=True)
            for r in (0, 1)]
        outs = [p.communicate(timeout=600)[0] for p in procs]
    if any(p.returncode for p in procs):
        raise RuntimeError(f"a rank failed: {[p.returncode for p in procs]}")
    print(json.dumps({"train_cli_ranks": {arch: [comm_line(o)
                                                 for o in outs]}}),
          flush=True)


def main() -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    only = sys.argv[1:]
    for name, fn in (("extensions", extension_runs),
                     ("figures", figure_rows),
                     ("train_cli", train_cli_lines),
                     ("train_chip", train_chip_bytes),
                     ("large_n", large_n_runs),
                     ("train_recurrent", train_recurrent_bytes),
                     ("train_cli_large_n", train_cli_large_n_lines),
                     ("figures_ext", figures_ext_rows),
                     ("socket", socket_runs),
                     ("train_cli_ranks", train_cli_rank_lines)):
        if not only or name in only:
            fn()


if __name__ == "__main__":
    main()
