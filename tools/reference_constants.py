#!/usr/bin/env python3
"""Compute, from the JAX reference on the CPU, the constants that
``chip_smoke.py`` and the port's tests hold the port to.

    JAX_PLATFORMS=cpu PYTHONPATH=src:. python3 tools/reference_constants.py

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
largest spread of any row's accuracy over the seeds. Needs jax; takes a
few minutes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SMOKE = dict(peers=8, iters=6, eval_every=3, local_batches=1)
FIGS = ("fig1_perf_gap", "fig2_mkd", "fig3_churn", "fig4_dp", "fig5_parity")


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


def _rows(seed: int):
    rows = []
    for f in FIGS:
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


def main() -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    extension_runs()
    figure_rows()


if __name__ == "__main__":
    main()
