"""Quickstart: train a 27-peer MAR-FL federation on the text task.

The port's counterpart of ``examples/quickstart.py``: FederationConfig
-> Federation -> step/evaluate, the MAR grid behind it, and the
communication ledger, with every MAR round's group mean in the CUDA
kernel. Runs on the GPU by default:

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
        [--extension mkd|dp|dp_secagg|int8_ef|async|composed|elastic]

``--extension`` runs the same federation under one of the paper's
protocol extensions (:data:`EXTENSIONS`).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, Optional, Sequence

from repro_torch.core.federation import Federation, FederationConfig


def quickstart_config(kernel_group_mean: bool = True) -> FederationConfig:
    return FederationConfig(
        n_peers=27,          # 27 = 3^3 -> exact MAR grid, 3 rounds of size 3
        technique="mar",
        task="text",         # 20-class frozen-encoder features (20NG analogue)
        local_batches=2,     # B local Momentum-SGD steps per FL iteration
        lr=0.1, momentum=0.9,
        kernel_group_mean=kernel_group_mean,
    )


#: the quickstart under each protocol extension: Moshpit-KD (Alg. 2/3),
#: DP with adaptive clipping (Alg. 4), the same with the clipping
#: indicator securely aggregated (§A.2), int8 error feedback, staleness-1
#: async, all of them at once, and elastic membership (27 -> 13 -> 26
#: peers under iid churn)
EXTENSIONS: Dict[str, Dict[str, Any]] = {
    "mkd": dict(use_kd=True, kd_iterations=6),
    "dp": dict(use_dp=True, noise_multiplier=0.3),
    "dp_secagg": dict(use_dp=True, noise_multiplier=0.3, use_secagg=True),
    "int8_ef": dict(compress="int8_ef"),
    "async": dict(async_aggregation=True),
    "composed": dict(use_kd=True, kd_iterations=6, use_dp=True,
                     noise_multiplier=0.3, use_secagg=True,
                     compress="int8_ef", async_aggregation=True),
    "elastic": dict(resize_schedule=((7, 13), (14, 26)),
                    participation_rate=0.9, dropout_rate=0.1),
}


def extension_config(name: str,
                     kernel_group_mean: bool = True) -> FederationConfig:
    return dataclasses.replace(quickstart_config(kernel_group_mean),
                               **EXTENSIONS[name])


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain group mean in place of the kernel)")
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--extension", choices=sorted(EXTENSIONS), default=None)
    args = ap.parse_args(argv)

    cfg = (quickstart_config() if args.extension is None
           else extension_config(args.extension))
    fed = Federation(cfg, device=args.device)
    print(f"MAR grid: {fed.plan.dims} (exact={fed.plan.is_exact}), "
          f"model bytes={fed.model_bytes:,}, device={fed.device}")
    state = fed.init_state()
    for t in range(args.iterations):
        state = fed.step(state)
        if (t + 1) % 5 == 0:
            print(f"iter {t+1:3d}: acc={fed.evaluate(state):.3f} "
                  f"comm={fed.comm_bytes/1e6:,.0f} MB "
                  f"peers={fed.cfg.n_peers} "
                  f"peer-disagreement={fed.peer_disagreement(state):.2e}")
    print("\nEvery peer holds the collaboratively trained global model "
          "(Alg. 1 returns theta^T).")


if __name__ == "__main__":
    main()
