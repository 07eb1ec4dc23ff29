"""Quickstart: train a 27-peer MAR-FL federation on the text task.

The port's counterpart of ``examples/quickstart.py``: FederationConfig
-> Federation -> step/evaluate, the MAR grid behind it, and the
communication ledger, with every MAR round's group mean in the CUDA
kernel. Runs on the GPU by default:

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

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


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain group mean in place of the kernel)")
    ap.add_argument("--iterations", type=int, default=20)
    args = ap.parse_args(argv)

    fed = Federation(quickstart_config(), device=args.device)
    print(f"MAR grid: {fed.plan.dims} (exact={fed.plan.is_exact}), "
          f"model bytes={fed.model_bytes:,}, device={fed.device}")
    state = fed.init_state()
    for t in range(args.iterations):
        state = fed.step(state)
        if (t + 1) % 5 == 0:
            print(f"iter {t+1:3d}: acc={fed.evaluate(state):.3f} "
                  f"comm={fed.comm_bytes/1e6:,.0f} MB "
                  f"peer-disagreement={fed.peer_disagreement(state):.2e}")
    print("\nEvery peer holds the collaboratively trained global model "
          "(Alg. 1 returns theta^T).")


if __name__ == "__main__":
    main()
