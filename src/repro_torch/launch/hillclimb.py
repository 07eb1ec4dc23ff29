"""Hillclimb runner: the three chosen (arch x shape) pairs, each with a
ladder of hypotheses, over the dry run (``launch/dryrun.py``).

Port of the JAX package's ``repro/launch/hillclimb.py``, with the same
ladders (arch, shape, mesh and override kwargs); the rungs' hypotheses
name no hardware figure.

  A granite-8b  x train_4k (single-pod): the largest memory term and
     big TP collectives on a dense 8B: naive -> flash attention,
     one-shot MAR, microbatch ladder.
  B kimi-k2-1t  x train_4k (multi-pod): the worst memory fit (1T MoE):
     TP-only peers -> pod-peers + FSDP, f32 -> bf16 momentum.
  C xlstm-350m  x train_4k (single-pod): the most paper-like: a small
     model federated across many silos; TP=16 -> 256 pure-DP peers
     (MAR grid 4^4), one-shot fusion.

Each rung prints the three roofline terms and appends to a JSON log.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --pair A --out a.json
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback

from repro_torch.launch.dryrun import dryrun_cell

LADDERS = {
    "A": [
        ("A0 paper-faithful baseline: naive chunked attention "
         "(materialized probs), fp32 momentum",
         dict(arch_id="granite-8b", shape_id="train_4k", multi_pod=False,
              overrides={"attn_impl": "xla"})),
        ("A1 flash attention (recompute in the backward): "
         "hypothesis — kills O(s^2) prob traffic, memory term down >25%",
         dict(arch_id="granite-8b", shape_id="train_4k", multi_pod=False)),
        ("A2 + one-shot MAR (fuse 2 grid rounds into 1 global AR): "
         "hypothesis — MAR collective bytes down ~2x(M-1)/M -> (N-1)/N, "
         "small because TP dominates collectives",
         dict(arch_id="granite-8b", shape_id="train_4k", multi_pod=False,
              one_shot=True)),
        ("A3 + fewer microbatches (n_micro 8->4, mb 2->4): hypothesis — "
         "fewer per-micro layout passes; live activations still within "
         "one card's memory",
         dict(arch_id="granite-8b", shape_id="train_4k", multi_pod=False,
              one_shot=True, n_micro=4)),
        ("A4 + bf16 momentum: hypothesis — optimizer/MAR traffic and "
         "state memory down ~1.7x on the (theta,m) pair",
         dict(arch_id="granite-8b", shape_id="train_4k", multi_pod=False,
              one_shot=True, n_micro=4, momentum_dtype="bfloat16")),
        ("A5 A3 + remat off: hypothesis — drop recompute, compute -20%; "
         "expect memory blow-up (kept for the record, reverted)",
         dict(arch_id="granite-8b", shape_id="train_4k", multi_pod=False,
              one_shot=True, n_micro=4, overrides={"remat": "none"})),
    ],
    "B": [
        ("B0 baseline: peers=(pod,data) -> 32 peers, TP-only sharding "
         "inside a peer: hypothesis — 1T params cannot fit 16 chips/peer",
         dict(arch_id="kimi-k2-1t-a32b", shape_id="train_4k",
              multi_pod=True)),
        ("B1 peers=(pod,) -> 2 pod-peers with FSDP over data(16) + "
         "TP(16): hypothesis — state/chip drops 16x; fp32 momentum "
         "still holds most of a card's memory",
         dict(arch_id="kimi-k2-1t-a32b", shape_id="train_4k",
              multi_pod=True, peer_axes=("pod",))),
        ("B2 + bf16 momentum: hypothesis — state/chip down by a third "
         "(m from 4 to 2 bytes a parameter), within one card's memory "
         "with high n_micro",
         dict(arch_id="kimi-k2-1t-a32b", shape_id="train_4k",
              multi_pod=True, peer_axes=("pod",),
              momentum_dtype="bfloat16")),
        ("B3 + n_micro=32: hypothesis — activation temp floor down, "
         "fit margin restored; terms per-step unchanged to first order",
         dict(arch_id="kimi-k2-1t-a32b", shape_id="train_4k",
              multi_pod=True, peer_axes=("pod",),
              momentum_dtype="bfloat16", n_micro=32)),
    ],
    "C": [
        ("C0 baseline: 16 peers x TP16 for a 350M model: hypothesis — "
         "TP collectives drown compute (sub-3% MFU)",
         dict(arch_id="xlstm-350m", shape_id="train_4k",
              multi_pod=False)),
        ("C1 peers=(data,model) -> 256 pure-DP peers, MAR grid 4^4, "
         "no TP: hypothesis — only MAR collectives remain; collective "
         "term down >5x (the paper's regime: small model, many peers)",
         dict(arch_id="xlstm-350m", shape_id="train_4k", multi_pod=False,
              peer_axes=("data", "model"))),
        ("C2 + one-shot MAR (4 rounds -> 1 global AR): hypothesis — "
         "MAR bytes 4*(3/4) -> (255/256), ~3x fewer collective bytes",
         dict(arch_id="xlstm-350m", shape_id="train_4k", multi_pod=False,
              peer_axes=("data", "model"), one_shot=True)),
        ("C3 C1 + bf16 momentum: hypothesis — MAR operand bytes down "
         "~1.7x vs C1 (theta bf16 + m bf16 instead of f32)",
         dict(arch_id="xlstm-350m", shape_id="train_4k", multi_pod=False,
              peer_axes=("data", "model"), momentum_dtype="bfloat16")),
        ("C4 C1 + bf16 comm_dtype (delta compression on the wire): "
         "hypothesis — the group-mean reduce upcasts to f32 BEFORE the "
         "collective, so momentum dtype alone cannot shrink wire bytes; "
         "casting the reduce operand itself halves MAR collective bytes",
         dict(arch_id="xlstm-350m", shape_id="train_4k", multi_pod=False,
              peer_axes=("data", "model"), momentum_dtype="bfloat16",
              comm_dtype="bfloat16")),
    ],
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pair", choices=list(LADDERS) + ["all"],
                    default="all")
    ap.add_argument("--out", default="hillclimb.json")
    args = ap.parse_args(argv)

    pairs = list(LADDERS) if args.pair == "all" else [args.pair]
    records = []
    for pair in pairs:
        for label, kw in LADDERS[pair]:
            print(f"\n=== {label}")
            try:
                rec = dryrun_cell(verbose=True, **kw)
            except Exception as e:
                traceback.print_exc()
                rec = {"status": "FAILED",
                       "error": f"{type(e).__name__}: {e}"}
            rec["label"] = label
            rec["pair"] = pair
            records.append(rec)
            with open(args.out, "w") as f:
                json.dump(records, f, indent=1)
    print(f"\nwrote {len(records)} records -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
