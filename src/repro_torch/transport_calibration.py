"""Sim-vs-real transport calibration on the port: same plans, both
backends. The port's copy of the JAX package's
``benchmarks/transport_calibration.py``, with the same rows.

    python -m repro_torch.transport_calibration [--smoke | --full]
        [--seed S] [--model-kb KB] [--device cuda|cpu]

For every registered aggregation technique (plus a MAR+MKD plan and an
int8-compressed MAR ladder) it runs the same per-round MessagePlan on
the discrete-event simulator and on real asyncio loopback TCP sockets,
and compares the two transcripts. The no-loss transcripts must be
**byte-exact** — the same ``total_bytes``, per-round and per-link
splits. Wall-clock is reported, not asserted. The frames carry real
tensors: a synthetic peer-stacked update made on ``--device`` (CUDA by
default) and int8-serialized exactly as the federation's socket path
serializes theta.

A second section runs the same plans over a two-rank address-book world
(``run_multiprocess``: spawned processes, fixed host:port endpoints,
cross-rank TCP) and gates the merged transcripts byte-exact against the
simulator too. Exit status is non-zero on any byte mismatch.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import topology
from repro_torch.core.aggregation import TECHNIQUES, build_pipeline
from repro_torch.core.moshpit import plan_grid
from repro_torch.figures import emit
from repro_torch.models.model import resolve_device
from repro_torch.runtime.socket_transport import (encode_state_payloads,
                                                  run_multiprocess)
from repro_torch.runtime.transport_base import build_transport

ORDER = ("fedavg", "hierarchical", "mar", "gossip", "rdfl", "ar")


def _transcripts(mplan, n, seed, payloads=None):
    sim = build_transport("sim", n, profile="uniform", seed=seed)
    sock = build_transport("socket", n, seed=seed)
    return sim.run(mplan), sock.run(mplan, payloads=payloads)


def _exact(a, b) -> bool:
    return (a.total_bytes == b.total_bytes
            and a.bytes_by_round == b.bytes_by_round
            and a.bytes_by_link == b.bytes_by_link)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--full", action="store_true",
                      help="4, 8 and 16 peers")
    mode.add_argument("--smoke", action="store_true", help="4 peers")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-kb", type=float, default=64.0,
                    help="state bytes per transfer, in KB")
    ap.add_argument("--device", default=None,
                    help="torch device of the payload tensors (default: "
                         "cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    peer_counts = (4,) if args.smoke else (4, 8)
    if args.full:
        peer_counts = (4, 8, 16)
    model_bytes = int(args.model_kb * 1000)

    techniques = [t for t in ORDER if t in TECHNIQUES] + \
        sorted(set(TECHNIQUES) - set(ORDER))
    failures = 0
    for n in peer_counts:
        plan = plan_grid(n)
        mask = np.ones(n, np.float32)
        # real tensors on the wire: a synthetic peer-stacked update on
        # the device, int8-serialized like the federation's socket path
        rng = np.random.default_rng(args.seed)
        payloads = encode_state_payloads({"w": torch.from_numpy(
            rng.normal(size=(n, 256, 16)).astype(np.float32)).to(device)})
        for tech in techniques:
            mplan = build_pipeline(tech, plan).message_plan(
                mask, model_bytes, n)
            tr_sim, tr_sock = _transcripts(mplan, n, args.seed, payloads)
            exact = _exact(tr_sock, tr_sim)
            failures += not exact
            emit("transport_calibration", technique=tech, n_peers=n,
                 messages=mplan.n_messages,
                 bytes_sim=int(tr_sim.total_bytes),
                 bytes_socket=int(tr_sock.total_bytes),
                 byte_exact=exact,
                 payload_bytes=int(tr_sock.payload_bytes),
                 sim_s=round(tr_sim.iteration_s, 6),
                 wall_s=round(tr_sock.iteration_s, 6),
                 wall_over_sim=round(
                     tr_sock.iteration_s / max(tr_sim.iteration_s, 1e-12),
                     3))

        # MKD prefix rounds ride the same transports
        mplan = build_pipeline("mar", plan).message_plan(
            mask, model_bytes, n, use_kd=True, kd_logit_bytes=1024)
        tr_sim, tr_sock = _transcripts(mplan, n, args.seed, payloads)
        kd_exact = (tr_sock.total_bytes == tr_sim.total_bytes
                    and tr_sock.kd_bytes == tr_sim.kd_bytes)
        failures += not kd_exact
        emit("transport_calibration", technique="mar+kd", n_peers=n,
             messages=mplan.n_messages,
             bytes_sim=int(tr_sim.total_bytes),
             bytes_socket=int(tr_sock.total_bytes),
             kd_bytes=int(tr_sock.kd_bytes), byte_exact=kd_exact,
             sim_s=round(tr_sim.iteration_s, 6),
             wall_s=round(tr_sock.iteration_s, 6))

        # compressed wire sizes shrink both backends identically
        mplan = build_pipeline("mar", plan, compress="int8_ef").message_plan(
            mask, model_bytes, n)
        tr_sim, tr_sock = _transcripts(mplan, n, args.seed, payloads)
        c_exact = tr_sock.total_bytes == tr_sim.total_bytes
        failures += not c_exact
        emit("transport_calibration", technique="mar+int8_ef", n_peers=n,
             bytes_sim=int(tr_sim.total_bytes),
             bytes_socket=int(tr_sock.total_bytes), byte_exact=c_exact,
             analytic=int(topology.iteration_bytes(
                 "mar", n, model_bytes, plan) / 4),
             sim_s=round(tr_sim.iteration_s, 6),
             wall_s=round(tr_sock.iteration_s, 6))

    # beyond loopback: the same plans over a two-rank address-book world
    # (spawned processes, fixed ports, cross-rank TCP); the merged
    # per-rank transcripts must match the simulator byte-exact
    mp_techs = ("mar", "ar", "fedavg")
    for n in peer_counts:
        plan = plan_grid(n)
        mask = np.ones(n, np.float32)
        plans = [build_pipeline(t, plan).message_plan(mask, model_bytes, n)
                 for t in mp_techs]
        merged = run_multiprocess(n, plans, world_size=2, seed=args.seed)
        sim = build_transport("sim", n, profile="uniform", seed=args.seed)
        for tech, mplan, tr_mp in zip(mp_techs, plans, merged):
            tr_sim = sim.run(mplan)
            exact = _exact(tr_mp, tr_sim)
            failures += not exact
            emit("transport_calibration", technique=tech + "+2proc",
                 n_peers=n, messages=mplan.n_messages,
                 bytes_sim=int(tr_sim.total_bytes),
                 bytes_socket=int(tr_mp.total_bytes), byte_exact=exact,
                 wall_s=round(tr_mp.iteration_s, 6))

    emit("transport_calibration", summary=True,
         peer_counts=str(peer_counts), byte_mismatches=failures)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
