"""The MAR-FL trainer for the LM architectures, every peer on one
card.

Port of the JAX package's ``repro/launch/train.py`` with the same flags,
defaults and printed lines, plus ``--device``. It integrates the config
registry, the synthetic LM stream, the device-backend MAR-FL step
(``core/fl_device.py``: the peers stacked on a leading axis of every
leaf, the state updated in place), checkpoint and elastic resume, and
the churn-aware peer lifecycle (``runtime/lifecycle.py``): per-step
participation masks come from a ``--churn`` scenario, measured step
durations feed the ``HealthTracker`` heartbeats, and the per-iteration
sweep masks peers that stop heartbeating. ``--link-profile`` (or
``--transport sim``) unrolls the aggregation traffic into per-round
messages and times them over modeled links; the ledger and the
per-step communication seconds then come from the transcript, and lost
sends (``--link-loss``) demote their peer to receiver-only for that
step. ``--transport vector_sim`` and ``super_sim`` are the large-N
engines, with the same transcripts. ``--transport socket`` really sends
the messages over loopback TCP, one asyncio task per peer, each frame
carrying the peer's int8-serialized theta (copied from the card once a
step); with ``--peer-hosts BOOK --rank R`` this process is rank R of a
multi-process world and runs only the book's nodes of rank R, on their
fixed ports (its ledger bills what its nodes receive). ``--adaptive-m``
(a group-size controller, exact grids only) and ``--placement`` (a
topology-aware peer-to-slot policy, which probes the links through the
live transport and bills the probes as ``placement_probe``) watch each
step's transcript and regroup the grid in place: the pipeline re-binds
and the train step is rebuilt, the state untouched.

Permanent membership changes (``--resize-at``, trace join/leave events)
route through :class:`~repro_torch.core.replan.MembershipChange`:
survivors' state maps bit-exact, joiners bootstrap from the group mean,
the train step is rebuilt for the new grid, and the run goes on. The
whole planned schedule is validated at launch (every target peer count
must have an exact grid).

The run is on CUDA (raising where there is none) unless ``--device``
names another device. Every family trains on the card: the ssm and
hybrid families' scans launch the SSD-scan kernel forward and take the
plain chunked scan's VJP backward, as the reference does.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
      --smoke --steps 20 --peers 4 --device cpu --ckpt-dir ckpts
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
      --smoke --steps 10 --peers 4 --device cpu --churn sessions
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
      --smoke --steps 8 --peers 16 --device cpu --resize-at 4:9
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
      --smoke --steps 8 --peers 27 --device cpu --link-profile wireless \\
      --transport vector_sim --adaptive-m tail_aware
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
      --smoke --steps 3 --peers 4 --device cpu --transport socket \\
      --peer-hosts book.json --rank 0     # and --rank 1, same book
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch musicgen-medium --peers 4 --steps 6     # full width, GPU
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch zamba2-2.7b --peers 4 --steps 6         # full width, GPU
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.registry import ARCH_IDS, get_config, \
    get_smoke_config
from repro_torch.core import topology
from repro_torch.core.adaptive import (CONTROLLERS, build_controller,
                                      observe_regroups)
from repro_torch.core.aggregation import CommLedger, build_pipeline
from repro_torch.core.fl_device import (apply_membership, init_fl_state,
                                        make_fl_train_step)
from repro_torch.core.moshpit import GridPlan, plan_grid
from repro_torch.core.placement import PLACEMENTS, build_placement
from repro_torch.core.replan import (plan_membership_change,
                                     validate_membership_schedule)
from repro_torch.data.synthetic import lm_token_stream
from repro_torch.models.model import Model, resolve_device
from repro_torch.runtime.fault import HealthTracker, StragglerPolicy
from repro_torch.runtime.lifecycle import CHURN_MODELS, build_lifecycle
from repro_torch.runtime.metrics import MetricsLogger
from repro_torch.runtime.socket_transport import (AddressBook,
                                                  encode_state_payloads)

#: what ``on_step`` receives after every step
StepHook = Callable[[Dict[str, Any]], None]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--peers", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--batch", type=int, default=2, help="per peer")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--one-shot", action="store_true")
    ap.add_argument("--compress", choices=["int8_ef"], default=None,
                    help="int8 error-feedback delta compression on the "
                         "aggregation wire")
    ap.add_argument("--comm-dtype", default=None,
                    help="wire dtype of the cross-peer reduce "
                         "(e.g. bfloat16)")
    ap.add_argument("--participation", type=float, default=1.0,
                    help="per-step peer participation rate (churn mask)")
    ap.add_argument("--churn", choices=sorted(CHURN_MODELS), default=None,
                    help="peer-lifecycle scenario; default is i.i.d. "
                         "Bernoulli driven by --participation/--dropout")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="per-step aggregation-dropout rate (bernoulli)")
    ap.add_argument("--churn-trace", default=None,
                    help="membership trace file for --churn trace")
    ap.add_argument("--adaptive-m", default=None,
                    help="adaptive group sizing (core/adaptive.py): a "
                         "GroupSizeController name (static | "
                         "tail_aware | schedule) consuming each step's "
                         "transport transcript; proposals regroup the "
                         "MAR grid in place (exact factorizations "
                         "only — the device backend needs capacity == "
                         "N). Requires a transport (--transport / "
                         "--link-profile) for the transcript signal")
    ap.add_argument("--placement", default=None,
                    help="topology-aware grid placement "
                         "(core/placement.py): a PlacementPolicy name "
                         "(identity | random | clustered). 'clustered' "
                         "learns network regions from link evidence "
                         "(probe rounds through the live transport) "
                         "and regroups the grid so each region fills "
                         "contiguous coordinates. Composes with "
                         "--adaptive-m. Requires a transport "
                         "(--transport / --link-profile)")
    ap.add_argument("--link-shuffle", action="store_true",
                    help="scatter the regions profile's region "
                         "assignment over peer indices (peers joined "
                         "in arbitrary order) — the misaligned layout "
                         "--placement clustered exists to fix")
    ap.add_argument("--health-timeout", type=float, default=30.0,
                    help="iterations without a heartbeat before a peer "
                         "is marked dead")
    ap.add_argument("--resize-at", default=None, metavar="STEP:N[,..]",
                    help="scheduled permanent resizes, e.g. '4:9' or "
                         "'3:6,7:8' — at each STEP the fleet becomes N "
                         "peers in place (survivors bit-exact, joiners "
                         "bootstrap from the group mean, the train step "
                         "rebuilt for the new grid). Every N needs an "
                         "exact grid; the whole schedule is validated "
                         "at launch")
    ap.add_argument("--transport", default=None,
                    help="MessagePlan executor backend "
                         "(runtime/transport_base.py): 'sim' models "
                         "messages over --link-profile links; "
                         "'vector_sim' is the batched segment-op "
                         "engine with identical transcripts (use for "
                         "large --peers); 'super_sim' adds closed-"
                         "form intra-cluster tiers on top (identical "
                         "transcripts on uniform/wireless); 'socket' "
                         "runs every peer as an asyncio task on "
                         "loopback TCP and really transmits "
                         "int8-serialized update tensors. Default: "
                         "'sim' when --link-profile is given, else no "
                         "transport (analytic accounting)")
    ap.add_argument("--link-profile", default=None,
                    choices=["uniform", "wireless", "regions"],
                    help="discrete-event link model for the sim "
                         "transport: aggregation traffic is unrolled "
                         "into messages, timed over per-peer modeled "
                         "links, and the ledger + per-step simulated "
                         "wall-clock come from the transcript")
    ap.add_argument("--link-loss", type=float, default=0.0,
                    help="per-message loss probability on the modeled "
                         "links (or injected send failures on the "
                         "socket transport); a peer whose send is "
                         "lost mid-round is demoted to receiver-only "
                         "for that step")
    ap.add_argument("--peer-hosts", default=None, metavar="FILE",
                    help="JSON address book for the socket transport "
                         "(multi-host mode): fixed host:port per plan "
                         "node plus the owning rank — this process "
                         "runs only its --rank's nodes; start one "
                         "process per rank with the same book")
    ap.add_argument("--rank", type=int, default=0,
                    help="this process's rank in the --peer-hosts "
                         "world (default 0)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--metrics", default=None, help="JSONL metrics path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions of the kernels)")
    return ap


def _check_transport(ap: argparse.ArgumentParser, args) -> None:
    if args.transport is not None:
        from repro_torch.runtime.transport_base import available_transports
        names = available_transports()
        if args.transport not in names:
            ap.error(f"--transport must be one of {names}, "
                     f"got {args.transport!r}")
    if args.peer_hosts and args.transport != "socket":
        ap.error("--peer-hosts is the socket transport's address "
                 "book; pass --transport socket")


def _regroup(t: int, transcript, grid: GridPlan, pipeline, step_fn,
             model: Model, lr: float, controller, placement_policy):
    """The controllers' same-N regroups after step ``t``
    (``core/adaptive.observe_regroups``): each re-binds the pipeline and
    rebuilds the train step; the state is untouched (the peer axis does
    not change). Returns the (grid, pipeline, step_fn) in force for the
    next step."""
    for new_grid, log, entry in observe_regroups(
            t, transcript, grid, controller, placement_policy):
        if log == "regroup":
            print(f"[train] adaptive-M regroup at step {t+1}: "
                  f"{grid.dims} -> {new_grid.dims}")
        else:
            print(f"[train] placement regroup at step {t+1}: "
                  f"{entry[1]}/{grid.n_peers} peers moved")
        grid = new_grid
        pipeline = pipeline.with_plan(grid)
        step_fn = make_fl_train_step(model, grid, lr=lr, pipeline=pipeline)
    return grid, pipeline, step_fn


def main(argv=None, on_step: Optional[StepHook] = None) -> int:
    """Run the trainer. ``on_step`` (for callers that drive it in
    process) receives, after every step, a dict with ``t`` (the step
    index), ``state``, ``metrics``, ``seconds``, ``step_fn``, ``batch``
    and ``ledger``."""
    ap = _parser()
    args = ap.parse_args(argv)
    _check_transport(ap, args)
    resize_schedule = []
    if args.resize_at:
        try:
            for part in args.resize_at.split(","):
                step_s, n_s = part.split(":")
                resize_schedule.append((int(step_s), int(n_s)))
        except ValueError:
            ap.error(f"--resize-at must be STEP:N[,STEP:N...], "
                     f"got {args.resize_at!r}")

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg)
    n_peers = args.peers
    grid = plan_grid(n_peers)
    print(f"[train] arch={cfg.name} peers={n_peers} "
          f"grid={grid.dims} params={cfg.param_count():,}")

    pipeline = build_pipeline("mar", grid, backend="device",
                              one_shot=args.one_shot,
                              comm_dtype=args.comm_dtype,
                              compress=args.compress)
    if pipeline.stage_names:
        print(f"[train] wire stages: {', '.join(pipeline.stage_names)}")
    step_fn = make_fl_train_step(model, grid, lr=args.lr, pipeline=pipeline)

    state = init_fl_state(model, n_peers, seed=args.seed, device=device,
                          pipeline=pipeline)
    ledger = CommLedger()
    peer_model_bytes = (topology.pytree_bytes(state["params"])
                        + topology.pytree_bytes(state["momentum"])
                        ) // n_peers
    start = 0
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume and ckpt.latest_step() is not None:
        state, meta = ckpt.restore_elastic(n_peers, like=state)
        start = meta.get("step", 0)
        print(f"[train] resumed from step {start} "
              f"(was {meta.get('n_peers')} peers)")

    stream = lm_token_stream(cfg.vocab_size, n_peers * args.local_steps
                             * args.batch, args.seq, seed=args.seed)
    # lifecycle: scenario masks + health heartbeats/sweeps + deadlines.
    # The lifecycle clock is the step counter, so --health-timeout is
    # "steps without a heartbeat".
    churn_params = {}
    if args.churn == "trace":
        if not args.churn_trace:
            ap.error("--churn trace requires --churn-trace FILE")
        churn_params["path"] = args.churn_trace
    lifecycle = build_lifecycle(
        args.churn, n_peers, seed=args.seed,
        participation_rate=args.participation,
        dropout_rate=args.dropout, churn_params=churn_params,
        schedule=resize_schedule,
        health=HealthTracker(n_peers, timeout_s=args.health_timeout),
        straggler=StragglerPolicy())
    metrics_log = MetricsLogger(args.metrics)
    network = None
    transport = args.transport or ("sim" if args.link_profile else None)
    if transport is not None:
        from repro_torch.runtime.transport_base import (build_transport,
                                                        demote_lost_senders)
        link_params = {}
        if args.link_loss:
            link_params["loss"] = args.link_loss
        if args.link_shuffle:
            link_params["shuffle"] = True
        transport_kwargs = {}
        if args.peer_hosts:
            book = AddressBook.from_json(args.peer_hosts)
            print(f"[train] address book: {book.n_nodes} nodes over "
                  f"{book.world_size} ranks; this is rank {args.rank} "
                  f"(owns nodes {list(book.owned(args.rank))})")
            transport_kwargs["address_book"] = book
            transport_kwargs["rank"] = args.rank
        network = build_transport(
            transport, n_peers, profile=args.link_profile,
            seed=args.seed, link_params=link_params or None,
            **transport_kwargs)
    try:
        # the mask-free path needs a genuinely lossless transport too: the
        # regions profile carries per-tier loss even without --link-loss
        always_full = args.churn is None and args.participation >= 1.0 \
            and args.dropout <= 0.0 \
            and (network is None or network.lossless)

        # every planned permanent resize must have an exact grid: validate
        # the whole step range now, so an unreachable count fails at launch
        planned = lifecycle.planned_resizes(start, start + args.steps)
        if planned:
            validate_membership_schedule(grid, planned, exact_only=True)
            print("[train] elastic schedule: " + ", ".join(
                f"step {ts}: -> {n} peers" for ts, n in planned))

        controller = None
        if args.adaptive_m is not None:
            if args.adaptive_m not in CONTROLLERS:
                ap.error(f"--adaptive-m must be one of "
                         f"{sorted(CONTROLLERS)}, got {args.adaptive_m!r}")
            if network is None:
                ap.error("--adaptive-m needs a transcript signal: pass "
                         "--link-profile (sim) or --transport")
            controller = build_controller(args.adaptive_m, grid,
                                          exact_only=True)

        placement_policy = None
        if args.placement is not None:
            if args.placement not in PLACEMENTS:
                ap.error(f"--placement must be one of "
                         f"{sorted(PLACEMENTS)}, got {args.placement!r}")
            if network is None:
                ap.error("--placement needs a transport for link evidence "
                         "and probe rounds: pass --link-profile (sim) or "
                         "--transport")

            def run_probe(mplan):
                tr = network.run(mplan)
                ledger.record("placement_probe", tr.total_bytes)
                ledger.record_time(tr.iteration_s)
                return tr

            placement_policy = build_placement(args.placement, grid,
                                               seed=args.seed)
            placement_policy.bind_prober(run_probe)

        sync = (torch.cuda.synchronize if device.type == "cuda"
                else (lambda: None))
        for t in range(start, start + args.steps):
            tick = lifecycle.tick(t)
            if tick.resize_to is not None and tick.resize_to != n_peers:
                # permanent join/leave, in place: survivors bit-exact,
                # joiners group-mean-bootstrapped, the step rebuilt for the
                # new exact grid (validated at launch). No relaunch.
                change = plan_membership_change(
                    grid, tick.resize_to, iteration=t, exact_only=True)
                state, pipeline = apply_membership(state, change, pipeline)
                grid, n_peers = change.new_plan, change.new_n
                print(f"[train] elastic resize at step {t}: "
                      f"{change.old_n} -> {change.new_n} peers, "
                      f"grid={grid.dims} "
                      f"(+{change.n_joiners} joiners)")
                step_fn = make_fl_train_step(model, grid, lr=args.lr,
                                             pipeline=pipeline)
                stream = lm_token_stream(
                    cfg.vocab_size,
                    n_peers * args.local_steps * args.batch, args.seq,
                    seed=args.seed + t)
                if network is not None:
                    network.resize(n_peers)
                if controller is not None:
                    controller.rebind(grid)
                if placement_policy is not None:
                    placement_policy.rebind(grid)
            raw = next(stream)
            batch = {
                k: v.reshape(n_peers, args.local_steps, 1, args.batch,
                             args.seq)
                for k, v in raw.items()
            }
            u, a = tick.u, tick.a
            # modeled network: time this step's messages first so lost
            # sends demote their peer before the aggregation runs
            transcript = None
            if network is not None:
                n_act = int(a.sum())
                mplan = pipeline.message_plan(np.asarray(a), peer_model_bytes,
                                              n_act)
                payloads = (encode_state_payloads(state["params"])
                            if network.wants_payloads else None)
                transcript = network.run(mplan, payloads=payloads)
                a = demote_lost_senders(a, u, transcript)
            sync()
            t0 = time.time()
            if always_full:
                state, metrics = step_fn(state, batch)
            else:
                # U_t gates the local-update carry, A_t the aggregation — a
                # straggler keeps its update but misses its group mean
                state, metrics = step_fn(state, batch, torch.as_tensor(u),
                                         torch.as_tensor(a))
            loss = float(metrics["loss"])
            sync()
            dt = time.time() - t0
            if transcript is not None:
                pipeline.record_transcript(ledger, transcript, n_act,
                                           peer_model_bytes)
                # heartbeat with compute + each peer's simulated comm
                # finish: slow modeled uplinks surface as stragglers via
                # the lifecycle's deadline policy next iteration
                lifecycle.observe_durations(
                    t, dt + transcript.peer_finish_s, mask=u)
                grid, pipeline, step_fn = _regroup(
                    t, transcript, grid, pipeline, step_fn, model, args.lr,
                    controller, placement_policy)
            else:
                pipeline.record_iteration(ledger, int(a.sum()),
                                          peer_model_bytes)
                # heartbeat every peer that ran this step with its measured
                # duration; silent peers age toward the sweep timeout
                lifecycle.observe_durations(t, np.full(n_peers, dt), mask=u)
            metrics_log.log(t + 1, tokens=n_peers * args.local_steps
                            * args.batch * args.seq,
                            sim_s=(transcript.iteration_s
                                   if transcript is not None else None),
                            loss=loss)
            if (t + 1) % 5 == 0 or t == start:
                sim = (f" sim={transcript.iteration_s*1e3:.0f}ms"
                       if transcript is not None else "")
                print(f"  step {t+1:4d} loss={loss:.4f} "
                      f"({dt*1e3:.0f} ms){sim} "
                      f"active={int(a.sum())}/{n_peers}")
            if on_step is not None:
                on_step({"t": t, "state": state, "metrics": metrics,
                         "seconds": dt, "step_fn": step_fn, "batch": batch,
                         "ledger": ledger})
            if ckpt and (t + 1) % args.ckpt_every == 0:
                ckpt.save(t + 1, state,
                          metadata={"step": t + 1, "n_peers": n_peers,
                                    "grid_dims": list(grid.dims),
                                    "arch": cfg.name},
                          blocking=False)
        if ckpt:
            ckpt.save(start + args.steps, state,
                      metadata={"step": start + args.steps,
                                "n_peers": n_peers,
                                "grid_dims": list(grid.dims),
                                "arch": cfg.name})
            ckpt.wait()
            print(f"[train] checkpointed at {start + args.steps}")
        per_source = " ".join(f"{k}={v/1e6:.1f}MB"
                              for k, v in ledger.by_source.items())
        sim = ""
        if network is not None:
            kind = ("wall-clock" if network.name == "socket"
                    else f"simulated ({args.link_profile or 'uniform'})")
            sim = f" comm_s={ledger.total_seconds:.2f} [{kind}]"
        print(f"[train] comm total={ledger.total_bytes/1e6:.1f}MB "
              f"{per_source}{sim}")
        if lifecycle.event_log:
            by_kind: dict = {}
            for e in lifecycle.event_log:
                by_kind[e.kind] = by_kind.get(e.kind, 0) + len(e.peers)
            print("[train] membership events: " + " ".join(
                f"{k}={v}" for k, v in sorted(by_kind.items())))
    finally:
        if network is not None and hasattr(network, "close"):
            network.close()   # book-mode sockets + background loop thread
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
