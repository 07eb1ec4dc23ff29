"""Decode-serving CLI over the port's continuous-batching engine.

Port of the JAX package's ``repro/launch/serve.py``, with the same flags
plus ``--device``: enqueue N synthetic sessions (mixed prompt lengths
with ``--vary-prompts``), drain them through the paged-KV
:class:`~repro_torch.serve.engine.DecodeServer`, print throughput and
latency percentiles. ``--sequential`` runs the one-session-at-a-time
baseline instead (also the only path for the recurrent families, ssm
and hybrid, whose state cannot be paged: they take fixed-length
prompts); ``--swap-demo`` performs an identity hot-swap mid-drain. The
model runs on CUDA (and the command raises where there is no GPU)
unless ``--device cpu`` is given. ``--ckpt-dir`` serves the newest
step of a checkpoint directory (written by either package; a
peer-stacked FL state is folded to its peer mean) and hot-swaps newer
steps mid-drain. The frontends raise ``NotImplementedError`` naming
their ROADMAP.md item.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --sessions 8 --prompt-len 24 --gen 16 --max-batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch moonshot-v1-16b-a3b --vary-prompts --prompt-len 512 \
      --gen 64 --sessions 16 --max-batch 8 --block-size 16
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.registry import ARCH_IDS, get_config, \
    get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.model import Model, resolve_device
from repro_torch.serve import (DecodeServer, ServeConfig, run_sequential,
                               serving_params_from_checkpoint)

PAGED = T.PAGED_FAMILIES


def _summarize(tag, sessions, elapsed):
    toks = sum(len(s.generated) for s in sessions)
    times = [t for s in sessions for t in s.token_times[1:]]
    p50 = np.percentile(times, 50) * 1e3 if times else 0.0
    p99 = np.percentile(times, 99) * 1e3 if times else 0.0
    print(f"[serve] {tag}: {len(sessions)} sessions, {toks} tokens in "
          f"{elapsed:.2f}s ({toks / max(elapsed, 1e-9):.1f} tok/s), "
          f"per-token p50 {p50:.1f}ms p99 {p99:.1f}ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="starcoder2-3b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--vary-prompts", action="store_true",
                    help="mixed prompt lengths in [1, prompt_len]")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="KV pool size (default: a full batch's worst case)")
    ap.add_argument("--sequential", action="store_true",
                    help="one-session-at-a-time dense baseline")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve (and hot-swap) weights from this "
                         "checkpoint directory")
    ap.add_argument("--swap-demo", action="store_true",
                    help="identity hot-swap mid-drain (zero-drop demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions of the kernels)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    T.check_supported(cfg)
    device = resolve_device(args.device)
    model = Model(cfg)
    rng = np.random.default_rng(args.seed)
    params = model.init(args.seed, device=device)

    ckpt = None
    if args.ckpt_dir:
        from repro_torch.checkpoint import Checkpointer
        ckpt = Checkpointer(args.ckpt_dir)
        if ckpt.latest_step() is not None:
            state, meta = ckpt.restore(device="cpu")
            params = serving_params_from_checkpoint(state, params)
            print(f"[serve] restored step {ckpt.latest_step()} "
                  f"from {args.ckpt_dir} (meta: {meta})")

    paged = cfg.family in PAGED and not args.sequential
    if not paged and args.vary_prompts and cfg.family not in PAGED:
        print("[serve] recurrent family: fixed-length prompts only")
        args.vary_prompts = False
    plens = (rng.integers(1, args.prompt_len + 1, args.sessions)
             if args.vary_prompts
             else np.full(args.sessions, args.prompt_len))
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in plens]

    if not paged:
        print(f"[serve] sequential baseline ({cfg.family}) on {device}")
        t0 = time.perf_counter()
        done = run_sequential(model, params, prompts, max_new=args.gen,
                              pad_len=args.prompt_len)
        _summarize("sequential", done, time.perf_counter() - t0)
        print("[serve] sample:", done[0].generated[:16])
        return 0

    need = -(-(args.prompt_len + args.gen) // args.block_size)
    num_blocks = args.num_blocks or 1 + need * args.max_batch
    scfg = ServeConfig(max_batch=args.max_batch, block_size=args.block_size,
                       num_blocks=num_blocks, pad_len=args.prompt_len,
                       max_new=args.gen)
    srv = DecodeServer(model, params, scfg)
    if ckpt is not None:
        srv.attach_checkpointer(ckpt, params)
    for p in prompts:
        srv.enqueue(p)
    print(f"[serve] engine on {device}: {args.sessions} sessions, pool "
          f"{num_blocks}x{args.block_size} KV slots, batch {args.max_batch}")
    t0 = time.perf_counter()
    if args.swap_demo:
        for _ in range(3):
            srv.step()
        srv.swap_params(srv.params, tag="demo-identity")
    srv.run()
    elapsed = time.perf_counter() - t0
    srv.assert_quiescent()
    _summarize("continuous", srv.finished, elapsed)
    st = srv.stats()
    print(f"[serve] {st['prefills']} prefills, {st['decode_steps']} decode "
          f"steps, {st['swaps']} hot-swaps")
    if srv.swap_log:
        print("[serve] swap log:", srv.swap_log)
    print("[serve] sample:", srv.finished[0].generated[:16])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
