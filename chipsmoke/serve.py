"""Serving on the card at full width: starcoder2-3b through the paged
engine, the recurrent families through ``run_sequential``, the moe
family, each with its parity at reduced depth in f32, and checkpoints
with a hot swap. Each phase on a main path returns its ``{kernel:
launches}``."""
from __future__ import annotations

import time

from chipsmoke.common import (check, device_profile, emit, label_profile,
                              launch_totals)
from chipsmoke.refs import (MOONSHOT_ATTN, RECURRENT, RECURRENT_LAUNCHES,
                            SERVE, SERVE_LAYERS)


def _serve_prompts(vocab: int, n: int, max_len: int):
    """Prompt lengths and tokens as ``launch/serve.py --vary-prompts``
    draws them from ``default_rng(0)``."""
    import numpy as np

    rng = np.random.default_rng(0)
    plens = rng.integers(1, max_len + 1, n)
    return [rng.integers(0, vocab, k).tolist() for k in plens]


def _serve_config(ServeConfig, max_new: int = SERVE["max_new"]):
    """The engine geometry, with ``launch/serve.py``'s pool size: a full
    batch's worst case plus the scratch page."""
    bs, pad = SERVE["block_size"], SERVE["pad_len"]
    need = -(-(pad + max_new) // bs)
    return ServeConfig(max_batch=SERVE["max_batch"], block_size=bs,
                       num_blocks=1 + need * SERVE["max_batch"],
                       pad_len=pad, max_new=max_new)


def _prompt_tokens(torch, prompt):
    import numpy as np

    toks = np.zeros((1, SERVE["pad_len"]), np.int32)
    toks[0, :len(prompt)] = prompt
    return torch.as_tensor(toks).cuda()


def _engine_run(torch, model, params, phase: str, layers: int):
    """SERVE's traffic through the continuous-batching engine after a
    warm-up engine of one short session: 16 sessions, prompts drawn as
    --vary-prompts draws them, batch 8, pages of 16, pad_len 512, 64 new
    tokens each, timed, its launches counted from 0 and the peak memory
    read after it. Gates: the pool is quiescent, every session ends with
    64 tokens, flash launches ``layers`` times a prefill and the paged
    kernel ``layers`` times a decode step. Returns the run's fields and
    its prompts."""
    from repro_torch.kernels import ops
    from repro_torch.serve import DecodeServer, ServeConfig

    prompts = _serve_prompts(model.cfg.vocab_size, SERVE["sessions"],
                             SERVE["pad_len"])
    warm = DecodeServer(model, params, _serve_config(ServeConfig, 2))
    warm.enqueue(prompts[0])
    warm.run()
    del warm

    srv = DecodeServer(model, params, _serve_config(ServeConfig))
    for p in prompts:
        srv.enqueue(p)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    srv.run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = ops.launch_counts()
    srv.assert_quiescent()
    st = srv.stats()
    check(len(srv.finished) == SERVE["sessions"]
          and all(len(s.generated) == SERVE["max_new"]
                  for s in srv.finished),
          f"{phase}: a session did not finish with 64 tokens")
    check(launches["flash_attention"] == st["prefills"] * layers,
          f"{phase}: flash launched {launches['flash_attention']} times "
          f"for {st['prefills']} prefills of {layers} layers")
    check(launches["paged_decode_attention"] == st["decode_steps"] * layers,
          f"{phase}: paged kernel launched "
          f"{launches['paged_decode_attention']} times for "
          f"{st['decode_steps']} decode steps")
    return {"sessions": len(srv.finished), "prefills": st["prefills"],
            "decode_steps": st["decode_steps"], "tokens": st["tokens"],
            "elapsed_s": elapsed, "tokens_per_s": st["tokens"] / elapsed,
            "ttft_p50_ms": st["p50_ttft_s"] * 1e3,
            "per_token_p50_ms": st["p50_tok_s"] * 1e3,
            "per_token_p99_ms": st["p99_tok_s"] * 1e3,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "launches": launches}, prompts


def _engine_profiles(torch, model, params, prompts, labels=()):
    """Ten decode steps of a full batch, then one full-width prefill (pad
    512), each traced with ``labels``. Returns the decode batch and the
    two summaries."""
    from portbench.device import traced
    from repro_torch.serve import DecodeServer, ServeConfig

    srv = DecodeServer(model, params, _serve_config(ServeConfig))
    for p in prompts[:SERVE["max_batch"]]:
        srv.enqueue(p)
    srv.step()                            # admits all eight, one decode

    def decode():
        for _ in range(10):
            srv.step()

    toks = _prompt_tokens(torch, prompts[0])

    def prefill():
        with torch.inference_mode():
            model.forward(params, toks)

    cuda = torch.device("cuda")
    return (len(srv.running), traced(cuda, decode, labels),
            traced(cuda, prefill, labels))


def _finite_prefill(torch, model, params, prompt) -> bool:
    """The prompt's prefill logits and MoE aux loss (0 for a dense model)
    are finite."""
    with torch.inference_mode():
        logits, aux, _ = model.forward(params, _prompt_tokens(torch, prompt))
        return bool(torch.isfinite(logits).all() and torch.isfinite(aux))


def phase_serve(torch, smi):
    """The published starcoder2-3b (30 layers, d 3072, bf16, flash
    attention, random weights from seed 0) at full width through the
    continuous-batching engine (``_engine_run``: the flash and paged
    kernels launch 30 times per prefill and per decode step); the logits
    are finite. Then ten decode steps and one prefill under
    ``torch.profiler``."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve import ServeConfig

    cfg = get_config("starcoder2-3b")
    check(cfg.num_layers == SERVE_LAYERS and cfg.dtype == "bfloat16"
          and cfg.attn_impl == "flash", f"unexpected config {cfg}")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0)             # the default device: cuda
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    scfg = _serve_config(ServeConfig)
    check(scfg.num_blocks == 289, f"num_blocks {scfg.num_blocks} != 289")
    torch.cuda.reset_peak_memory_stats()
    run, prompts = _engine_run(torch, model, params, "serve", SERVE_LAYERS)
    finite = _finite_prefill(torch, model, params, prompts[0])
    emit("serve", arch=cfg.name, params=cfg.param_count(), init_s=init_s,
         **run, logits_finite=finite, card=smi)
    check(finite, "serve: prefill logits are not finite")
    batch, decode, prefill = _engine_profiles(torch, model, params, prompts)
    emit("serve_profile", steps=10, batch=batch,
         **device_profile(decode, 10))
    emit("serve_prefill_profile", pad_len=SERVE["pad_len"],
         **device_profile(prefill, 1))
    return {k: run["launches"][k] for k in ("flash_attention",
                                            "paged_decode_attention",
                                            "decode_attention")}


def _engine_parity(torch, arch: str, engine_runs: int):
    """``arch``'s widths at 2 layers in f32: ``engine_runs`` runs of the
    engine (paged kernel) over 12 prompts against the sequential baseline
    (plain dense decode), and the flash kernel's prefill logits and aux
    against the plain path's. Returns each engine run's streams, whether
    each sequential stream equals the first run's, that run's decode
    steps, the logits' largest difference and the two aux values."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve import DecodeServer, ServeConfig, run_sequential

    cfg = dataclasses.replace(get_config(arch), num_layers=2,
                              dtype="float32")
    model = Model(cfg)
    params = model.init(seed=0)
    prompts = _serve_prompts(cfg.vocab_size, 12, SERVE["pad_len"])
    runs = []
    for _ in range(engine_runs):
        srv = DecodeServer(model, params, _serve_config(ServeConfig))
        for p in prompts:
            srv.enqueue(p)
        srv.run()
        srv.assert_quiescent()
        runs.append({s.sid: s.generated for s in srv.finished})
    seq = run_sequential(model, params, prompts, max_new=SERVE["max_new"],
                         pad_len=SERVE["pad_len"])
    same = [runs[0][s.sid] == s.generated for s in seq]
    with torch.inference_mode():
        toks = _prompt_tokens(torch, prompts[0])
        flash, aux_k, _ = model.forward(params, toks)
        plain, aux_p, _ = Model(dataclasses.replace(cfg, attn_impl="xla")) \
            .forward(params, toks)
        logit_err = float((flash - plain).abs().max())
    return runs, same, srv.decode_steps, logit_err, (aux_k, aux_p)


def phase_serve_parity(torch):
    """starcoder2-3b's widths at 2 layers in f32 (``_engine_parity``): the
    engine's greedy streams equal the sequential baseline's, and the
    flash kernel's prefill logits are within 1e-4 of the plain path's."""
    _, same, steps, logit_err, _ = _engine_parity(torch, "starcoder2-3b", 1)
    emit("serve_parity", layers=2, dtype="float32", sessions=len(same),
         streams_equal=sum(same), engine_decode_steps=steps,
         prefill_logits_flash_vs_xla_max_abs_err=logit_err)
    check(all(same), f"serve_parity: {len(same) - sum(same)} of "
                     f"{len(same)} engine streams differ from sequential")
    check(logit_err <= 1e-4, f"serve_parity: flash vs xla prefill logits "
                             f"differ by {logit_err} > 1e-4")


def _recurrent_prompts(vocab: int, n: int, length: int):
    """``n`` prompts of exactly ``length`` tokens from ``default_rng(0)``
    (recurrent families take fixed-length prompts)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, length).tolist() for _ in range(n)]


def phase_serve_recurrent(torch, smi):
    """zamba2-2.7b and xlstm-350m at full width through
    ``run_sequential``, the recurrent families' serving path: 4 sessions,
    prompts of exactly 512 tokens, 32 new tokens each, bf16, random
    weights from seed 0 drawn on the card. Every session ends with its
    tokens, the logits are finite, and each prefill launches exactly
    RECURRENT_LAUNCHES' kernels: 45 SSD-scan + 9 flash (zamba2), 21
    SSD-scan (xlstm). Then one prefill and eight
    decode steps each under ``torch.profiler``: device-busy share and
    the kernels that fill it (the profiler slows the host, so these are
    shares, not speeds)."""
    import numpy as np

    from portbench.device import traced

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import group_layout
    from repro_torch.serve import run_sequential
    from repro_torch.tree import tree_leaves

    pad, new, n = (RECURRENT["pad_len"], RECURRENT["max_new"],
                   RECURRENT["sessions"])
    paths = []
    for arch, (n_ssd, n_flash) in RECURRENT_LAUNCHES.items():
        cfg = get_config(arch)
        g, p = group_layout(cfg)
        check(cfg.dtype == "bfloat16" and cfg.attn_impl == "flash"
              and g * (p - 1) == n_ssd
              and (g if cfg.family == "hybrid" else 0) == n_flash,
              f"unexpected config {cfg}")
        model = Model(cfg)
        t0 = time.perf_counter()
        params = model.init(seed=0)             # the default device: cuda
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        prompts = _recurrent_prompts(cfg.vocab_size, n, pad)
        run_sequential(model, params, prompts[:1], max_new=2, pad_len=pad)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = run_sequential(model, params, prompts, max_new=new,
                              pad_len=pad)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        paths.append({k: launches[k] for k in ("ssd_scan",
                                               "flash_attention")})

        with torch.inference_mode():
            toks = torch.as_tensor(np.asarray([prompts[0]], np.int32)).cuda()
            logits, _, _ = model.forward(params, toks)
            finite = bool(torch.isfinite(logits).all())
        tokens = sum(len(s.generated) for s in done)
        times = [t for s in done for t in s.token_times[1:]]
        ttft = [s.token_times[0] for s in done]
        emit("serve_recurrent", arch=cfg.name, family=cfg.family,
             params=sum(x.numel() for x in tree_leaves(params)), init_s=init_s,
             sessions=len(done), prompt_len=pad, tokens=tokens,
             elapsed_s=elapsed, tokens_per_s=tokens / elapsed,
             ttft_p50_ms=float(np.percentile(ttft, 50)) * 1e3,
             per_token_p50_ms=float(np.percentile(times, 50)) * 1e3,
             per_token_p99_ms=float(np.percentile(times, 99)) * 1e3,
             peak_memory_bytes=peak, launches=launches,
             expected_per_prefill={"ssd_scan": n_ssd,
                                   "flash_attention": n_flash},
             logits_finite=finite, card=smi)
        check(len(done) == n and all(len(s.generated) == new for s in done),
              f"serve_recurrent {arch}: a session did not finish with "
              f"{new} tokens")
        check(finite, f"serve_recurrent {arch}: logits are not finite")
        check(launches["ssd_scan"] == n * n_ssd,
              f"serve_recurrent {arch}: ssd_scan launched "
              f"{launches['ssd_scan']} times for {n} prefills of {n_ssd}")
        check(launches["flash_attention"] == n * n_flash,
              f"serve_recurrent {arch}: flash launched "
              f"{launches['flash_attention']} times for {n} prefills of "
              f"{n_flash}")

        # one prefill, then eight decode steps, each under the profiler
        def prefill():
            run_sequential(model, params, prompts[:1], max_new=1,
                           pad_len=pad)

        emit("serve_recurrent_profile", arch=cfg.name, part="prefill",
             **device_profile(traced(torch.device("cuda"), prefill, ()), 1))
        cache = model.init_cache(1, 16)
        tok = torch.zeros((1,), dtype=torch.int32, device="cuda")

        def decode():
            nonlocal cache, tok
            for _ in range(8):
                logits, cache = model.decode_step(params, cache, tok)
                tok = logits.argmax(dim=-1).to(torch.int32)

        with torch.inference_mode():
            model.decode_step(params, cache, tok)
            summary = traced(torch.device("cuda"), decode, ())
        emit("serve_recurrent_profile", arch=cfg.name, part="decode",
             **device_profile(summary, 8))
        del params, model
        torch.cuda.empty_cache()
    return launch_totals(paths)


def phase_recurrent_parity(torch):
    """Both families' widths at reduced depth in f32 (zamba2: 6 layers,
    attn_every 3; xlstm: 4 layers, slstm_every 2): prefill logits of the
    kernel path (``"flash"``: the SSD-scan and flash kernels) against
    the plain path (``"xla"``) within 1e-4, and equal greedy streams
    (prompt 64, 8 new tokens). Where a stream parts, the step and both
    paths' two top logits there are printed: a near tie within the
    tolerance is reported, any other parting fails."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve import run_sequential

    for arch, kw in [("zamba2-2.7b", dict(num_layers=6, attn_every=3)),
                     ("xlstm-350m", dict(num_layers=4, slstm_every=2))]:
        cfg = dataclasses.replace(get_config(arch), dtype="float32", **kw)
        kernel = Model(cfg)
        plain = Model(dataclasses.replace(cfg, attn_impl="xla"))
        params = kernel.init(seed=0)
        prompts = _recurrent_prompts(cfg.vocab_size, 2, 64)
        with torch.inference_mode():
            toks = torch.as_tensor(np.asarray(prompts, np.int32)).cuda()
            lk, _, _ = kernel.forward(params, toks)
            lp, _, _ = plain.forward(params, toks)
            logit_err = float((lk - lp).abs().max())
        sk = run_sequential(kernel, params, prompts, max_new=8, pad_len=64)
        sp = run_sequential(plain, params, prompts, max_new=8, pad_len=64)
        partings = []
        for a, b in zip(sk, sp):
            if a.generated == b.generated:
                continue
            step = next(i for i, (x, y) in enumerate(zip(a.generated,
                                                         b.generated))
                        if x != y)
            ctx = torch.as_tensor(np.asarray(
                [list(a.prompt) + a.generated[:step]], np.int32)).cuda()
            with torch.inference_mode():
                top = {name: torch.topk(m.forward(params, ctx)[0][0, -1],
                                        2).values.tolist()
                       for name, m in (("kernel", kernel), ("plain", plain))}
            tie = all(abs(v[0] - v[1]) <= 1e-4 for v in top.values())
            partings.append({"session": a.sid, "step": step, "top2": top,
                             "near_tie": tie})
        emit("recurrent_parity", arch=arch, dtype="float32", **kw,
             prompt_len=64, max_new=8, sessions=len(prompts),
             streams_equal=sum(a.generated == b.generated
                               for a, b in zip(sk, sp)),
             partings=partings,
             prefill_logits_kernel_vs_plain_max_abs_err=logit_err)
        check(logit_err <= 1e-4, f"recurrent_parity {arch}: kernel vs plain "
                                 f"prefill logits differ by {logit_err}")
        check(all(p["near_tie"] for p in partings),
              f"recurrent_parity {arch}: streams part without a near tie: "
              f"{partings}")
        del params
        torch.cuda.empty_cache()


MOE_LAYERS = 48
MOE_PARAMS = 28_888_467_456          # the reference's Model.init, counted


def phase_serve_moe(torch, smi):
    """moonshot-v1-16b-a3b at full width through the port's engine: 48
    layers, d 2048, 16 heads of 128 (kv 16: g = 1), 64 experts top-6 of
    d_ff 1408 and 2 shared, vocab 163,840, bf16; 28,888,467,456
    parameters drawn on the card from seed 0 after the earlier phases
    freed their models, then the serve phase's traffic (``_engine_run``:
    flash 48 launches a prefill, the paged kernel 48 a decode step); the
    logits and aux are finite. Prints the parameter count and bytes, the
    peak device memory, tokens/s, TTFT and per-token times. Then ten
    decode steps and one prefill under ``torch.profiler``, with the MoE
    expert products and combine (label ``moe``) apart."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    cfg = get_config("moonshot-v1-16b-a3b")
    check(cfg.family == "moe" and cfg.num_layers == MOE_LAYERS
          and cfg.dtype == "bfloat16" and cfg.attn_impl == "flash"
          and (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
          == (MOONSHOT_ATTN["h"], MOONSHOT_ATTN["kvh"], MOONSHOT_ATTN["d"]),
          f"unexpected config {cfg}")
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0)             # the default device: cuda
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    leaves = tree_leaves(params)
    n_params = sum(x.numel() for x in leaves)
    n_bytes = sum(x.numel() * x.element_size() for x in leaves)
    check(n_params == MOE_PARAMS == cfg.param_count(),
          f"serve_moe: {n_params} parameters, expected {MOE_PARAMS}")
    run, prompts = _engine_run(torch, model, params, "serve_moe",
                               MOE_LAYERS)
    finite = _finite_prefill(torch, model, params, prompts[0])
    emit("serve_moe", arch=cfg.name, params=n_params, param_bytes=n_bytes,
         resident_before_bytes=resident, init_s=init_s,
         init_peak_memory_bytes=init_peak, **run,
         expected_per_step=MOE_LAYERS, logits_finite=finite, card=smi)
    check(finite, "serve_moe: prefill logits or aux are not finite")
    batch, decode, prefill = _engine_profiles(torch, model, params, prompts,
                                              ("moe",))
    emit("serve_moe_profile", part="decode", steps=10, batch=batch,
         moe=label_profile(decode, "moe", 10), **device_profile(decode, 10))
    emit("serve_moe_profile", part="prefill", pad_len=SERVE["pad_len"],
         moe=label_profile(prefill, "moe", 1), **device_profile(prefill, 1))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {k: run["launches"][k] for k in ("flash_attention",
                                            "paged_decode_attention",
                                            "decode_attention")}


def phase_serve_moe_parity(torch):
    """moonshot's widths at 2 layers in f32 (``_engine_parity``; batch 8
    keeps the decode capacity at 8, so no assignment drops): the
    engine's greedy streams equal the sequential baseline's, a second
    engine run gives the same streams (the combine is deterministic), and
    the flash kernel's prefill logits are within 1e-4 of the plain
    path's."""
    runs, same, steps, logit_err, aux = _engine_parity(
        torch, "moonshot-v1-16b-a3b", 2)
    emit("serve_moe_parity", layers=2, dtype="float32",
         sessions=len(same), streams_equal=sum(same),
         engine_reruns_equal=runs[0] == runs[1],
         engine_decode_steps=steps,
         prefill_logits_flash_vs_xla_max_abs_err=logit_err,
         aux_flash_vs_xla=[float(a) for a in aux])
    check(all(same), f"serve_moe_parity: {len(same) - sum(same)} of "
                     f"{len(same)} engine streams differ from sequential")
    check(runs[0] == runs[1], "serve_moe_parity: two engine runs differ")
    check(logit_err <= 1e-4, f"serve_moe_parity: flash vs xla prefill "
                             f"logits differ by {logit_err} > 1e-4")
    torch.cuda.empty_cache()


def _same_bits(torch, a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}.get(
        a.element_size(), torch.uint8)
    return torch.equal(a.contiguous().view(view).cpu(),
                       b.contiguous().view(view).cpu())


def phase_checkpoint(torch):
    """Checkpoints and the hot-swap on the card, moonshot's smoke config
    (bf16 experts, f32 router): an FL state ``{"params", "momentum"}``
    with a peer axis of 3 saved and restored bit for bit, with and
    without ``like``; then an engine polling the directory every 2 steps
    swaps a newer step in mid-drain, no session dropped, its weights bit
    for bit the peer mean ``serving_params_from_checkpoint`` makes on
    the CPU."""
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model
    from repro_torch.serve import (DecodeServer, ServeConfig,
                                   serving_params_from_checkpoint)
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_smoke_config("moonshot-v1-16b-a3b")
    model = Model(cfg)
    params = model.init(seed=0)

    def fl_state(scale):
        def peers(x):
            return torch.stack([x, x * scale, x * (2 - scale)])
        return {"params": tree_map(peers, params),
                "momentum": tree_map(lambda x: peers(x) * 0.1, params)}

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp, keep=2)
        state = fl_state(1.5)
        t0 = time.perf_counter()
        ck.save(1, state, metadata={"n_peers": 3})
        out["save_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        got, meta = ck.restore()                # the default device: cuda
        torch.cuda.synchronize()
        out["restore_ms"] = (time.perf_counter() - t0) * 1e3
        liked, _ = ck.restore(like=state)
        want = tree_leaves(state)
        dtypes = sorted({str(x.dtype) for x in want})
        ok_plain = all(_same_bits(torch, a, b) and a.is_cuda
                       for a, b in zip(tree_leaves(got), want))
        ok_like = all(_same_bits(torch, a, b) and a.is_cuda
                      for a, b in zip(tree_leaves(liked), want))
        out.update(leaves=len(want), dtypes=dtypes, meta=meta,
                   bit_exact_without_like=ok_plain,
                   bit_exact_with_like=ok_like)
        check(ok_plain and ok_like and meta == {"n_peers": 3},
              f"checkpoint: a restore is not bit for bit: {out}")

        scfg = ServeConfig(max_batch=2, block_size=4, num_blocks=40,
                           pad_len=12, max_new=8)
        srv = DecodeServer(model, params, scfg)
        srv.attach_checkpointer(Checkpointer(tmp), params, every=2)
        for p in _serve_prompts(cfg.vocab_size, 4, 12):
            srv.enqueue(p)
        for _ in range(3):
            srv.step()
        ck.save(2, fl_state(1.25), metadata={"n_peers": 3})
        srv.run()
        srv.assert_quiescent()
        state_cpu, _ = ck.restore(2, device="cpu")
        want = serving_params_from_checkpoint(
            state_cpu, tree_map(lambda x: x.cpu(), params))
        swapped = all(_same_bits(torch, a, b) and a.is_cuda
                      for a, b in zip(tree_leaves(srv.params),
                                      tree_leaves(want)))
        out.update(swap_log=srv.swap_log,
                   sessions=len(srv.finished),
                   tokens=[len(s.generated) for s in srv.finished],
                   swapped_bit_equal_to_cpu_fold=swapped)
    emit("checkpoint", arch=cfg.name, **out)
    check(len(srv.swap_log) == 1 and srv.swap_log[0]["tag"] == "ckpt:2"
          and srv.swap_log[0]["in_flight"],
          f"checkpoint: expected one mid-drain swap to ckpt:2, got "
          f"{srv.swap_log}")
    check(len(srv.finished) == 4
          and all(len(s.generated) == 8 for s in srv.finished),
          "checkpoint: a session was dropped or cut short by the swap")
    check(swapped, "checkpoint: the swapped weights are not the CPU fold")
