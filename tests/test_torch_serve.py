"""The port's serving tier against the JAX package's.

Mirrors ``tests/test_serve.py`` on the port: allocator invariants, FIFO
head-of-line admission, no block leak under pressure, identity hot-swap,
the peer-mean fold and the prefill scatter. The engine's greedy streams
must equal the port's sequential baseline and, on the reference's
weights (carried across by ``repro_torch.convert``), the JAX
``DecodeServer``'s — f32 and ``attn_impl="xla"`` as in the reference's
tests, where the paged path and the dense path are the same einsums.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.models.model import Model as RefModel
from repro.serve import DecodeServer as RefDecodeServer
from repro.serve import ServeConfig as RefServeConfig

from repro_torch import convert
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models.model import Model
from repro_torch.serve import (BlockAllocator, DecodeServer, ServeConfig,
                               gather_session_cache, run_sequential,
                               serving_params_from_checkpoint,
                               session_table, write_prefill_to_pages)
from repro_torch.tree import tree_leaves, tree_map

MAX_NEW = 6


@pytest.fixture(scope="module")
def dense():
    """The reference's f32 smoke model and its weights, in both
    packages."""
    kw = dict(attn_impl="xla", dtype="float32")
    ref_model = RefModel(dataclasses.replace(
        ref_smoke_config("starcoder2-3b"), **kw))
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = Model(dataclasses.replace(get_smoke_config("starcoder2-3b"),
                                      **kw))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, ref_params))
    return model, params, ref_model, ref_params


def _prompts(vocab, n, lo=1, hi=12, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, rng.integers(lo, hi + 1)).tolist()
            for _ in range(n)]


def _drain(model, params, scfg, prompts):
    srv = DecodeServer(model, params, scfg)
    for p in prompts:
        srv.enqueue(p)
    srv.run()
    srv.assert_quiescent()
    return srv


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

def test_engine_streams_equal_the_reference_engine(dense):
    model, params, ref_model, ref_params = dense
    kw = dict(max_batch=3, block_size=4, num_blocks=40, pad_len=12,
              max_new=MAX_NEW)
    prompts = _prompts(model.cfg.vocab_size, 7)
    srv = _drain(model, params, ServeConfig(**kw), prompts)
    ref = RefDecodeServer(ref_model, ref_params, RefServeConfig(**kw))
    for p in prompts:
        ref.enqueue(p)
    ref.run()
    assert {s.sid: s.generated for s in srv.finished} == \
           {s.sid: s.generated for s in ref.finished}
    assert (srv.prefill_count, srv.decode_steps) == \
           (ref.prefill_count, ref.decode_steps)


def test_engine_matches_sequential_mixed_lengths(dense):
    """Heterogeneous-length continuous batch produces the exact greedy
    tokens of the one-at-a-time baseline."""
    model, params, _, _ = dense
    scfg = ServeConfig(max_batch=3, block_size=4, num_blocks=40,
                       pad_len=12, max_new=MAX_NEW)
    prompts = _prompts(model.cfg.vocab_size, 7, seed=5)
    srv = _drain(model, params, scfg, prompts)
    seq = run_sequential(model, params, prompts, max_new=MAX_NEW,
                         pad_len=12)
    eng = {s.sid: s.generated for s in srv.finished}
    assert all(eng[s.sid] == s.generated for s in seq)
    assert all(len(s.generated) == MAX_NEW for s in seq)


def test_write_prefill_roundtrip(dense):
    """Scattered prefill KV gathers back identically (incl. a ragged
    last block); the pool is written in place."""
    model, params, _, _ = dense
    s, bs = 11, 4                                    # 3 blocks, ragged
    toks = torch.as_tensor(np.arange(2 * s).reshape(2, s) % 50)
    _, _, cache = model.forward(params, toks, collect_cache=True)
    pages = model.init_paged_cache(7, bs, device="cpu")
    pool = pages["k_pages"]
    bt = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    out = write_prefill_to_pages(pages, cache["k"], cache["v"], bt)
    assert out["k_pages"] is pool
    got = gather_session_cache(pages, [4, 5, 6])
    torch.testing.assert_close(got["k"][:, 0, :s], cache["k"][:, 1],
                               rtol=0, atol=0)
    torch.testing.assert_close(got["v"][:, 0, :s], cache["v"][:, 1],
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# allocator / scheduler invariants
# ---------------------------------------------------------------------------

def test_block_allocator_invariants():
    al = BlockAllocator(6)
    assert al.free_blocks == 5                     # block 0 reserved
    got = al.alloc(3)
    assert 0 not in got and len(set(got)) == 3
    with pytest.raises(RuntimeError):
        al.alloc(3)                                # only 2 left
    al.free(got)
    with pytest.raises(RuntimeError):
        al.free([got[0]])                          # double free
    assert al.free_blocks == 5
    assert session_table([1, 2], 4) == [1, 2, 0, 0]
    with pytest.raises(ValueError):
        session_table([1, 2, 3], 2)
    with pytest.raises(ValueError):
        BlockAllocator(1)


def test_no_block_leak_under_pressure(dense):
    """A pool far smaller than the offered load still drains every
    session and reclaims every block."""
    model, params, _, _ = dense
    scfg = ServeConfig(max_batch=4, block_size=4, num_blocks=11,
                       pad_len=12, max_new=MAX_NEW)
    srv = DecodeServer(model, params, scfg)
    for p in _prompts(model.cfg.vocab_size, 8, seed=1):
        srv.enqueue(p)
    peak_free = srv.alloc.free_blocks
    srv.run(max_steps=500)
    assert len(srv.finished) == 8
    srv.assert_quiescent()
    assert srv.alloc.free_blocks == peak_free


def test_fifo_head_of_line(dense):
    """Admission is FIFO: while the (large) queue head doesn't fit, a
    small later arrival must not overtake it."""
    model, params, _, _ = dense
    scfg = ServeConfig(max_batch=3, block_size=4, num_blocks=10,
                       pad_len=12, max_new=MAX_NEW)
    srv = DecodeServer(model, params, scfg)
    big_a = srv.enqueue([1] * 12)     # needs ceil(18/4)=5 of 9 blocks
    big_b = srv.enqueue([2] * 12)     # head-of-line once A runs
    small = srv.enqueue([3])          # would fit beside A — must wait
    srv.step()
    assert big_a.state == "running"
    assert big_b.state == "queued" and small.state == "queued"
    srv.run()
    srv.assert_quiescent()
    assert [s.sid for s in srv.finished] == [big_a.sid, big_b.sid,
                                             small.sid]


def test_enqueue_rejects_impossible(dense):
    model, params, _, _ = dense
    scfg = ServeConfig(max_batch=2, block_size=4, num_blocks=4,
                       pad_len=12, max_new=MAX_NEW)
    srv = DecodeServer(model, params, scfg)
    with pytest.raises(ValueError):
        srv.enqueue([1] * 13)                      # > pad_len
    with pytest.raises(ValueError):
        srv.enqueue([1] * 12)                      # footprint > pool
    with pytest.raises(ValueError):
        srv.enqueue([1], max_new=MAX_NEW + 1)
    srv.assert_quiescent()


def test_stats_count_the_drain(dense):
    model, params, _, _ = dense
    scfg = ServeConfig(max_batch=2, block_size=4, num_blocks=20,
                       pad_len=12, max_new=MAX_NEW)
    srv = _drain(model, params, scfg, _prompts(model.cfg.vocab_size, 3))
    st = srv.stats()
    assert st["sessions"] == 3 and st["tokens"] == 3 * MAX_NEW
    assert st["prefills"] == 3 and st["decode_steps"] == srv.decode_steps
    assert st["p50_tok_s"] > 0 and st["p50_ttft_s"] > 0


# ---------------------------------------------------------------------------
# hot-swap and the checkpoint fold
# ---------------------------------------------------------------------------

def test_identity_hot_swap_is_deterministic(dense):
    """Swapping identical weights mid-decode changes nothing and drops
    nothing."""
    model, params, _, _ = dense
    scfg = ServeConfig(max_batch=3, block_size=4, num_blocks=40,
                       pad_len=12, max_new=MAX_NEW)
    prompts = _prompts(model.cfg.vocab_size, 6, seed=2)

    def drain(swap):
        srv = DecodeServer(model, params, scfg)
        for p in prompts:
            srv.enqueue(p)
        if swap:
            for _ in range(3):
                srv.step()
            assert srv.running                     # mid-decode
            srv.swap_params(tree_map(lambda x: x + 0, params),
                            tag="identity")
        srv.run()
        srv.assert_quiescent()
        return srv

    base, swapped = drain(False), drain(True)
    assert len(swapped.finished) == len(prompts)   # zero dropped
    assert {s.sid: s.generated for s in base.finished} == \
           {s.sid: s.generated for s in swapped.finished}
    (entry,) = swapped.swap_log
    assert entry["tag"] == "identity" and entry["in_flight"]


def test_serving_params_peer_mean(dense):
    """FL checkpoints carry a peer axis; serving weights are its mean."""
    model, params, _, _ = dense
    stacked = tree_map(lambda x: torch.stack([x, 3 * x]), params)  # mean 2x
    got = serving_params_from_checkpoint(
        {"params": stacked, "momentum": stacked}, params)
    for a, b in zip(tree_leaves(got), tree_leaves(params)):
        torch.testing.assert_close(a, 2 * b, rtol=0, atol=1e-6)
    # numpy leaves (a restored npz) fold the same way
    as_numpy = convert.params_to_numpy(stacked)
    got_np = serving_params_from_checkpoint(as_numpy, params)
    for a, b in zip(tree_leaves(got_np), tree_leaves(got)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # raw (unstacked) params pass through unchanged
    same = serving_params_from_checkpoint(params, params)
    for a, b in zip(tree_leaves(same), tree_leaves(params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_attach_checkpointer_swaps_mid_drain(dense, tmp_path, writer):
    """The watcher restores every newer step between decode steps and
    swaps it in with no session dropped, as the reference's engine does
    (``tests/test_serve.py``); the installed weights are the step's peer
    mean, bit for bit what ``serving_params_from_checkpoint`` makes on
    the CPU, whichever package wrote the directory."""
    model, params, _, _ = dense
    other = tree_map(lambda x: x * 1.5 + 0.01, params)
    scfg = ServeConfig(max_batch=2, block_size=4, num_blocks=20,
                       pad_len=12, max_new=MAX_NEW)
    prompts = _prompts(model.cfg.vocab_size, 4, seed=4)
    ckpt = (Checkpointer if writer == "port" else RefCheckpointer)(
        str(tmp_path), keep=2)

    def save(step, tree):
        state = {"params": tree_map(lambda x: torch.stack([x, 3 * x]), tree),
                 "momentum": tree_map(torch.zeros_like, tree)}
        if writer == "reference":
            state = jax.tree.map(jnp.asarray, convert.params_to_numpy(state))
        ckpt.save(step, state, metadata={"n_peers": 2})

    save(1, params)
    srv = DecodeServer(model, params, scfg)
    srv.attach_checkpointer(Checkpointer(str(tmp_path)), params, every=1)
    for p in prompts:
        srv.enqueue(p)
    for _ in range(2):
        srv.step()
    assert not srv.swap_log                        # step 1 already seen
    save(2, other)
    srv.run()
    srv.assert_quiescent()
    assert len(srv.finished) == len(prompts)
    assert all(len(s.generated) == MAX_NEW for s in srv.finished)
    (entry,) = srv.swap_log
    assert entry["tag"] == "ckpt:2" and entry["in_flight"]
    state, _ = Checkpointer(str(tmp_path)).restore(2, device="cpu")
    want = serving_params_from_checkpoint(state, params)
    for a, b in zip(tree_leaves(srv.params), tree_leaves(want)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(srv.params), tree_leaves(other)):
        torch.testing.assert_close(a, 2 * b, rtol=0, atol=1e-6)


def test_attach_checkpointer_polls_every_n_steps(dense, tmp_path):
    model, params, _, _ = dense
    ckpt = Checkpointer(str(tmp_path))
    srv = DecodeServer(model, params, ServeConfig(num_blocks=20, pad_len=12,
                                                  max_new=4))
    srv.attach_checkpointer(ckpt, params, every=3)
    for p in _prompts(model.cfg.vocab_size, 2, seed=6):
        srv.enqueue(p)
    srv.step()                                  # step 0 polls: nothing
    ckpt.save(7, {"params": params})
    srv.step()
    srv.step()                                  # steps 1, 2 do not poll
    assert not srv.swap_log
    srv.step()                                  # step 3 polls
    assert [e["tag"] for e in srv.swap_log] == ["ckpt:7"]
    srv.run()
    srv.assert_quiescent()


# ---------------------------------------------------------------------------
# guards and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["xlstm-350m", "moonshot-v1-16b-a3b"])
def test_engine_takes_moe_and_refuses_recurrent_families(arch):
    """moe serves through the engine and run_sequential; a recurrent
    family is refused by the engine, and run_sequential refuses its
    prompt shorter than pad_len, as the reference does (ValueError)."""
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    params = model.init(seed=0, device="cpu")
    if cfg.family == "moe":
        srv = DecodeServer(model, params, ServeConfig(
            num_blocks=9, block_size=4, pad_len=4, max_new=2))
        srv.enqueue([1, 2])
        srv.run()
        srv.assert_quiescent()
        (seq,) = run_sequential(model, params, [[1, 2]], max_new=2,
                                pad_len=4)
        assert srv.finished[0].generated == seq.generated
        return
    with pytest.raises(ValueError, match="KV-cache"):
        DecodeServer(model, params, ServeConfig())
    with pytest.raises(ValueError, match="pad_len"):
        run_sequential(model, params, [[1, 2]], max_new=2, pad_len=4)


def test_cli_serves_on_cpu(capsys):
    assert serve_cli.main(["--smoke", "--device", "cpu", "--sessions", "3",
                           "--vary-prompts", "--gen", "4", "--max-batch",
                           "2", "--swap-demo"]) == 0
    out = capsys.readouterr().out
    assert "continuous: 3 sessions, 12 tokens" in out
    assert "1 hot-swaps" in out
    assert serve_cli.main(["--smoke", "--device", "cpu", "--sequential",
                           "--sessions", "2", "--gen", "3"]) == 0
    assert "sequential: 2 sessions, 6 tokens" in capsys.readouterr().out


def test_cli_runs_on_cuda_by_default_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--smoke"])


@pytest.mark.parametrize("case", ["ckpt_dir", "kimi"])
def test_cli_serves_ckpt_dir_and_the_moe_smoke_configs(case, tmp_path,
                                                       capsys):
    """``--ckpt-dir`` restores the newest step of a directory the
    reference wrote (an FL state, folded to its peer mean) and serves it
    with the watcher attached; ``--arch kimi-k2-1t-a32b --smoke`` serves
    the trillion-parameter family's smoke config on the CPU."""
    argv = ["--smoke", "--device", "cpu", "--sessions", "3",
            "--vary-prompts", "--gen", "4", "--max-batch", "2"]
    if case == "kimi":
        assert serve_cli.main([*argv, "--arch", "kimi-k2-1t-a32b"]) == 0
        assert "continuous: 3 sessions, 12 tokens" in capsys.readouterr().out
        return
    ref_model = RefModel(ref_smoke_config("starcoder2-3b"))
    ref_params = ref_model.init(jax.random.PRNGKey(5))
    RefCheckpointer(str(tmp_path)).save(
        4, {"params": jax.tree.map(lambda x: jnp.stack([x, x]), ref_params)},
        metadata={"n_peers": 2})
    assert serve_cli.main([*argv, "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "restored step 4" in out and "'n_peers': 2" in out
    assert "continuous: 3 sessions, 12 tokens" in out
    assert "0 hot-swaps" in out


def test_cli_frontends_keep_their_roadmap_item():
    """The frontend families, once refused for their unported frontend
    (Queue 1 item 9), now take the reference's path: no paged engine for
    prefix embeddings, and the sequential baseline refuses them."""
    with pytest.raises(ValueError, match="token prompts only"):
        serve_cli.main(["--smoke", "--device", "cpu", "--arch",
                        "pixtral-12b"])


def test_engine_pool_lives_on_the_params_device(dense):
    model, params, _, _ = dense
    srv = DecodeServer(model, params, ServeConfig(num_blocks=5, pad_len=8,
                                                  max_new=2, block_size=4))
    assert srv.device == torch.device("cpu")
    assert srv.pages["k_pages"].shape == (model.cfg.num_layers, 5, 4,
                                          model.cfg.num_kv_heads,
                                          model.cfg.head_dim)
    assert jnp.asarray(0) == 0           # the JAX side stays on its CPU
