"""The port's recurrent families (xLSTM: ssm; zamba2: hybrid) against the
JAX package's, on the same weights.

The reference's smoke models (``get_smoke_config``, f32) and their
weights cross into the port through ``repro_torch.convert`` unchanged:
nested stacks (``blocks.mlstm`` [g, p-1, ...], the hybrid's ``blocks``
[g, p-1, ...] beside one ``shared_attn``) are only deeper dicts, and the
sLSTM carry in a cache is a tuple. Both packages then run the same
numpy-made tokens: prefill logits and caches, decode steps, the
prefill -> decode handoff against token-by-token replay, the hybrid's
ring layout at a prompt longer than its window, and
``run_sequential``'s greedy streams, each under ``attn_impl="flash"``
(the port's kernels, here their plain versions on the CPU; the
reference's chunked scan and blockwise flash) and ``"xla"`` (the plain
chunked scan and attention on both sides).

Tolerance 1e-4 (the reference's own bound between its chunked scan and
its sequential oracle; the port's CPU kernel path scans step by step);
the handoff against replay 2e-4, as ``tests/test_serve.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.models.model import Model as RefModel
from repro.serve import run_sequential as ref_run_sequential

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.serve import DecodeServer, ServeConfig, run_sequential
from repro_torch.tree import tree_leaves, tree_map

ARCHS = ["xlstm-350m", "zamba2-2.7b"]
IMPLS = ["flash", "xla"]
TOL = 1e-4


def _pair(arch, attn_impl="xla", **kw):
    """(ref model, ref params, port model, port params) on the
    reference's f32 smoke weights."""
    kw = dict(attn_impl=attn_impl, dtype="float32", **kw)
    ref_model = RefModel(dataclasses.replace(ref_smoke_config(arch), **kw))
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = Model(dataclasses.replace(get_smoke_config(arch), **kw))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, ref_params))
    return ref_model, ref_params, model, params


@pytest.fixture(scope="module", params=[(a, i) for a in ARCHS for i in IMPLS],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    return _pair(*request.param)


def _tokens(shape, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def _from_ref(tree):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree))


def _close_trees(got, want, tol=TOL):
    got, want = tree_leaves(got), tree_leaves(_from_ref(want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_cross_with_the_references_nested_layout(arch):
    """The reference's nested stacks cross over through
    ``params_from_numpy`` and have the port's own init layout; the
    deterministic leaves equal the reference's exactly."""
    _, ref_params, model, params = _pair(arch)
    own = model.init(seed=0, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat] and \
        len(flat) == len(tree_leaves(own))
    for (path, _), a, b in zip(flat, tree_leaves(params), tree_leaves(own)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    g, p = T.group_layout(model.cfg)
    if arch == "xlstm-350m":
        assert params["blocks"]["mlstm"]["cell"]["wq"].shape[:2] == (g, p - 1)
        assert params["blocks"]["slstm"]["cell"]["r_rec"].shape[0] == g
        det = [("blocks", "slstm", "cell", "bias")]
    else:
        assert params["blocks"]["cell"]["in_proj"].shape[:2] == (g, p - 1)
        assert params["shared_attn"]["attn"]["wq"].dim() == 2
        det = [("blocks", "cell", k) for k in ("a_log", "dt_bias", "d_skip")]
    for keys in det:
        a, b = params, own
        for key in keys:
            a, b = a[key], b[key]
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# prefill, decode, handoff
# ---------------------------------------------------------------------------

def test_forward_and_cache_match_reference(pair):
    ref_model, ref_params, model, params = pair
    toks = _tokens((2, 12))
    want_logits, _, want_cache = ref_model.forward(
        ref_params, jnp.asarray(toks), collect_cache=True)
    logits, aux, cache = model.forward(params, torch.from_numpy(toks),
                                       collect_cache=True)
    torch.testing.assert_close(logits, torch.from_numpy(
        np.asarray(want_logits)), rtol=TOL, atol=TOL)
    assert float(aux) == 0.0
    assert sorted(cache) == sorted(want_cache)
    _close_trees(cache, want_cache)


def test_decode_steps_match_reference(pair):
    ref_model, ref_params, model, params = pair
    toks = _tokens((2, 5), seed=1)
    ref_cache = ref_model.init_cache(2, 8)
    cache = model.init_cache(2, 8, device="cpu")
    _close_trees(cache, ref_cache, tol=0)
    for i in range(5):
        want, ref_cache = ref_model.decode_step(ref_params, ref_cache,
                                                jnp.asarray(toks[:, i]))
        got, cache = model.decode_step(params, cache,
                                       torch.from_numpy(toks[:, i]))
        torch.testing.assert_close(got, torch.from_numpy(np.asarray(want)),
                                   rtol=TOL, atol=TOL)
    _close_trees(cache, ref_cache)


def test_prefill_handoff_matches_reference_and_replay(pair):
    """The decode-ready prefill cache continues exactly as token-by-token
    replay from scratch (mirrors ``tests/test_serve.py``), and as the
    reference's handoff."""
    ref_model, ref_params, model, params = pair
    S, MAXLEN = 6, 10
    toks = _tokens((2, MAXLEN), seed=3)
    cache = model.init_cache(2, MAXLEN, device="cpu")
    replay = []
    for i in range(MAXLEN):
        lg, cache = model.decode_step(params, cache,
                                      torch.from_numpy(toks[:, i]))
        replay.append(lg)

    lg, _, raw = model.forward(params, torch.from_numpy(toks[:, :S]),
                               collect_cache=True)
    dcache = model.prefill_cache_to_decode(raw, MAXLEN, S)
    _, _, jraw = ref_model.forward(ref_params, jnp.asarray(toks[:, :S]),
                                   collect_cache=True)
    jcache = ref_model.prefill_cache_to_decode(jraw, MAXLEN, S)
    _close_trees(dcache, jcache)
    outs = [lg[:, -1]]
    for i in range(S, MAXLEN):
        lg, dcache = model.decode_step(params, dcache,
                                       torch.from_numpy(toks[:, i]))
        outs.append(lg)
    torch.testing.assert_close(torch.stack(outs, 1),
                               torch.stack(replay[S - 1:], 1),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("attn_impl", IMPLS)
def test_hybrid_handoff_ring_layout(attn_impl):
    """Prompt longer than the window (mirrors ``tests/test_serve.py``):
    the converted ring holds position p at slot p % w with the same K/V,
    conv and ssm states, and equals the reference's conversion."""
    ref_model, ref_params, model, params = _pair(
        "zamba2-2.7b", attn_impl, shared_attn_window=4)
    toks = np.arange(12, dtype=np.int32).reshape(2, 6)
    S, MAXLEN = 6, 12
    _, _, raw = model.forward(params, torch.from_numpy(toks),
                              collect_cache=True)
    conv = model.prefill_cache_to_decode(raw, MAXLEN, S)
    w_f, w_d = raw["attn_k"].shape[2], conv["attn_k"].shape[2]
    assert (w_f, w_d) == (4, 4)
    for j in range(w_f):                  # raw index j holds pos S-w_f+j
        slot = (S - w_f + j) % w_d
        for key in ("attn_k", "attn_v"):
            torch.testing.assert_close(conv[key][:, :, slot],
                                       raw[key][:, :, j], rtol=0, atol=0)
    for key in ("conv", "ssm"):
        torch.testing.assert_close(conv[key], raw[key], rtol=0, atol=0)
    _, _, jraw = ref_model.forward(ref_params, jnp.asarray(toks),
                                   collect_cache=True)
    _close_trees(conv, ref_model.prefill_cache_to_decode(jraw, MAXLEN, S))


def test_run_sequential_streams_equal_the_references(pair):
    ref_model, ref_params, model, params = pair
    pad_len, max_new = 8, 5
    prompts = _tokens((3, pad_len), seed=4).tolist()
    got = run_sequential(model, params, prompts, max_new, pad_len)
    want = ref_run_sequential(ref_model, ref_params, prompts, max_new,
                              pad_len)
    assert [s.generated for s in got] == [s.generated for s in want]
    assert all(len(s.generated) == max_new for s in got)


def test_decode_writes_the_states_in_place():
    _, _, model, params = _pair("zamba2-2.7b")
    cache = model.init_cache(1, 4, device="cpu")
    before = {k: cache[k] for k in ("conv", "ssm", "attn_k")}
    _, out = model.decode_step(params, cache, torch.tensor([3]))
    for k, t in before.items():
        assert out[k] is t and t.abs().sum() > 0
    assert int(out["pos"][0]) == 1


def test_tree_map_walks_tuples():
    tree = {"a": (torch.ones(1), torch.zeros(2)), "b": torch.ones(3)}
    out = tree_map(lambda x: x + 1, tree)
    assert isinstance(out["a"], tuple)
    assert [t.tolist() for t in tree_leaves(out)] == [[2.0], [1.0, 1.0],
                                                      [2.0, 2.0, 2.0]]


# ---------------------------------------------------------------------------
# guards and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_families_rejected_where_the_reference_rejects(arch):
    """No paged serving for recurrent state (as ``tests/test_serve.py``);
    ``run_sequential`` takes exact-length prompts only."""
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    params = model.init(seed=0, device="cpu")
    with pytest.raises(ValueError, match="KV-cache"):
        DecodeServer(model, params, ServeConfig())
    with pytest.raises(ValueError, match="pad_len"):
        run_sequential(model, params, [[1, 2]], max_new=2, pad_len=4)
    with pytest.raises(ValueError, match="KV-cache"):
        model.init_paged_cache(3, 4, device="cpu")
    with pytest.raises(ValueError, match="KV-cache"):
        model.paged_decode_step(params, {}, torch.zeros(1, 1), torch.zeros(1),
                                torch.zeros(1), )


def test_moe_takes_the_paged_path_the_recurrent_families_refuse():
    """moe (once refused here with its ROADMAP.md item) has a paged pool
    and a paged decode step that continues a prefill."""
    cfg = get_smoke_config("moonshot-v1-16b-a3b")
    model = Model(cfg)
    params = model.init(seed=0, device="cpu")
    pages = T.init_paged_cache(cfg, 3, 4, "cpu")
    assert pages["k_pages"].dtype == torch.bfloat16
    logits, pages = model.paged_decode_step(
        params, pages, torch.tensor([[1, 2]], dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), torch.tensor([5]))
    assert logits.shape == (1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert pages["k_pages"][:, 1, 0].abs().sum() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_recurrent_families_on_cpu(arch, capsys):
    assert serve_cli.main(["--smoke", "--device", "cpu", "--arch", arch,
                           "--sessions", "2", "--prompt-len", "6", "--gen",
                           "3", "--vary-prompts"]) == 0
    out = capsys.readouterr().out
    assert "fixed-length prompts only" in out
    assert "sequential: 2 sessions, 6 tokens" in out
