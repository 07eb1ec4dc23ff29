"""The port's MoE FFN and the moe family against the JAX package's.

The reference's weights cross into the port through
``repro_torch.convert``; the inputs are made from a seed with numpy. The
moe smoke configs (moonshot-v1-16b-a3b: 8 experts top-2, 1 shared, kv
4; kimi-k2-1t-a32b: the same with kv 2) run in f32 with
``attn_impl="xla"``.

Tolerances: ``moe_block`` and the dense oracle f32 1e-5 (the same f32
products, summed in other orders); ``router_probs``' gates and the
load-balance loss 1e-6; bf16 ``moe_block`` 2e-2 relative to the output's
largest magnitude (torch and XLA round the bf16 products' outputs at
different places; observed below 1e-2); the forward's logits and aux
1e-4; the prefill handoff against replay 2e-4, as the reference's
``tests/test_serve.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.models import moe as RM
from repro.models.model import Model as RefModel
from repro.serve import DecodeServer as RefDecodeServer
from repro.serve import ServeConfig as RefServeConfig

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.serve import DecodeServer, ServeConfig, run_sequential

MOE_ARCHS = ["moonshot-v1-16b-a3b", "kimi-k2-1t-a32b"]


def _cfgs(arch="moonshot-v1-16b-a3b", **kw):
    kw = {"dtype": "float32", "attn_impl": "xla", **kw}
    return (dataclasses.replace(ref_smoke_config(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _block_pair(dtype="float32"):
    ref_cfg, cfg = _cfgs(dtype=dtype)
    ref_p = RM.moe_init(jax.random.PRNGKey(0), ref_cfg)
    return ref_cfg, ref_p, cfg, convert.params_from_numpy(
        jax.tree.map(np.asarray, ref_p))


def _x(cfg, t, skew=0.0, seed=0, router=None):
    """[2, t, d] normal inputs; ``skew`` pushes every token towards
    expert 0's router column, so that expert overflows."""
    x = np.random.default_rng(seed).standard_normal(
        (2, t, cfg.d_model)).astype(np.float32)
    if skew:
        col = np.asarray(router)[:, 0]
        x += skew * col / np.linalg.norm(col)
    return x


def _overflow(cfg, params, x):
    """How many assignments the capacity drops."""
    _, idx = M.router_probs(params, torch.from_numpy(x.reshape(
        -1, cfg.d_model)), cfg)
    counts = np.bincount(idx.numpy().ravel(), minlength=cfg.num_experts)
    return int(np.maximum(counts - M.capacity(idx.shape[0], cfg), 0).sum())


@pytest.mark.parametrize("case", ["drop_free", "with_drops"])
def test_moe_block_matches_reference(case):
    ref_cfg, ref_p, cfg, p = _block_pair()
    x = _x(cfg, 12) if case == "drop_free" else \
        _x(cfg, 48, skew=6.0, router=ref_p["router"])
    dropped = _overflow(cfg, p, x)
    assert (dropped > 0) == (case == "with_drops"), dropped
    want = np.asarray(RM.moe_block(ref_p, jnp.asarray(x), ref_cfg))
    got = M.moe_block(p, torch.from_numpy(x), cfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    if case == "drop_free":
        oracle = M.moe_block_dense_oracle(p, torch.from_numpy(x), cfg)
        np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_dense_oracle_router_and_aux_match_reference():
    ref_cfg, ref_p, cfg, p = _block_pair()
    x = _x(cfg, 20, seed=1)
    xf = x.reshape(-1, cfg.d_model)
    np.testing.assert_allclose(
        M.moe_block_dense_oracle(p, torch.from_numpy(x), cfg).numpy(),
        np.asarray(RM.moe_block_dense_oracle(ref_p, jnp.asarray(x),
                                             ref_cfg)),
        atol=1e-5, rtol=1e-5)
    gates, idx = M.router_probs(p, torch.from_numpy(xf), cfg)
    ref_gates, ref_idx = RM.router_probs(ref_p, jnp.asarray(xf), ref_cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(ref_gates),
                               atol=1e-6, rtol=0)
    assert p["router"].dtype == torch.float32
    np.testing.assert_allclose(
        float(M.load_balance_loss(p, torch.from_numpy(xf), cfg)),
        float(RM.load_balance_loss(ref_p, jnp.asarray(xf), ref_cfg)),
        atol=1e-6, rtol=0)


def test_moe_block_bf16_matches_reference():
    ref_cfg, ref_p, cfg, p = _block_pair("bfloat16")
    assert p["router"].dtype == torch.float32
    assert p["wg"].dtype == torch.bfloat16
    x = _x(cfg, 48, skew=6.0, router=ref_p["router"])
    assert _overflow(cfg, p, x) > 0
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(RM.moe_block(ref_p, xb, ref_cfg).astype(jnp.float32))
    got = M.moe_block(p, convert.params_from_numpy(np.asarray(xb)), cfg)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


def test_combine_is_deterministic_and_in_expert_order():
    """Two calls agree bit for bit, and each token's contributions add
    in ascending expert id from zero: the same sum written out by
    hand."""
    _, _, cfg, p = _block_pair()
    x = torch.from_numpy(_x(cfg, 7, seed=4))
    a, b = M.moe_block(p, x, cfg), M.moe_block(p, x, cfg)
    assert torch.equal(a, b)
    xf = x.reshape(-1, cfg.d_model)
    gates, idx = M.router_probs(p, xf, cfg)
    rows = []
    for i in range(xf.shape[0]):
        y = torch.zeros(cfg.d_model)
        for j in torch.argsort(idx[i]).tolist():
            ex = int(idx[i, j])
            hdn = torch.nn.functional.silu(xf[i] @ p["wg"][ex]) * \
                (xf[i] @ p["wu"][ex])
            y = y + (hdn @ p["wd"][ex]) * gates[i, j]
        rows.append(y)
    shared = M.mlp_block(p["shared"], xf)
    torch.testing.assert_close(a.reshape(-1, cfg.d_model),
                               torch.stack(rows) + shared, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_matches_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    ref_model = RefModel(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, ref_params))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 11)) \
        .astype(np.int32)
    ref_logits, ref_aux, ref_cache = ref_model.forward(
        ref_params, jnp.asarray(toks), collect_cache=True)
    logits, aux, cache = Model(cfg).forward(
        params, torch.from_numpy(toks), collect_cache=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=1e-4, rtol=1e-4)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(ref_aux), atol=1e-4,
                               rtol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(ref_cache[key]), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_has_the_references_layout(arch):
    ref_cfg, cfg = _cfgs(arch, dtype="bfloat16")
    ref_params = jax.tree.map(np.asarray,
                              RefModel(ref_cfg).init(jax.random.PRNGKey(0)))
    got = convert.params_to_numpy(Model(cfg).init(seed=0, device="cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(ref_params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref_params)):
        assert a.shape == b.shape
        assert a.dtype.itemsize == b.dtype.itemsize


def test_prefill_handoff_matches_replay():
    """The decode-ready cache of a prefill continues as token-by-token
    replay from scratch does (capacity lifted so that a 6-token prefill
    and 1-token steps route alike, as the reference's test)."""
    _, cfg = _cfgs(moe_capacity_factor=8.0)
    model = Model(cfg)
    params = model.init(seed=3, device="cpu")
    s, max_len = 6, 10
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, max_len)).astype(np.int32))
    cache = model.init_cache(2, max_len, device="cpu")
    replay = []
    for i in range(max_len):
        lg, cache = model.decode_step(params, cache, toks[:, i])
        replay.append(lg)
    logits, _, raw = model.forward(params, toks[:, :s], collect_cache=True)
    dcache = model.prefill_cache_to_decode(raw, max_len, s)
    outs = [logits[:, -1]]
    for i in range(s, max_len):
        lg, dcache = model.decode_step(params, dcache, toks[:, i])
        outs.append(lg)
    torch.testing.assert_close(torch.stack(outs, 1),
                               torch.stack(replay[s - 1:], 1), rtol=2e-4,
                               atol=2e-4)


def test_paged_decode_step_matches_reference():
    ref_cfg, cfg = _cfgs()
    ref_model = RefModel(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(1))
    model = Model(cfg)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, ref_params))
    b, bs, nblk = 2, 4, 2
    bt = np.array([[1 + i * nblk + j for j in range(nblk)]
                   for i in range(b)], np.int32)
    ref_pages = ref_model.init_paged_cache(1 + b * nblk, bs)
    pages = model.init_paged_cache(1 + b * nblk, bs, device="cpu")
    pos, tok = np.zeros((b,), np.int32), np.array([3, 7], np.int32)
    for _ in range(bs * nblk):
        ref_logits, ref_pages = ref_model.paged_decode_step(
            ref_params, ref_pages, jnp.asarray(bt), jnp.asarray(pos),
            jnp.asarray(tok))
        logits, pages = model.paged_decode_step(
            params, pages, torch.from_numpy(bt), torch.from_numpy(pos),
            torch.from_numpy(tok))
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   atol=1e-4, rtol=1e-4)
        tok, pos = logits.argmax(-1).to(torch.int32).numpy(), pos + 1


def test_engine_streams_equal_the_reference_engine():
    """moonshot's smoke config in f32: the port's engine and the
    reference's give the same greedy streams, and the port's engine
    equals its sequential baseline (batch 3 <= 8 keeps cap = 8 in every
    decode step, so no assignment drops)."""
    ref_cfg, cfg = _cfgs()
    ref_model = RefModel(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = Model(cfg)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, ref_params))
    kw = dict(max_batch=3, block_size=4, num_blocks=40, pad_len=12,
              max_new=5)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(1, 13)).tolist()
               for _ in range(6)]
    srv = DecodeServer(model, params, ServeConfig(**kw))
    ref = RefDecodeServer(ref_model, ref_params, RefServeConfig(**kw))
    for p in prompts:
        srv.enqueue(p)
        ref.enqueue(p)
    srv.run()
    ref.run()
    srv.assert_quiescent()
    eng = {s.sid: s.generated for s in srv.finished}
    assert eng == {s.sid: s.generated for s in ref.finished}
    seq = run_sequential(model, params, prompts, max_new=5, pad_len=12)
    assert all(eng[s.sid] == s.generated for s in seq)


def test_moe_is_a_paged_family():
    cfg = get_smoke_config("moonshot-v1-16b-a3b")
    assert "moe" in T.PAGED_FAMILIES and "moe" in T.DENSE_FAMILIES
    T.check_supported(cfg)
    pages = T.init_paged_cache(cfg, 3, 4, "cpu")
    assert pages["k_pages"].shape == (cfg.num_layers, 3, 4,
                                      cfg.num_kv_heads, cfg.head_dim)
    assert M.capacity(8, get_smoke_config("moonshot-v1-16b-a3b")) == 8
