"""The port's dense LM (configs, layers, transformer, Model) against the
JAX package's, on the same weights.

The reference's parameters (``Model(cfg).init(key)``) cross into the port
through ``repro_torch.convert`` unchanged, so both packages run the same
weights on the same numpy-made tokens at smoke size
(``get_smoke_config("starcoder2-3b")``: 4 layers, d 128). The reference
runs ``attn_impl="pallas"`` through its Pallas kernel in interpret mode;
the port runs every implementation through its kernels' plain versions
(it is on the CPU).

Tolerances: f32 1e-5 (the same f32 math, summed in other orders). bf16
0.125 on logits of magnitude up to ~4, i.e. four bf16 ulps there: the two
frameworks round intermediate bf16 results at different places
(observed ~0.05).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.models.model import Model as RefModel

from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.model import Model

TOL = {"float32": 1e-5, "bfloat16": 0.125}


def _cfgs(dtype="float32", attn_impl="xla"):
    kw = dict(dtype=dtype, attn_impl=attn_impl)
    return (dataclasses.replace(ref_smoke_config("starcoder2-3b"), **kw),
            dataclasses.replace(get_smoke_config("starcoder2-3b"), **kw))


@pytest.fixture(scope="module")
def f32_pair():
    ref_cfg, cfg = _cfgs()
    ref_model = RefModel(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, ref_params))
    return ref_model, ref_params, Model(cfg), params


def _tokens(shape, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def _close(got, want, dtype="float32"):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------

def test_configs_are_the_references():
    from repro.configs.registry import ARCH_IDS as REF_IDS
    from repro.configs.registry import get_config as ref_get_config
    assert ARCH_IDS == REF_IDS
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(ref_get_config(arch))
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(ref_smoke_config(arch))
        assert get_config(arch).param_count() == \
            ref_get_config(arch).param_count()
    assert get_config("starcoder2-3b").param_count() == 4_312_980_480


def test_group_layout_is_the_references():
    from repro.configs.registry import get_config as ref_get_config
    from repro.models.transformer import group_layout as ref_group_layout
    for arch in ARCH_IDS:
        for get, ref_get in ((get_config, ref_get_config),
                             (get_smoke_config, ref_smoke_config)):
            assert T.group_layout(get(arch)) == \
                ref_group_layout(ref_get(arch))


def test_bf16_params_cross_bit_exactly_both_ways():
    ref_cfg, _ = _cfgs(dtype="bfloat16")
    ref_params = jax.tree.map(np.asarray,
                              RefModel(ref_cfg).init(jax.random.PRNGKey(1)))
    params = convert.params_from_numpy(ref_params)
    leaves = jax.tree.leaves(ref_params)
    assert all(x.dtype.name == "bfloat16" for x in leaves)
    back = convert.params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(ref_params)
    for got, want in zip(jax.tree.leaves(back), leaves):
        assert got.dtype == np.uint16 and got.shape == want.shape
        np.testing.assert_array_equal(got, want.view(np.uint16))
    for t, want in zip(jax.tree.leaves(params, is_leaf=torch.is_tensor),
                       leaves):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      want.astype(np.float32))


def test_init_matches_reference_layout_and_distributions():
    ref_cfg, cfg = _cfgs(dtype="bfloat16")
    ref_params = RefModel(ref_cfg).init(jax.random.PRNGKey(0))
    params = Model(cfg).init(seed=0, device="cpu")
    got = convert.params_to_numpy(params)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, ref_params))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref_params)):
        assert a.shape == b.shape
    assert all(t.dtype == torch.bfloat16 for t in
               jax.tree.leaves(params, is_leaf=torch.is_tensor))
    wq = params["blocks"]["attn"]["wq"].float()            # [L, d, h*hd]
    assert abs(wq.std().item() * np.sqrt(cfg.d_model) - 1) < 0.05
    tok = params["embedding"]["tok"].float()
    assert abs(tok.std().item() / 0.02 - 1) < 0.05
    assert bool((params["blocks"]["norm1"] == 1).all())
    assert bool((params["final_norm"] == 1).all())
    # a seed is a seed: the same draws again, other draws for another
    again = Model(cfg).init(seed=0, device="cpu")
    assert torch.equal(again["blocks"]["mlp"]["wd"],
                       params["blocks"]["mlp"]["wd"])
    other = Model(cfg).init(seed=1, device="cpu")
    assert not torch.equal(other["blocks"]["mlp"]["wd"],
                           params["blocks"]["mlp"]["wd"])


# ---------------------------------------------------------------------------
# forward, decode and the prefill handoff against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl", ["xla", "flash", "pallas"])
def test_forward_matches_reference(attn_impl, dtype):
    ref_cfg, cfg = _cfgs(dtype, attn_impl)
    ref_model = RefModel(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, ref_params))
    toks = _tokens((2, 11))
    ref_logits, _, ref_cache = ref_model.forward(ref_params,
                                                 jnp.asarray(toks),
                                                 collect_cache=True)
    logits, aux, cache = Model(cfg).forward(params, torch.from_numpy(toks),
                                            collect_cache=True)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    _close(logits, ref_logits, dtype)
    for key in ("k", "v"):
        assert tuple(cache[key].shape) == ref_cache[key].shape
        _close(cache[key], ref_cache[key], dtype)
    assert cache["pos"].tolist() == np.asarray(ref_cache["pos"]).tolist()


def test_decode_step_matches_reference(f32_pair):
    ref_model, ref_params, model, params = f32_pair
    toks = _tokens((2, 6), seed=1)
    ref_cache = ref_model.init_cache(2, max_len=8)
    cache = model.init_cache(2, max_len=8, device="cpu")
    for i in range(6):
        ref_logits, ref_cache = ref_model.decode_step(
            ref_params, ref_cache, jnp.asarray(toks[:, i]))
        logits, cache = model.decode_step(params, cache,
                                          torch.from_numpy(toks[:, i]))
        _close(logits, ref_logits)
    _close(cache["k"], ref_cache["k"])
    assert cache["pos"].tolist() == [6, 6]


def test_prefill_handoff_matches_reference_and_replay(f32_pair):
    """``prefill_cache_to_decode`` on right-padded prompts: the converted
    cache equals the reference's, and its continuation equals the
    reference's continuation."""
    ref_model, ref_params, model, params = f32_pair
    pad, max_len = 8, 12
    toks = _tokens((2, pad), seed=2)
    lengths = np.array([5, 8], np.int32)
    _, _, ref_raw = ref_model.forward(ref_params, jnp.asarray(toks),
                                      collect_cache=True)
    _, _, raw = model.forward(params, torch.from_numpy(toks),
                              collect_cache=True)
    ref_cache = ref_model.prefill_cache_to_decode(
        ref_raw, max_len, pad, lengths=jnp.asarray(lengths))
    cache = model.prefill_cache_to_decode(raw, max_len, pad,
                                          lengths=torch.from_numpy(lengths))
    assert tuple(cache["k"].shape) == ref_cache["k"].shape
    _close(cache["k"], ref_cache["k"])
    assert cache["pos"].tolist() == lengths.tolist()
    nxt = _tokens((2, 3), seed=3)
    for i in range(3):
        ref_logits, ref_cache = ref_model.decode_step(
            ref_params, ref_cache, jnp.asarray(nxt[:, i]))
        logits, cache = model.decode_step(params, cache,
                                          torch.from_numpy(nxt[:, i]))
        _close(logits, ref_logits)


def test_paged_decode_step_matches_reference_and_dense(f32_pair):
    """The paged pool against the reference's, and against the port's
    own dense cache, as ``tests/test_serve.py`` holds the reference."""
    ref_model, ref_params, model, params = f32_pair
    b, bs, nblk = 2, 4, 3
    bt = np.array([[1 + i * nblk + j for j in range(nblk)]
                   for i in range(b)], np.int32)
    ref_pages = ref_model.init_paged_cache(num_blocks=1 + b * nblk,
                                           block_size=bs)
    pages = model.init_paged_cache(1 + b * nblk, bs, device="cpu")
    cache = model.init_cache(b, max_len=bs * nblk, device="cpu")
    pos = np.zeros((b,), np.int32)
    tok = np.array([3, 7], np.int32)
    for _ in range(bs * nblk):
        ref_logits, ref_pages = ref_model.paged_decode_step(
            ref_params, ref_pages, jnp.asarray(bt), jnp.asarray(pos),
            jnp.asarray(tok))
        logits, pages = model.paged_decode_step(
            params, pages, torch.from_numpy(bt), torch.from_numpy(pos),
            torch.from_numpy(tok))
        dense_logits, cache = model.decode_step(params, cache,
                                                torch.from_numpy(tok))
        _close(logits, ref_logits)
        torch.testing.assert_close(logits, dense_logits, rtol=0, atol=1e-5)
        tok, pos = logits.argmax(-1).to(torch.int32).numpy(), pos + 1
    _close(pages["k_pages"], ref_pages["k_pages"])


def test_pool_is_updated_in_place(f32_pair):
    _, _, model, params = f32_pair
    pages = model.init_paged_cache(3, 4, device="cpu")
    k_pages = pages["k_pages"]
    _, out = model.paged_decode_step(
        params, pages, torch.tensor([[1], [2]], dtype=torch.int32),
        torch.tensor([0, 1], dtype=torch.int32),
        torch.tensor([5, 6], dtype=torch.int32))
    assert out["k_pages"] is k_pages
    assert k_pages[:, 1, 0].abs().sum() > 0 and k_pages[:, 2, 1].abs().sum() > 0
    assert k_pages[:, 0].abs().sum() == 0           # nobody wrote scratch


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_init_runs_on_cuda_by_default_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(get_smoke_config("starcoder2-3b")).init(seed=0)


@pytest.mark.parametrize("arch", ["pixtral-12b", "musicgen-medium"])
def test_unported_families_raise(arch):
    cfg = get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        Model(cfg).init(seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        T.check_supported(cfg)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "moonshot-v1-16b-a3b"])
def test_moe_families_init_and_forward(arch):
    """The moe configs, once refused here, init with their experts and
    run forward with a positive load-balance aux."""
    cfg = get_smoke_config(arch)
    T.check_supported(cfg)
    params = Model(cfg).init(seed=0, device="cpu")
    moe = params["blocks"]["moe"]
    assert moe["wg"].shape == (cfg.num_layers, cfg.num_experts,
                               cfg.d_model, cfg.d_ff)
    assert moe["router"].dtype == torch.float32
    assert "mlp" not in params["blocks"]
    logits, aux, _ = Model(cfg).forward(params, torch.from_numpy(
        _tokens((2, 5))))
    assert logits.shape == (2, 5, cfg.vocab_size) and float(aux) > 0


def test_layer_views_share_storage(f32_pair):
    _, _, _, params = f32_pair
    view = T.layer(params["blocks"], 2)
    assert view["attn"]["wq"].data_ptr() == \
        params["blocks"]["attn"]["wq"][2].data_ptr()
