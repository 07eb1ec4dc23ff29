"""The port's published Zamba2 (``models/zamba2.py``) on the CPU.

The loss and every leaf's gradient against the benchmark's plain f32
reference (``portbench/reference/zamba2.py``, written from the published
equations and held to transformers' ``Zamba2ForCausalLM`` in
``portbench/tests/test_portbench_zamba2.py``) on the reference's weights,
at a tiny ``Zamba2Config`` in f32, with and without remat. The shared
blocks' use in turn, the published flags as the only ones either side
takes, the flash wrapper's scale at head dim 160 and the kernel's
layout check. On
the card (marked ``cuda``; it skips without one): the bf16 kernel's
instance at head dim 160 against the plain route.

Tolerances: the loss within 1e-5 of itself; each gradient leaf within
1e-4 of its largest magnitude, as ``test_torch_train_loss.py`` holds
the other families: both sides are f32 on one CPU, summed in other
orders (the port's flash backward blockwise where the reference's
autograd takes the softmax whole, the port's scan sequential where the
reference's is chunked), and against the reference in float64 each side
alone is 4e-6 to 3e-5 off on some leaf, by the seed (the port run in
float64 still reads up to 8e-6: its dt, scan state and gated norm are
f32 by design).
"""
import dataclasses
import math
import os
import sys

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention_flash, zamba2 as Z
from repro_torch.models.model import Model
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from portbench import spec, weights  # noqa: E402
from portbench.reference import zamba2 as ref  # noqa: E402
from portbench.reference.precision import exact_float32  # noqa: E402

LAYERS = ["mamba", "hybrid", "mamba", "hybrid", "mamba", "hybrid", "mamba"]
TINY = {"hidden_size": 32, "num_hidden_layers": 7,
        "layers_block_type": LAYERS, "hybrid_layer_ids": [1, 3, 5],
        "mamba_d_state": 8, "n_mamba_heads": 4, "mamba_headdim": 16,
        "intermediate_size": 48, "num_attention_heads": 4,
        "num_key_value_heads": 4, "attention_hidden_size": 64,
        "attention_head_dim": 16, "head_dim": 16, "adapter_rank": 4,
        "vocab_size": 96, "chunk_size": 8, "dtype": "float32"}
VARIANTS = {
    "published": {},
    "no_remat": {"remat": "none"},
}
#: each published flag turned, in the configuration file's names
OTHER_FLAGS = {"mamba_ngroups": 2, "use_conv_bias": False,
               "use_mem_rope": True, "use_shared_attention_adapter": True,
               "tie_word_embeddings": False}
SEED = 2**31 + 11


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def tiny_config(**changes):
    """The benchmark's configuration file at a tiny size."""
    cfg = spec.Bench().config("zamba2-2.7b")
    cfg.update(TINY)
    cfg.update(changes)
    return cfg


def port_config(cfg):
    return spec.Bench().entry("fl_train_zamba2").port_config(cfg)


def _batch(cfg, b=2, s=13):
    g = torch.Generator().manual_seed(5)
    ids = torch.randint(0, cfg["vocab_size"], (b, s + 1), generator=g)
    return ids[:, :-1], ids[:, 1:]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_gradients_match_the_reference(variant):
    cfg = tiny_config(**VARIANTS[variant])
    model = Model(port_config(cfg))
    flat = ref.draw(cfg, SEED, torch.device("cpu"))
    tokens, labels = _batch(cfg)
    params = weights.nest({k: v.clone().requires_grad_()
                           for k, v in flat.items()})
    leaves = tree_leaves(params)
    loss = model.loss(params, {"tokens": tokens, "labels": labels})
    grads = weights.flatten(tree_unflatten(params, list(
        torch.autograd.grad(loss, leaves))))
    with exact_float32():
        W = {k: [t.clone().requires_grad_() for t in v.unbind(0)]
             if k.startswith(ref.STACKS) else v.clone().requires_grad_()
             for k, v in flat.items()}
        want = ref.loss(W, tokens, labels, cfg, torch.matmul)
        order = list(W)
        parts = [t for k in order for t in (W[k] if isinstance(W[k], list)
                                            else [W[k]])]
        got_parts = torch.autograd.grad(want, parts)
    ref_grads, i = {}, 0
    for k in order:
        n = len(W[k]) if isinstance(W[k], list) else 1
        g = got_parts[i:i + n]
        ref_grads[k] = torch.stack(g) if isinstance(W[k], list) else g[0]
        i += n
    assert abs(float(loss.detach()) - float(want.detach())) \
        <= 1e-5 * abs(float(want.detach()))
    assert set(grads) == set(ref_grads)
    for k, g in ref_grads.items():
        peak = float(g.abs().max())
        assert peak > 0, k
        err = float((grads[k] - g).abs().max())
        assert err <= 1e-4 * peak, (k, err, peak)


def test_shared_blocks_in_turn_and_each_adapter_once(monkeypatch):
    cfg = tiny_config(layers_block_type=["hybrid", "mamba", "hybrid",
                                         "hybrid", "mamba", "hybrid",
                                         "hybrid"],
                      hybrid_layer_ids=[0, 2, 3, 5, 6])
    zcfg = port_config(cfg)
    params = weights.nest(ref.draw(cfg, SEED, torch.device("cpu")))
    block_at = {params["shared"]["wq"][i].data_ptr(): i for i in range(2)}
    adapter_at = {params["adapters"]["linear"][i].data_ptr(): i
                  for i in range(5)}
    seen = []
    original = Z.shared_block

    def spy(bp, ap, *args):
        seen.append((block_at[bp["wq"].data_ptr()],
                     adapter_at[ap["linear"].data_ptr()]))
        return original(bp, ap, *args)

    monkeypatch.setattr(Z, "shared_block", spy)
    tokens, labels = _batch(cfg)
    with torch.no_grad():
        Model(zcfg).loss(params, {"tokens": tokens, "labels": labels})
    assert seen == [(0, 0), (1, 1), (0, 2), (1, 3), (0, 4)]


def test_loss_mask_keeps_the_positions_it_names():
    cfg = tiny_config()
    model = Model(port_config(cfg))
    params = weights.nest(ref.draw(cfg, SEED, torch.device("cpu")))
    tokens, labels = _batch(cfg)
    mask = torch.zeros(tokens.shape)
    mask[:, :5] = 1.0
    with torch.no_grad():
        logits = model.forward(params, tokens)[0]
        nll = torch.logsumexp(logits, -1) - logits.gather(
            -1, labels[..., None])[..., 0]
        got = model.loss(params, {"tokens": tokens, "labels": labels,
                                  "loss_mask": mask})
    assert torch.allclose(got, nll[:, :5].mean(), rtol=1e-6, atol=0)


def test_published_sizes_and_layout():
    cfg = spec.Bench().config("zamba2-2.7b")
    zcfg = port_config(cfg)
    assert zcfg.param_count() == cfg["parameters"] == 2_662_214_560
    assert list(zcfg.hybrid_layer_ids) == cfg["hybrid_layer_ids"] \
        == [6, 12, 18, 24, 30, 36, 42, 47, 51]
    assert (zcfg.head_dim, zcfg.mamba_heads, zcfg.conv_dim) == (160, 80,
                                                                 5248)
    port = weights.flatten(tree_map(lambda x: x, Model(zcfg).init_shape()))
    assert {p: tuple(x.shape) for p, x in port.items()} \
        == {p: shape for p, shape, *_ in ref.leaves(cfg)}
    assert all(x.dtype == torch.bfloat16 for x in port.values())


def test_decode_and_serving_are_refused():
    model = Model(port_config(tiny_config()))
    with pytest.raises(ValueError, match="out of scope"):
        model.init_cache(1, 8, device="cpu")
    with pytest.raises(ValueError, match="decode cache"):
        model.forward({}, torch.zeros(1, 4, dtype=torch.long),
                      collect_cache=True)


def test_flash_scale_through_the_plain_route_at_d160():
    """Zamba2's (160 / 2) ** -0.5 through the wrapper's plain route and
    ``FlashAttention``'s backward, against the softmax written out."""
    g = torch.Generator().manual_seed(0)
    b, s, h, d = 1, 12, 2, 160
    scale = (d / 2) ** -0.5
    q, k, v = (torch.randn(b, s, h, d, generator=g) for _ in range(3))
    causal = torch.ones(s, s, dtype=torch.bool).tril()

    def plain(q, k, v):
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        p = torch.softmax(sc.masked_fill(~causal, -math.inf), -1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v), \
            torch.logsumexp(sc.masked_fill(~causal, -math.inf), -1)

    o, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    o_want, lse_want = plain(q, k, v)
    assert torch.allclose(o, o_want, atol=1e-5)
    assert torch.allclose(lse, lse_want, atol=1e-5)
    o1, _ = fa.flash_attention_fwd(q, k, v, True)
    assert not torch.allclose(o1, o, atol=1e-3)      # 1/sqrt(160) differs
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = attention_flash.FlashAttention.apply(*leaves, True, 4, 8,
                                               scale)[0]
    cot = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad(out, leaves, cot)
    twins = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(plain(*twins)[0], twins, cot)
    for a, w in zip(got, want):
        assert torch.allclose(a, w, atol=1e-5)


@pytest.mark.parametrize("d,dtype,ok", [
    (160, torch.bfloat16, True), (128, torch.bfloat16, True),
    (136, torch.bfloat16, False), (144, torch.bfloat16, False),
    (168, torch.bfloat16, False), (160, torch.float32, False),
    (136, torch.float32, False)])
def test_flash_layout_takes_160_and_refuses_others_above_128(d, dtype, ok):
    args = (torch.zeros(1, 8, 4, d, dtype=dtype),
            torch.zeros(1, 8, 4, d, dtype=dtype),
            torch.zeros(1, 8, 4, d, dtype=dtype))
    if ok:
        fa.check_layout(*args)
    else:
        with pytest.raises(ValueError, match="head_dim"):
            fa.check_layout(*args)


@pytest.mark.parametrize("flag", sorted(OTHER_FLAGS))
def test_port_and_reference_take_only_the_published_flags(flag):
    """Rotary positions, attention adapters, more groups, no conv bias or
    untied embeddings have no code on either side: both refuse them."""
    cfg = tiny_config(**{flag: OTHER_FLAGS[flag]})
    with pytest.raises(ValueError, match="published flags"):
        port_config(cfg)
    with pytest.raises(ValueError, match="flags"):
        ref.leaves(cfg)


def test_zamba2_config_refuses_inconsistent_widths():
    base = port_config(tiny_config())
    with pytest.raises(ValueError, match="attention_hidden_size"):
        dataclasses.replace(base, attention_head_dim=8, head_dim=8)
    with pytest.raises(ValueError, match="layers_block_type"):
        dataclasses.replace(base, num_layers=6)
    with pytest.raises(ValueError, match="family"):
        dataclasses.replace(base, family="hybrid")
    with pytest.raises(ValueError, match="k and v heads"):
        dataclasses.replace(base, num_kv_heads=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s", [200, 1024])
def test_d160_kernel_matches_the_plain_route(cuda, s):
    """The bf16 instance at d = 160 with Zamba2's scale, causal, a ragged
    and a whole last tile: o within 2e-2 of the f32 plain route's peak
    (P is rounded to bf16 before its product with V), lse within 1e-4."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, s, 4, 160, generator=g, device=cuda,
                           dtype=torch.bfloat16) for _ in range(3))
    scale = 80 ** -0.5
    before = fa.launches
    o, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    o_ref, lse_ref = fa.flash_attention_ref(q.float(), k.float(), v.float(),
                                            True, scale)
    peak = float(o_ref.abs().max())
    assert float((o.float() - o_ref).abs().max()) <= 2e-2 * peak
    assert float((lse - lse_ref).abs().max()) <= 1e-4


def test_chip_smoke_counts_are_the_models(monkeypatch):
    """``chip_smoke.ZAMBA2_PUBLISHED``, the launch counts its
    ``train_zamba2`` phase holds the card to: the cell's peers and
    length, the published parameters, one mar_rounds launch a leaf of
    theta and of m, and a flash and an SSD-scan call in the forward and
    again in the remat recompute of every shared-block application and
    Mamba2 layer, counted here on a tiny step on the CPU."""
    from repro_torch.core import fl_device
    from repro_torch.core.moshpit import plan_grid
    from repro_torch.models import ssm

    monkeypatch.syspath_prepend(_ROOT)
    import chip_smoke
    z = chip_smoke.ZAMBA2_PUBLISHED
    sys.modules.pop("chip_smoke", None)
    bench = spec.Bench()
    cfg = bench.config(z["config"])
    mix = bench.traffic(bench.cell("zamba2-2.7b.fl_train_4k")["traffic"])
    assert (z["peers"], z["seq"]) == (mix["peers"], mix["seq"])
    zcfg = port_config(cfg)
    assert zcfg.param_count() == z["params"]
    shape = fl_device.fl_state_shape(Model(zcfg), z["peers"])
    assert 2 * len(tree_leaves(shape["params"])) == z["mar_rounds_per_step"]
    per_call = 2 * z["peers"]                  # forward and recompute
    assert z["flash_per_step"] == per_call * len(zcfg.hybrid_layer_ids)
    assert z["ssd_per_step"] == per_call * zcfg.num_layers

    tiny = port_config(tiny_config())
    calls = {"flash": 0, "ssd": 0}
    flash, ssd = attention_flash.FlashAttention.apply, ssm.mamba_ssd

    def count(name, fn):
        def spy(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return spy

    monkeypatch.setattr(attention_flash.FlashAttention, "apply",
                        count("flash", flash))
    monkeypatch.setattr(ssm, "mamba_ssd", count("ssd", ssd))
    model, peers = Model(tiny), z["peers"]
    state = fl_device.init_fl_state(model, peers, device="cpu")
    step = fl_device.make_fl_train_step(model, plan_grid(peers))
    tokens, labels = _batch(tiny_config(), b=peers, s=8)
    step(state, {"tokens": tokens.view(peers, 1, 1, 1, 8),
                 "labels": labels.view(peers, 1, 1, 1, 8)})
    assert calls == {"flash": per_call * len(tiny.hybrid_layer_ids),
                     "ssd": per_call * tiny.num_layers}
