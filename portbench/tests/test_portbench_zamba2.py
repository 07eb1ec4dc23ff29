"""The cell ``zamba2-2.7b.fl_train_4k`` on the CPU at a tiny size: it
agrees with its plain reference, each fault planted in the port and the
fp8 control come out not correct under its limits, and the reference
is held to transformers' ``Zamba2ForCausalLM`` on the same weights.

The cell lists no faults of its own (``test_portbench_faults.py`` runs
those of every cell through ``tiny.make``, whose configurations do not
shrink this one), so they are planted here, at the tiny size.
"""
import math
import time

import pytest
import torch

from portbench import check, harness, spec
from portbench.reference import zamba2 as ref
from portbench.reference.precision import exact_float32
from portbench.tests import tiny

CELL = "zamba2-2.7b.fl_train_4k"
LAYERS = ["mamba", "hybrid", "mamba", "hybrid", "mamba", "hybrid", "mamba"]
TINY = {"hidden_size": 32, "num_hidden_layers": 7,
        "layers_block_type": LAYERS, "hybrid_layer_ids": [1, 3, 5],
        "mamba_d_state": 8, "n_mamba_heads": 4, "mamba_headdim": 16,
        "intermediate_size": 48, "num_attention_heads": 4,
        "num_key_value_heads": 4, "attention_hidden_size": 64,
        "attention_head_dim": 16, "head_dim": 16, "adapter_rank": 4,
        "vocab_size": 96, "chunk_size": 8, "dtype": "float32"}
SEED = 2**31 + 99
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("portbench")),
                     configs={**tiny.TINY_CONFIGS, "zamba2-2.7b": TINY},
                     traffic={**tiny.TINY_TRAFFIC, "fl_train_4k": {"seq": 16}})


def _run(bench, planted=()):
    return harness.run(bench, bench.cell(CELL), SEED, 0.1, False, CPU,
                       time.perf_counter(), planted)


def test_cell_agrees_with_its_reference(bench):
    out = _run(bench)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    # both sides float32 on one CPU: agreement to rounding, far inside
    # the limits set on the chip for bfloat16
    for name, c in out["checks"].items():
        assert c["value"] <= 1e-5, (name, c)
    assert set(out["metrics"]) == {m["name"] for m in bench.end_to_end(CELL)}


@pytest.mark.parametrize("fault", ["frozen", "half_batch", "no_exchange",
                                   "alter"])
def test_fault_is_not_correct(bench, fault):
    out = _run(bench, (fault,))
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_fp8_control_fails_the_comparison(bench):
    c = bench.cell(CELL)
    prog = bench.entry(c["entry"]).Program(bench, c, SEED, CPU)
    checks = check.judge(check.compare(prog.reference("float8"),
                                       prog.reference()), c["limits"])
    assert not check.passed(checks), checks


def test_layout_and_readers_of_the_cell():
    """At the published sizes: the step's FLOPs, each new reader's cost
    function, and readers that find nothing to read (a program without
    the labels or kernels) return None."""
    bench = spec.Bench()
    cfg, mix = bench.config("zamba2-2.7b"), bench.traffic("fl_train_4k")
    # 6 x 3.853e9 matmul parameters x 8,192 tokens + the shared attention
    flops = bench.entry("fl_train_zamba2").flops_per_step(cfg, mix)
    assert flops == pytest.approx(6 * 3_853_107_200 * 8192 + 9.2785e12,
                                  rel=1e-4)
    ssd = bench.reader("ssd_scan_fwd_roofline")
    f, nbytes = ssd.call_cost(cfg, mix)
    assert f == 80 * 16 * 2 * (256 * 256 * 128 + 2 * 256 * 64 * 64)
    assert nbytes == 2 * (2 * 4096 * 64 + 2 * 80 * 4096 * 64) \
        + 4 * 80 * 4096 + 8 * 80 * 64 * 64
    assert ssd.least_seconds(cfg, mix) * 1e6 == pytest.approx(27.1, abs=0.1)
    flash = bench.reader("flash_fwd_roofline")
    assert flash.least_seconds(cfg, mix) * 1e6 == pytest.approx(173.7,
                                                               abs=0.1)
    empty = type("Ctx", (), {"steps": 1, "cfg": cfg, "mix": mix,
                             "trace": type("T", (), {
                                 "span": staticmethod(lambda label: None),
                                 "kernel": staticmethod(
                                     lambda stem: (0, 0.0))})()})()
    for name in ("ssd_scan_fwd_roofline", "train.ssd_scan.backward.device_ms",
                 "train.shared_block.device_ms"):
        assert bench.reader(name).read(empty) is None


def _hf_model(cfg, W):
    """transformers' Zamba2ForCausalLM with the reference's weights."""
    from transformers import Zamba2Config, Zamba2ForCausalLM

    layers = cfg["layers_block_type"]
    hf = Zamba2Config(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_hidden_layers=len(layers), layers_block_type=layers,
        mamba_d_state=cfg["mamba_d_state"], mamba_d_conv=cfg["mamba_d_conv"],
        mamba_expand=cfg["mamba_expand"], mamba_ngroups=cfg["mamba_ngroups"],
        n_mamba_heads=cfg["n_mamba_heads"],
        intermediate_size=cfg["intermediate_size"],
        num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg["num_key_value_heads"],
        num_mem_blocks=cfg["num_mem_blocks"],
        use_shared_attention_adapter=cfg["use_shared_attention_adapter"],
        adapter_rank=cfg["adapter_rank"], use_mem_rope=cfg["use_mem_rope"],
        chunk_size=cfg["chunk_size"],
        rms_norm_eps=cfg["rms_norm_eps"],
        time_step_min=cfg["time_step_min"], attn_implementation="eager",
        use_cache=False)
    model = Zamba2ForCausalLM(hf).eval()
    sd = {"model.embed_tokens.weight": W["embedding.tok"],
          "lm_head.weight": W["embedding.tok"],
          "model.final_layernorm.weight": W["final_norm"]}
    names = {"input_layernorm.weight": "norm", "mamba.A_log": "a_log",
             "mamba.dt_bias": "dt_bias", "mamba.D": "d_skip",
             "mamba.conv1d.bias": "conv_b", "mamba.norm.weight": "gate_norm"}
    j = 0
    for i, kind in enumerate(layers):
        pre = f"model.layers.{i}." + ("mamba_decoder." if kind == "hybrid"
                                      else "")
        for hf_name, ours in names.items():
            sd[pre + hf_name] = W["mamba." + ours][i]
        sd[pre + "mamba.in_proj.weight"] = W["mamba.in_proj"][i].T
        sd[pre + "mamba.out_proj.weight"] = W["mamba.out_proj"][i].T
        sd[pre + "mamba.conv1d.weight"] = W["mamba.conv_w"][i].T[:, None]
        if kind != "hybrid":
            continue
        b = j % cfg["num_mem_blocks"]
        st = f"model.layers.{i}.shared_transformer."
        sd[st + "input_layernorm.weight"] = W["shared.norm1"][b]
        sd[st + "pre_ff_layernorm.weight"] = W["shared.norm2"][b]
        for x in "qkvo":
            sd[st + f"self_attn.{x}_proj.weight"] = W[f"shared.w{x}"][b].T
        ff = st + "feed_forward."
        sd[ff + "gate_up_proj.weight"] = W["shared.gate_up"][b].T
        sd[ff + "down_proj.weight"] = W["shared.down"][b].T
        sd[ff + f"gate_up_proj_adapter_list.{j}.0.weight"] = \
            W["adapters.mlp_a"][j].T
        sd[ff + f"gate_up_proj_adapter_list.{j}.1.weight"] = \
            W["adapters.mlp_b"][j].T
        sd[f"model.layers.{i}.linear.weight"] = W["adapters.linear"][j].T
        j += 1
    # a shared block's parameters appear under every hybrid layer that
    # applies it; each is loaded under one of its names
    model.load_state_dict(sd, strict=False)
    return model


@pytest.mark.parametrize("layers", [
    LAYERS, ["hybrid", "hybrid", "mamba", "hybrid"]],
    ids=["published", "hybrid_first"])
def test_reference_logits_match_transformers(layers):
    """Within one chunk (16 positions, ``chunk_size`` 16): transformers'
    torch path carries the scan's state from chunk to chunk with the sum
    over the wrong axis of its chunk decay (``.sum(dim=2)`` over the
    destination chunk), so across chunks its logits depend on
    ``chunk_size``; the reference's chunks are held to the recurrence
    itself below. Two layer patterns: the tiny published one, and one
    that opens with two hybrid layers (both shared blocks before any
    Mamba2 layer has run)."""
    pytest.importorskip("transformers")
    cfg = {**spec.Bench().config("zamba2-2.7b"), **TINY, "chunk_size": 16,
           "num_hidden_layers": len(layers), "layers_block_type": layers}
    W = ref.draw(cfg, SEED, CPU)
    model = _hf_model(cfg, W)
    tokens = torch.randint(0, cfg["vocab_size"], (2, 16),
                           generator=torch.Generator().manual_seed(3))
    with torch.no_grad(), exact_float32():
        want = model(input_ids=tokens).logits
        Wl = {k: (list(v.unbind(0)) if k.startswith(ref.STACKS) else v)
              for k, v in W.items()}
        got = ref.logits(Wl, tokens, cfg, torch.matmul)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("chunk", [8, 37, 64])
def test_reference_scan_is_the_recurrence(chunk):
    """``ref.ssd`` in any chunking equals H_t = exp(dt_t A) H_{t-1} + B_t
    (dt_t x_t)^T, y_t = C_t H_t, stepped one position at a time (float64,
    37 positions: several chunks, a ragged last one)."""
    g = torch.Generator().manual_seed(0)
    b, s, nh, p, n = 2, 37, 3, 4, 5
    f64 = dict(generator=g, dtype=torch.float64)
    x, B, C = (torch.randn(b, s, nh, k, **f64) for k in (p, n, n))
    dt = torch.rand(b, s, nh, **f64)
    A = -0.3 * torch.arange(1, nh + 1, dtype=torch.float64)
    H, ys = torch.zeros(b, nh, n, p, dtype=torch.float64), []
    for t in range(s):
        H = H * torch.exp(dt[:, t] * A)[..., None, None] + torch.einsum(
            "bhn,bhp->bhnp", B[:, t], x[:, t] * dt[:, t, :, None])
        ys.append(torch.einsum("bhn,bhnp->bhp", C[:, t], H))
    got = ref.ssd(x, dt, A, B, C, chunk)
    assert torch.allclose(got, torch.stack(ys, 1), rtol=0, atol=1e-12)
    assert math.isfinite(float(got.abs().max()))
