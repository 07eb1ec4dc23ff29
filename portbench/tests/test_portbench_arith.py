"""The yardstick's arithmetic against hand counts, the trace reader on
hand-made events, and the generators' and weights' layouts against the
port's."""
import math
from types import SimpleNamespace

import pytest
import torch

from portbench import gen, peaks, spec, trace, weights

BENCH = spec.Bench()


def test_group_mean_round_bound_at_n125():
    gm = BENCH.reader("group_mean_roofline")
    cfg, mix = BENCH.config("marfl-text-mlp"), BENCH.traffic("fed_n125")
    # theta and m of 125 peers, 101,012 f32 each, read once, written once
    assert gm.round_bytes(cfg, mix) == 2 * 2 * 125 * 101_012 * 4 + 4 * 125
    assert gm.least_seconds_per_round(cfg, mix) * 1e6 == pytest.approx(
        60.3, abs=0.05)


@pytest.mark.parametrize("traffic,bound_us,bytes_bound", [
    ("fl_train", 0.95, True), ("fl_train_30s", 6.99, False)])
def test_flash_call_bound(traffic, bound_us, bytes_bound):
    fl = BENCH.reader("flash_fwd_roofline")
    cfg, mix = BENCH.config("musicgen-medium"), BENCH.traffic(traffic)
    flops, nbytes = fl.call_cost(cfg, mix)
    assert fl.least_seconds(cfg, mix) * 1e6 == pytest.approx(bound_us,
                                                            abs=0.01)
    assert (nbytes / peaks.HBM_BYTES_PER_S
            > flops / peaks.PEAK_FLOPS["bfloat16"]) == bytes_bound


def test_flash_call_cost_by_hand():
    fl = BENCH.reader("flash_fwd_roofline")
    cfg, mix = BENCH.config("musicgen-medium"), BENCH.traffic("fl_train")
    flops, nbytes = fl.call_cost(cfg, mix)
    b, s, h, d = 2, 128, 24, 64
    assert flops == 4 * b * h * d * s * (s + 1) / 2
    assert nbytes == 2 * 4 * b * s * h * d + 4 * b * h * s


def test_train_step_flops():
    fl_train = BENCH.entry("fl_train")
    cfg = BENCH.config("musicgen-medium")
    one = fl_train.flops_per_step(cfg, BENCH.traffic("fl_train"))
    # 6 x 1.815e9 matmul parameters x 1,024 tokens, plus attention
    assert one == pytest.approx(1.121e13, rel=2e-3)
    crop = fl_train.flops_per_step(cfg, BENCH.traffic("fl_train_30s"))
    assert crop == pytest.approx(1.31e14 + 0.09e14, rel=0.05)


def test_federation_flops():
    fed = BENCH.entry("federation")
    got = fed.flops_per_step(BENCH.config("marfl-text-mlp"),
                             BENCH.traffic("fed_n125"))
    assert got == 6 * 101_012 * 125 * 16


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12, "float32") == pytest.approx(1.0)


@pytest.mark.parametrize("config", ["musicgen-medium"])
def test_lm_layout_is_the_ports(config):
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_map

    fl_train = BENCH.entry("fl_train")
    cfg = BENCH.config(config)
    port = weights.flatten(tree_map(lambda x: x, Model(
        fl_train.port_config(cfg)).init_shape()))
    ours = {p: shape for p, shape, *_ in weights.lm_leaves(cfg)}
    assert {p: tuple(x.shape) for p, x in port.items()} == ours
    assert all(x.dtype == weights.dtype_of(cfg) for x in port.values())


def test_mlp_layout_is_the_ports():
    from repro_torch.models.small import mlp_init

    cfg = BENCH.config("marfl-text-mlp")
    port = weights.flatten(mlp_init(torch.Generator().manual_seed(0),
                                    cfg["feature_dim"], cfg["num_classes"],
                                    cfg["hidden"]))
    ours = {p: shape for p, shape, *_ in weights.mlp_leaves(cfg)}
    assert {p: tuple(x.shape) for p, x in port.items()} == ours
    assert sum(math.prod(s) for s in ours.values()) == 101_012


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 2**40 + 3])
def test_draws_repeat_for_a_seed(seed):
    mix = BENCH.traffic("fl_train")
    cpu = torch.device("cpu")
    a = gen.lm_batch(mix, 2048, seed, gen.CHECK, 0, cpu)
    b = gen.lm_batch(mix, 2048, seed, gen.CHECK, 0, cpu)
    c = gen.lm_batch(mix, 2048, seed, gen.CHECK, 1, cpu)
    d = gen.lm_batch(mix, 2048, seed, gen.WINDOW, 0, cpu)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], d["tokens"])
    assert torch.equal(a["tokens"][..., 1:], a["labels"][..., :-1])
    assert a["tokens"].shape == (4, 1, 1, 2, 128)
    assert 0 <= int(a["tokens"].min()) and int(a["tokens"].max()) < 2048
    assert 0 <= gen.stream_seed(seed, 1, 0) < 2**63


def test_leaf_redraw_is_the_same_leaf():
    cfg = {"model": "mlp", "feature_dim": 8, "hidden": 4,
           "num_classes": 3, "dtype": "float32"}
    leaves = weights.mlp_leaves(cfg)
    full = weights.draw(cfg, 5, torch.device("cpu"))
    i = [p for p, *_ in leaves].index("fc2.w")
    again = weights.draw_leaf(leaves, i, 5, torch.float32,
                              torch.device("cpu"))
    assert torch.equal(full["fc2.w"], again)


# -- the trace reader on hand-made events ----------------------------------

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _ev(name, start, end, dev=CPU, id=0, thread=1):
    return SimpleNamespace(name=name, device_type=dev, id=id, thread=thread,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=False)


def _events():
    return [
        _ev(trace.WINDOW, 0, 100),
        _ev("train.local_update", 0, 60),
        _ev("cudaLaunchKernel", 10, 11, id=1),
        _ev("cudaLaunchKernel", 20, 21, id=2),
        _ev("aten::mm", 30, 58),
        _ev("train.aggregate", 60, 100),
        _ev("cudaLaunchKernel", 70, 71, id=3),
        _ev("gemm_kernel", 12, 30, CUDA, id=1),
        _ev("flash_fwd_bf16_kernel<64>", 22, 32, CUDA, id=2),
        _ev("train.local_update", 0, 60, CUDA),      # the label's GPU range
        _ev("mean_kernel", 72, 90, CUDA, id=3),
    ]


def test_trace_spans_busy_and_kernels():
    s = trace.summarize(_events(), ["train.local_update", "train.aggregate"])
    lu, ag = s.span("train.local_update"), s.span("train.aggregate")
    assert (lu.host_us, lu.launches, lu.device_us) == (60, 2, 28)
    assert (ag.host_us, ag.launches, ag.device_us) == (40, 1, 18)
    assert s.window_us == 100
    assert s.busy_us == (32 - 12) + (90 - 72)
    assert s.kernel("flash_fwd") == (1, 10)
    assert s.device_ops[0] == ("gemm_kernel", 18e-6)
    idle = dict(s.idle_gaps)
    assert sum(idle.values()) == pytest.approx((100 - 38) / 1e6)
    # gaps 0-12, 32-72 (its middle inside aten::mm) and 90-100
    assert idle == pytest.approx({"train.local_update/python": 12e-6,
                                  "train.local_update/aten::mm": 40e-6,
                                  "train.aggregate/python": 10e-6})


def test_trace_without_device_time_raises():
    events = [e for e in _events() if e.device_type == CPU]
    with pytest.raises(RuntimeError, match="no device time"):
        trace.summarize(events, ["train.local_update"])


def test_trace_needs_one_window():
    events = [e for e in _events() if e.name != trace.WINDOW]
    with pytest.raises(RuntimeError, match="ranges"):
        trace.summarize(events, [])
