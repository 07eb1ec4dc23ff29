"""The executed-step cost analysis (``repro_torch.runtime.op_analysis``)
and the roofline terms (``repro_torch.runtime.roofline``): the cases of
the reference's ``tests/test_roofline_analysis.py`` that keep a meaning
without HLO text, ``model_flops_estimate`` against the reference's for
every arch x shape, and the H100 constants."""
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.configs.registry import get_config as ref_config
from repro.runtime import roofline as ref_roofline

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.runtime import roofline
from repro_torch.runtime.op_analysis import OpAnalysis
from repro_torch.runtime.roofline import (LINK_BW, PEAK_FLOPS,
                                          RooflineReport,
                                          model_flops_estimate)


def test_analysis_counts_every_loop_trip():
    x = torch.randn(256, 256)
    with OpAnalysis() as a:
        h = x
        for _ in range(10):
            h = h @ x
    r = a.analyze()
    assert r["flops"] == pytest.approx(10 * 2 * 256 ** 3, rel=0.05)
    # ten matmuls, each reading two operands and writing one result
    assert r["bytes"] == pytest.approx(10 * 3 * 256 * 256 * 4, rel=0.05)


def test_analysis_counts_remat_recompute():
    """grad of a checkpointed loop: fwd + recompute + 2 bwd matmuls per
    layer ~= 4x forward FLOPs."""
    w = torch.randn(128, 128, requires_grad=True)
    x = torch.randn(128, 128)

    def g(w):
        h = x
        for _ in range(8):
            h = checkpoint(lambda hh: torch.tanh(hh @ w), h,
                           use_reentrant=False)
        return h.sum()

    with OpAnalysis() as a:
        torch.autograd.grad(g(w), [w])
    assert a.analyze()["flops"] == pytest.approx(4 * 8 * 2 * 128 ** 3,
                                                 rel=0.15)


def test_nested_loop_trips_multiply():
    x = torch.empty(64, 64, device="meta")
    with OpAnalysis() as a:
        h = x
        for _ in range(5):
            for _ in range(3):
                h = h @ x
    assert a.analyze()["flops"] == pytest.approx(15 * 2 * 64 ** 3, rel=0.1)


def test_analysis_keys_and_peak_memory():
    """The reference ``analyze_text`` keys that keep a meaning; the live
    bytes of the step's own allocations peak at what it holds at once."""
    x = torch.empty(1024, 1024, device="meta")
    with OpAnalysis(track_memory=True) as a:
        y = x * 2          # 4 MiB alive
        z = y + 1          # 8 MiB alive
        del y, z
        w = x.clone()      # a copy: layout bytes
    r = a.analyze()
    assert set(r) == {"flops", "bytes", "layout_bytes", "collective_bytes",
                      "collective_by_op", "collective_counts"}
    assert a.peak_bytes == 2 * 4 * 2 ** 20
    assert r["layout_bytes"] == 2 * 4 * 2 ** 20
    assert r["collective_bytes"] == 0.0
    del w


def test_roofline_report_terms():
    rep = RooflineReport(
        arch="x", shape="train_4k", mesh="single", chips=256,
        hlo_flops_per_chip=PEAK_FLOPS,       # exactly 1 second of compute
        hlo_bytes_per_chip=0.0,
        collective_bytes_per_chip=LINK_BW * 2.0,   # 2 seconds of comms
        collective_detail={}, model_flops=PEAK_FLOPS * 256 * 0.5,
        memory_per_chip={})
    assert rep.compute_s == pytest.approx(1.0)
    assert rep.collective_s == pytest.approx(2.0)
    assert rep.dominant == "collective"
    assert rep.step_time_s == pytest.approx(2.0)
    assert rep.mfu == pytest.approx(0.25)
    assert rep.useful_flops_fraction == pytest.approx(0.5)
    assert set(rep.to_dict()) == set(RooflineReport.__dataclass_fields__) \
        | {"compute_s", "memory_s", "collective_s", "dominant",
           "step_time_s", "useful_flops_fraction", "mfu"}


def test_h100_datasheet_constants():
    """The H100 SXM5 80 GB's published peaks, none of the reference's."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW,
            roofline.HBM_PER_CHIP) == (989e12, 3.35e12, 450e9, 80e9)
    mem = roofline.memory_dict(40e9, 20e9)
    assert mem["total_bytes"] == 60e9 and mem["hbm_fraction"] == 0.75


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_estimate_matches_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for shape in SHAPES.values():
        assert model_flops_estimate(cfg, shape, shape.kind) == \
            ref_roofline.model_flops_estimate(rcfg, shape, shape.kind)
    t = model_flops_estimate(cfg, SHAPES["train_4k"], "train")
    assert t == 6.0 * cfg.active_param_count() * 256 * 4096
