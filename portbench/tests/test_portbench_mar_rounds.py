"""The in-place MAR rounds kernel's yardstick against hand counts, and
its reader on a trace with and without the kernel."""
from types import SimpleNamespace

import pytest

from portbench import spec

BENCH = spec.Bench()


def test_mar_rounds_bound_at_musicgen_medium():
    mr = BENCH.reader("mar_rounds_roofline")
    cfg = BENCH.config("musicgen-medium")
    d, L, ffn, vocab = 1536, 48, 6144, 2048
    assert mr.params(cfg) == vocab * d * 2 + 2 * d + L * (
        2 * d + 4 * d * d + 3 * d * ffn) == 1_818_381_312
    for traffic in ("fl_train", "fl_train_30s"):
        mix = BENCH.traffic(traffic)
        # theta (bf16) and m (f32) of 4 peers, read once and written once
        assert mr.step_bytes(cfg, mix) == 2 * 4 * 1_818_381_312 * 6 \
            == 87_282_302_976
        assert mr.least_seconds_per_step(cfg, mix) * 1e3 == pytest.approx(
            26.05, abs=0.005)


class _Trace:
    def __init__(self, kernels):
        self.kernels = kernels

    def kernel(self, stem):
        hits = [v for k, v in self.kernels.items() if stem in k]
        return sum(c for c, _ in hits), sum(t for _, t in hits)


@pytest.mark.parametrize("kernels,want", [
    ({"void (anonymous namespace)::mar_rounds_inplace_kernel<float, 4, 4>":
      (13, 20_000.0),
      "void (anonymous namespace)::mar_rounds_inplace_kernel<"
      "__nv_bfloat16, 4, 8>": (13, 12_105.2)}, 81.15),
    ({"void (anonymous namespace)::group_mean_round_kernel<float>":
      (2, 30.0)}, None),
    ({}, None),
])
def test_reader_reads_the_kernel_by_its_stem_alone(kernels, want):
    mr = BENCH.reader("mar_rounds_roofline")
    ctx = SimpleNamespace(trace=_Trace(kernels), steps=1,
                          cfg=BENCH.config("musicgen-medium"),
                          mix=BENCH.traffic("fl_train"))
    got = mr.read(ctx)
    assert got == want if want is None else got == pytest.approx(want,
                                                                 abs=0.05)
