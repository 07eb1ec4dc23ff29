"""The reader of ``ssd_scan_bwd_roofline``: its cost of one backward
call at the cell ``zamba2-2.7b.fl_train_4k``'s published shape (b 1, S
4,096, 80 heads, dk = dv = 64, bf16), and what it reads from a trace: a
share where the backward kernel ran, nothing where it did not (the
forward's kernels alone, or no scan), and no share of the forward's."""
import pytest

from portbench import spec

CELL = "zamba2-2.7b.fl_train_4k"


def _ctx(bench, kernels):
    """A traced run's context holding ``kernels``: {name: (launches,
    device us)}."""
    cfg, mix = bench.config("zamba2-2.7b"), bench.traffic("fl_train_4k")

    def kernel(stem):
        hits = [v for name, v in kernels.items() if stem in name]
        return (sum(n for n, _ in hits), sum(us for _, us in hits))

    trace = type("T", (), {"kernel": staticmethod(kernel),
                           "span": staticmethod(lambda label: None)})()
    return type("Ctx", (), {"steps": 1, "cfg": cfg, "mix": mix,
                            "trace": trace})()


FWD = "void (anonymous namespace)::bf::ssd_scan_bf16_kernel<32, true>(...)"
STATES = ("void (anonymous namespace)::bwd::ssd_bwd_states_kernel<64, 64>"
          "((anonymous namespace)::bwd::Args)")
CHUNK = ("void (anonymous namespace)::bwd::ssd_bwd_chunk_kernel<64, 64>"
         "((anonymous namespace)::bwd::Args)")


def test_call_cost_at_the_cell():
    bench = spec.Bench()
    rd = bench.reader("ssd_scan_bwd_roofline")
    cfg, mix = bench.config("zamba2-2.7b"), bench.traffic("fl_train_4k")
    flops, nbytes = rd.call_cost(cfg, mix)
    assert flops == 67_108_864_000
    assert nbytes == 214_695_936
    # bound by the FLOPs: 67.9 us a call, 7.33 ms for the 108 a step
    assert rd.least_seconds(cfg, mix) * 1e6 == pytest.approx(67.86, abs=0.01)
    assert 108 * rd.least_seconds(cfg, mix) * 1e3 == pytest.approx(7.33,
                                                                  abs=0.01)
    assert any(m["name"] == "ssd_scan_bwd_roofline"
               and m["workloads"] == [CELL] for m in bench.per_layer(CELL))


@pytest.mark.parametrize("kernels", [
    {},                                         # no scan at all
    {FWD: (216, 43_000.0)},                     # the forward alone
])
def test_read_is_none_without_the_backward_kernel(kernels):
    bench = spec.Bench()
    assert bench.reader("ssd_scan_bwd_roofline").read(
        _ctx(bench, kernels)) is None


def test_read_counts_calls_by_the_chunk_kernel_and_time_by_the_stem():
    bench = spec.Bench()
    rd = bench.reader("ssd_scan_bwd_roofline")
    ctx = _ctx(bench, {FWD: (216, 43_000.0), STATES: (108, 27_000.0),
                       CHUNK: (108, 27_000.0)})
    least = rd.least_seconds(ctx.cfg, ctx.mix)
    assert rd.read(ctx) == pytest.approx(100 * 108 * least / 54_000e-6)
    # and the forward's share reads its own kernels only
    fwd = bench.reader("ssd_scan_fwd_roofline")
    assert fwd.read(ctx) == pytest.approx(
        100 * 216 * fwd.least_seconds(ctx.cfg, ctx.mix) / 43_000e-6)
