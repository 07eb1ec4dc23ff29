"""The card gate's CPU-side contract (``chip_smoke.py`` over
``chipsmoke/``).

* ``chipsmoke.refs``, which the CPU tests and the tools read, imports
  neither torch nor jax.
* The kernels line sums each kernel's launches over the main paths that
  report it, and has one entry for each kernel the port counts
  (``ops.launch_counts()``) plus the SSD scan's backward kernel.
* The profile lines read the benchmark's trace summary: busy time is
  the summary's union, and each label's figures are its span's.
"""
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from chipsmoke import common  # noqa: E402
from portbench.trace import Span, Summary  # noqa: E402


@pytest.mark.parametrize("framework", ["torch", "jax"])
def test_refs_imports_no_framework(framework):
    out = subprocess.run(
        [sys.executable, "-c", "import sys, chipsmoke.refs; "
         f"print({framework!r} in sys.modules)"],
        cwd=ROOT, capture_output=True, text=True, timeout=60, check=True)
    assert out.stdout.strip() == "False"


@pytest.mark.parametrize("paths", [
    [{"group_mean": 60}, {"group_mean": 427, "flash_attention": 96,
                          "mar_rounds": 72},
     {"flash_attention": 480, "paged_decode_attention": 2_000,
      "decode_attention": 0},
     {"flash_attention": 108, "ssd_scan": 648, "ssd_scan_bwd": 648,
      "mar_rounds": 132}],
    [],
], ids=["phases", "none"])
def test_kernels_line_sums_each_kernel_over_its_paths(paths):
    totals = common.launch_totals(paths)
    assert list(totals) == list(common.KERNELS)
    for name in common.KERNELS:
        assert totals[name] == sum(p.get(name, 0) for p in paths)
    assert set(common.KERNELS) == set(ops.launch_counts()) | {"ssd_scan_bwd"}
    row = {"max_abs_err": 0.0, "kernel_ms": 1.0, "plain_ms": 2.0,
           "bound_ms": 0.5, "bytes_ms": 0.5, "ops_ms": 0.1,
           "library_ms": None}
    rows = {name: dict(row) for name in common.KERNELS}
    rows["group_mean"]["row"] = "group_mean_round quickstart round 0"
    line = common.kernels_line(totals, rows)
    assert [e["name"] for e in line] == list(common.KERNELS)
    assert [e["launches"] for e in line] == list(totals.values())
    assert all(Path(ROOT / e["source"]).is_file() for e in line)
    assert line[0]["row"] == rows["group_mean"]["row"]
    assert all("row" not in e for e in line[1:])
    with pytest.raises(KeyError):
        common.launch_totals([{"no_such_kernel": 1}])


@pytest.mark.parametrize("steps", [1, 10])
def test_profile_lines_read_the_summary(steps):
    summary = Summary(
        window_us=1_000.0, busy_us=400.0,
        spans={"moe": Span(host_us=300.0, count=2 * steps, launches=6,
                           device_us=120.0),
               "idle": Span()},
        kernels={"flash_fwd_bf16": [4, 200.0], "void gemm": [3, 150.0],
                 "ssd_bwd_chunk_kernel": [2, 100.0]})
    approx = pytest.approx
    prof = common.device_profile(summary, steps)
    assert prof["device_busy_share"] == approx(0.4)
    assert prof["device_busy_ms_per_step"] == approx(0.4 / steps)
    assert prof["wall_ms_per_step"] == approx(1.0 / steps)
    assert prof["kernel_launches_per_step"] == approx(9 / steps)
    assert prof["port_kernels_per_step"] == {
        "flash_fwd_": approx({"launches": 4 / steps,
                              "device_us": 200.0 / steps,
                              "share_of_busy": 0.5}),
        "ssd_bwd_": approx({"launches": 2 / steps,
                            "device_us": 100.0 / steps,
                            "share_of_busy": 0.25})}
    assert [k["name"] for k in prof["top_kernels_per_step"]] == [
        "flash_fwd_bf16", "void gemm", "ssd_bwd_chunk_kernel"]
    moe = common.label_profile(summary, "moe", steps)
    assert moe.pop("label") == "moe"
    assert moe == approx({
        "ranges_per_step": 2.0, "host_ms_per_step": 0.3 / steps,
        "launches_per_step": 6 / steps, "device_ms_per_step": 0.12 / steps,
        "share_of_busy": 0.3})
