"""The port's masked group mean against the JAX package's.

On the CPU the port's wrapper runs the plain ``group_mean_ref``; the
reference runs its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` does. The CUDA kernel itself is held against
the plain version on the card by ``chip_smoke.py``. Tolerances follow
``tests/test_kernels.py``: f32 2e-5, bf16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref

from repro_torch.kernels import _build, ops
from repro_torch.kernels import group_mean as gm
from repro_torch.kernels.ref import group_mean_ref, group_mean_round_ref

_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    mask = (rng.random(shape[:2]) < 0.7).astype(np.float32)
    mask[-1] = 0.0                      # one fully dropped group
    mask[0, 0] = 1.0
    return x, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 5, 512), (8, 3, 96), (2, 2, 2048),
                                   (3, 3, 1000), (3, 3, 1)])
def test_group_mean_matches_reference(shape, dtype):
    x, mask = _inputs(shape, seed=sum(shape))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    out = ops.group_mean(xt, torch.from_numpy(mask))
    assert out.dtype == xt.dtype and tuple(out.shape) == shape
    got = out.float().numpy()
    tol = _TOL[dtype]
    for want in (ref_ops.group_mean(xj, jnp.asarray(mask)),
                 ref_ref.group_mean_ref(xj, jnp.asarray(mask))):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    # the dropped group keeps its own values exactly
    np.testing.assert_array_equal(got[-1], xt[-1].float().numpy())


def test_cpu_path_is_plain_and_counts_no_launch():
    x, mask = _inputs((2, 3, 8), seed=0)
    before = gm.launches
    out = gm.group_mean_fwd(torch.from_numpy(x), torch.from_numpy(mask))
    torch.testing.assert_close(
        out, group_mean_ref(torch.from_numpy(x), torch.from_numpy(mask)),
        rtol=0, atol=0)
    assert gm.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layout_checks_accept_what_the_kernel_takes(dtype):
    gm.check_layout(torch.zeros(2, 3, 4, dtype=dtype), torch.ones(2, 3))
    with pytest.raises(ValueError, match="CUDA device"):
        gm.validate(torch.zeros(2, 3, 4, dtype=dtype), torch.ones(2, 3))


@pytest.mark.parametrize("case", ["x_f64", "x_f16", "mask_f64", "rank",
                                  "mask_shape", "x_strided", "mask_strided",
                                  "huge_group"])
def test_layout_checks_reject_what_the_kernel_cannot_take(case):
    x, mask = torch.zeros(2, 3, 4), torch.ones(2, 3)
    bad = {
        "x_f64": (x.double(), mask),
        "x_f16": (x.half(), mask),
        "mask_f64": (x, mask.double()),
        "rank": (x[0], mask),
        "mask_shape": (x, torch.ones(3, 2)),
        "x_strided": (torch.zeros(2, 4, 3).transpose(1, 2), mask),
        "mask_strided": (x, torch.ones(3, 2).t()),
        "huge_group": (torch.zeros(1, gm._MAX_M + 1, 1),
                       torch.ones(1, gm._MAX_M + 1)),
    }[case]
    with pytest.raises((ValueError, TypeError)):
        gm.check_layout(*bad)


def test_ops_keeps_the_reference_shape_check():
    with pytest.raises(ValueError, match="bad shapes"):
        ops.group_mean(torch.zeros(2, 3, 4), torch.ones(3))


def test_non_cpu_tensor_never_falls_back():
    """A tensor that is not on the CPU goes to the kernel or raises; a
    meta tensor (no data, no CUDA) must raise, not take the plain path."""
    x = torch.empty(2, 3, 4, device="meta")
    mask = torch.empty(2, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        gm.group_mean_fwd(x, mask)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    assert "group_mean" in _build.sources()
    lib = _build._library_path("group_mean")
    assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"


# ---------------------------------------------------------------------------
# the round entry: one launch per MAR round over a table of leaves
# ---------------------------------------------------------------------------

def _round_args(dtype=torch.float32, n=13, cap=16, m=2, ds=(1, 3, 20, 128)):
    xs = [torch.zeros(n, d, dtype=dtype) for d in ds]
    return xs, torch.arange(cap), torch.ones(n), m


@pytest.mark.parametrize("dtypes,want", [
    ("f" * 8, [list(range(8))]),
    ("f" * 40, [list(range(32)), list(range(32, 40))]),
    ("fbfb", [[0, 2], [1, 3]]),
    ("b" + "f" * 33 + "b", [[0, 34], list(range(1, 33)), [33]]),
    ("", []),
])
def test_batches_split_by_dtype_then_by_max_leaves_in_order(dtypes, want):
    kind = {"f": torch.float32, "b": torch.bfloat16}
    leaves = [torch.zeros(2, 1, dtype=kind[c]) for c in dtypes]
    got = gm.batches(leaves)
    assert gm.MAX_LEAVES == 32
    assert got == want
    assert all(len({leaves[i].dtype for i in b}) == 1 for b in got)


def test_round_table_layout_is_pinned():
    """The ctypes mirror of the kernel's parameter table: the layout the
    C compiler gives ``Round`` in ``csrc/group_mean.cu`` (checked again
    against the built library when it loads), its constants as the
    source states them, and a size under the 4 KB of kernel parameters
    every CUDA 12 toolkit allows."""
    import ctypes
    import re

    assert gm.struct_layout() == [32, 12288, 32, 0, 8, 16, 24, 1056, 0,
                                  1024, 1032, 1040, 1044, 1048, 1052]
    assert gm.MAX_LEAVES >= 16
    assert ctypes.sizeof(gm._Round) <= 4096
    src = (_build.CSRC / "group_mean.cu").read_text()
    assert int(re.search(r"kMaxLeaves = (\d+);", src).group(1)) == \
        gm.MAX_LEAVES
    assert int(re.search(r"kMaxM = (\d+);", src).group(1)) == gm._MAX_M
    gm.check_struct_layout(gm.struct_layout())
    shifted = gm.struct_layout()
    shifted[-1] += 8
    with pytest.raises(RuntimeError, match="layout"):
        gm.check_struct_layout(shifted)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_layout_checks_accept_what_the_kernel_takes(dtype):
    xs, order, mask, m = _round_args(dtype)
    gm.check_round_layout(xs, order, mask, m)
    gm.check_round_layout(xs * 8, order, mask, m)        # MAX_LEAVES
    gm.check_round_layout(xs, torch.arange(13), mask, 13)
    gm.check_round_layout(xs, order, mask, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        gm.validate_round(xs, order, mask, m)


@pytest.mark.parametrize("case", [
    "x_f64", "x_f16", "mixed_dtypes", "x_strided", "x_rank1", "x_rank3",
    "x_rows", "too_many_leaves", "no_leaves", "order_int32", "order_f32",
    "order_2d", "order_short", "order_strided", "mask_f64", "mask_2d",
    "mask_strided", "m_not_dividing", "m_zero", "m_huge"])
def test_round_layout_checks_reject_what_the_kernel_cannot_take(case):
    xs, order, mask, m = _round_args()
    n = mask.shape[0]
    bad = {
        "x_f64": ([x.double() for x in xs], order, mask, m),
        "x_f16": ([x.half() for x in xs], order, mask, m),
        "mixed_dtypes": ([xs[0], xs[1].bfloat16()], order, mask, m),
        "x_strided": ([torch.zeros(4, n).t()], order, mask, m),
        "x_rank1": ([torch.zeros(n)], order, mask, m),
        "x_rank3": ([torch.zeros(n, 2, 2)], order, mask, m),
        "x_rows": ([torch.zeros(n + 1, 4)], order, mask, m),
        "too_many_leaves": (xs * 8 + xs[:1], order, mask, m),
        "no_leaves": ([], order, mask, m),
        "order_int32": (xs, order.int(), mask, m),
        "order_f32": (xs, order.float(), mask, m),
        "order_2d": (xs, order.reshape(8, 2), mask, m),
        "order_short": (xs, torch.arange(12), mask, m),
        "order_strided": (xs, torch.arange(32)[::2], mask, m),
        "mask_f64": (xs, order, mask.double(), m),
        "mask_2d": (xs, order, mask.reshape(1, n), m),
        "mask_strided": (xs, order, torch.ones(2 * n)[::2], m),
        "m_not_dividing": (xs, order, mask, 3),
        "m_zero": (xs, order, mask, 0),
        "m_huge": (xs, torch.arange(gm._MAX_M + 1), mask, gm._MAX_M + 1),
    }[case]
    with pytest.raises((ValueError, TypeError)):
        gm.check_round_layout(*bad)


def test_round_cpu_path_is_plain_and_counts_no_launch():
    rng = np.random.default_rng(4)
    n, cap, m = 13, 16, 4
    xs = [torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
          for d in (1, 6, 33)]
    order = torch.from_numpy(rng.permutation(cap))
    mask = torch.from_numpy((rng.random(n) < 0.6).astype(np.float32))
    before = gm.launches
    got = gm.group_mean_round(xs, order, mask, m)
    want = group_mean_round_ref(xs, order, mask, m)
    for g, w, x in zip(got, want, xs):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert g.shape == x.shape and g.data_ptr() != x.data_ptr()
    assert gm.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_plain_with_identity_order_is_the_gmd_entry(dtype):
    """The [G, M, D] entry is the round with one leaf [G*M, D] and the
    identity order, in the kernel as in the plain versions."""
    x, mask = _inputs((4, 3, 50), seed=11)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    mt = torch.from_numpy(mask)
    got = group_mean_round_ref([xt.reshape(12, 50)], torch.arange(12),
                               mt.reshape(12), 3)[0]
    torch.testing.assert_close(got, group_mean_ref(xt, mt).reshape(12, 50),
                               rtol=0, atol=0)


@pytest.mark.parametrize("where", ["all_meta", "mask_meta"])
def test_round_non_cpu_tensor_never_falls_back(where):
    """A round whose tensors are not all on the CPU goes to the kernel or
    raises; meta tensors (no data, no CUDA) must raise, not take the
    plain path."""
    xs, order, mask, m = _round_args()
    if where == "all_meta":
        xs = [x.to("meta") for x in xs]
        order = order.to("meta")
    mask = mask.to("meta")
    before = gm.launches
    with pytest.raises(ValueError, match="CUDA device"):
        gm.group_mean_round(xs, order, mask, m)
    assert gm.launches == before
