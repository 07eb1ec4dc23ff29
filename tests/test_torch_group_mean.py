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
from repro_torch.kernels.ref import group_mean_ref

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
