"""The device backend's in-place MAR rounds (``kernels/mar_rounds.py``).

On the CPU: which leaves the route in ``core/mar_allreduce._mean_into_``
hands to the kernel (checked on stand-ins, without a launch), the round
groups the kernel is given, the wrapper's plain version against the
plain sequence of ``mar_round_device`` rounds (bit for bit), the
wrapper's refusals, and the ``no_exchange`` fault of the benchmark.

On the card (marked ``cuda``; they skip without one): the kernel against
the plain route on the grids of the peer counts it is built for
(``KERNEL_GRIDS``; one_shot's (4,) is a group of four). Groups of two are bit-equal: both add
the same two f32 numbers and apply the same epilogue. Larger groups may
add in another order in PyTorch's reduction, k - 1 roundings of the f32
sum apart, so each round may move a value by (k - 1) * 2**-23 of the
largest |x| (the two sums are each within (k - 1) * 2**-24 of the exact
one), and a bf16 leaf by one bf16 ulp more where that moves its
rounding. The kernel runs in place: it allocates nothing.

This file imports no JAX, so the card's tests run where JAX is absent:
``python -m pytest -m cuda tests/test_torch_mar_rounds.py``.
"""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import mar_allreduce as mar
from repro_torch.core.aggregation import MarAggregator
from repro_torch.core.moshpit import GridPlan
from repro_torch.kernels import _build, mar_rounds
from repro_torch.kernels.ref import mar_rounds_ref
from repro_torch.tree import tree_leaves

GRIDS = [(2, 2), (2, 2, 2), (4,), (3, 3), (4, 4)]
#: the grids of the peer counts the kernel is built for (PEERS)
KERNEL_GRIDS = [(2,), (2, 2), (4,)]
DTYPES = [torch.float32, torch.bfloat16]


def _stand_in(device="cuda", dtype=torch.float32, shape=(4, 8),
              contiguous=True):
    return SimpleNamespace(device=torch.device(device), dtype=dtype,
                           shape=shape, dim=lambda: len(shape),
                           is_contiguous=lambda: contiguous)


@pytest.mark.parametrize("leaf,comm_dtype,takes", [
    (_stand_in(), None, True),
    (_stand_in(), "float32", True),
    (_stand_in(dtype=torch.bfloat16, shape=(2, 3, 5)), torch.float32,
     True),
    (_stand_in(), "bfloat16", False),
    (_stand_in(device="cpu"), None, False),
    (_stand_in(device="meta"), None, False),
    (_stand_in(contiguous=False), None, False),
    (_stand_in(shape=(8, 8)), None, False),
    (_stand_in(shape=(16, 8)), None, False),
    (_stand_in(shape=(17, 8)), None, False),
    (_stand_in(shape=(4,)), None, False),
    (_stand_in(dtype=torch.float16), None, False),
])
def test_route_takes_the_kernel_only_where_it_can(leaf, comm_dtype, takes):
    assert mar._takes_kernel(leaf, comm_dtype) is takes


def test_route_keeps_real_cpu_and_meta_leaves_plain():
    for device in ("cpu", "meta"):
        assert not mar._takes_kernel(torch.zeros(4, 8, device=device), None)


@pytest.mark.parametrize("dims", GRIDS + [(16,), (2, 4, 2)])
def test_groups_are_the_grid_reshape_groups(dims):
    n = math.prod(dims)
    ids = torch.arange(n).reshape(dims)
    table = mar_rounds.groups(dims, tuple(range(len(dims))))
    for axis, row in enumerate(table):
        for p in range(n):
            at = [int(c) for c in np.unravel_index(p, dims)]
            at[axis] = slice(None)
            want = sum(1 << int(q) for q in ids[tuple(at)].flatten())
            assert row[p] == want


def _case(dims, dtype, seed=0, cols=37):
    """A leaf [P, 3, cols] and a mask that empties round 0's group of
    peer 0 and drops one more peer."""
    n = math.prod(dims)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((n, 3, cols), generator=gen).to(dtype)
    mask = torch.ones(n)
    first = mar_rounds.groups(dims, (0,))[0][0]
    for p in range(n):
        if first >> p & 1:
            mask[p] = 0.0
    mask[n - 1] = 0.0
    return x, mask


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims", GRIDS)
def test_plain_version_is_the_plain_rounds_bit_for_bit(dims, dtype):
    x, mask = _case(dims, dtype)
    plan = GridPlan(x.shape[0], dims)
    want = {"x": x.clone()}
    for rnd in range(len(dims)):
        mar.mar_round_device(want, plan, rnd, mask)
    mar_rounds.launches = 0
    got = x.clone()
    out = mar_rounds.mar_rounds_(got.view(x.shape[0], -1), dims,
                                 range(len(dims)), mask)
    assert out.data_ptr() == got.data_ptr()           # in place
    assert torch.equal(got, want["x"])
    assert mar_rounds.launches == 0
    # and the device backend's whole schedule, every round at once
    whole = {"x": x.clone()}
    mar.mar_aggregate_device(whole, plan, mask)
    assert torch.equal(whole["x"], want["x"])


def test_wrapper_off_the_cpu_launches_or_raises(monkeypatch):
    x = torch.empty(4, 8, device="meta")
    mask = torch.empty(4, device="meta")
    assert mar_rounds.mar_rounds_(x, (2, 2), (0, 1), mask) is x
    monkeypatch.setattr(_build, "PLAIN_DEVICES", ("cpu",))
    with pytest.raises(ValueError, match="one CUDA device"):
        mar_rounds.mar_rounds_(x, (2, 2), (0, 1), mask)
    with pytest.raises(NotImplementedError, match="forward-only"):
        mar_rounds.mar_rounds_(x.requires_grad_(), (2, 2), (0, 1), mask)


@pytest.mark.parametrize("x,dims,axes,mask,error", [
    (torch.zeros(4, 8, dtype=torch.float16), (2, 2), (0,), torch.ones(4),
     TypeError),
    (torch.zeros(4, 2, 4), (2, 2), (0,), torch.ones(4), ValueError),
    (torch.zeros(8, 4).t(), (2, 2), (0,), torch.ones(4), ValueError),
    (torch.zeros(8, 4), (2, 2, 2), (0,), torch.ones(8), ValueError),
    (torch.zeros(4, 4), (2, 2), (0, 1) * 5, torch.ones(4), ValueError),
    (torch.zeros(4, 4), (2, 3), (0,), torch.ones(4), ValueError),
    (torch.zeros(4, 4), (2, 2), (2,), torch.ones(4), ValueError),
    (torch.zeros(4, 4), (2, 2), (0,), torch.ones(4, dtype=torch.int64),
     TypeError),
    (torch.zeros(4, 4), (2, 2), (0,), torch.ones(5), TypeError),
])
def test_layout_checks_refuse_what_the_kernel_does_not_take(
        x, dims, axes, mask, error):
    with pytest.raises(error):
        mar_rounds.validate(x, dims, axes, mask)


@pytest.mark.parametrize("dims", KERNEL_GRIDS)
def test_layout_checks_accept_what_the_kernel_takes(dims):
    """Every check but the device's passes: on the CPU only that one
    refuses."""
    n = math.prod(dims)
    for dtype in DTYPES:
        with pytest.raises(ValueError, match="one CUDA device"):
            mar_rounds.validate(torch.zeros(n, 24, dtype=dtype), dims,
                                tuple(range(len(dims))), torch.ones(n))


def test_no_exchange_fault_still_removes_the_whole_exchange():
    from portbench import faults

    plan = GridPlan(4, (2, 2))
    x, mask = _case((2, 2), torch.float32)
    state = {"p": x.clone(), "m": x.float().clone()}
    with faults.planted("fl_train", ["no_exchange"]):
        out = MarAggregator(plan, backend="device")(state, torch.ones(4))
    assert torch.equal(out["p"], x) and torch.equal(out["m"], x)
    out = MarAggregator(plan, backend="device")(state, mask)
    assert not torch.equal(out["p"], x)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel runs only on the card")
    return torch.device("cuda")


def _tolerance(dims, x):
    """None for groups of two (bit-equal), else the bound above."""
    k = max(dims)
    if k <= 2:
        return None
    big = float(x.float().abs().max())
    per_round = (k - 1) * 2.0 ** -23 * big
    if x.dtype == torch.bfloat16:
        per_round += 2.0 ** (math.floor(math.log2(big)) - 7)
    return len(dims) * per_round


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["vector", "odd_width", "offset"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims", KERNEL_GRIDS)
def test_kernel_matches_the_plain_route(cuda, dims, dtype, layout):
    cols = {"vector": 1024, "odd_width": 333, "offset": 1024}[layout]
    x, mask = _case(dims, dtype, seed=7, cols=cols)
    n = x.shape[0]
    if layout == "offset":          # rows not 16-byte aligned
        buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
        leaf = buf[1:].view(n, -1)
        leaf.copy_(x.view(n, -1))
    else:
        leaf = x.view(n, -1).to(cuda)
    mask = mask.to(cuda)
    axes = tuple(range(len(dims)))
    want = mar_rounds_ref(leaf.clone(), dims, axes, mask)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    mar_rounds.launches = 0
    out = mar_rounds.mar_rounds_(leaf, dims, axes, mask)
    torch.cuda.synchronize()
    assert out is leaf and mar_rounds.launches == 1
    assert torch.cuda.memory_allocated() == before
    tol = _tolerance(dims, x)
    if tol is None:
        assert torch.equal(leaf, want)
    else:
        assert float((leaf.float() - want.float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("one_shot", [False, True])
def test_device_aggregation_on_the_card_is_the_cpus(cuda, one_shot):
    """The whole schedule on the card, one launch a leaf, against the
    plain route on the CPU: bit-equal on (2, 2) (one_shot: groups of 4,
    within the bound)."""
    plan = GridPlan(4, (2, 2))
    x, mask = _case((2, 2), torch.bfloat16, seed=3, cols=4096)
    cpu = {"p": x.clone(), "m": x.float() * 0.5}
    card = {k: v.to(cuda) for k, v in cpu.items()}
    mar.mar_aggregate_device(cpu, plan, mask, one_shot=one_shot)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    mar_rounds.launches = 0
    mar.mar_aggregate_device(card, plan, mask.to(cuda), one_shot=one_shot)
    torch.cuda.synchronize()
    assert mar_rounds.launches == 2
    assert torch.cuda.memory_allocated() == before
    dims = (4,) if one_shot else (2, 2)
    for key in cpu:
        got, want = card[key].cpu(), cpu[key]
        tol = _tolerance(dims, want)
        if tol is None:
            assert torch.equal(got, want)
        else:
            assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_plain_route_stays_where_the_kernel_does_not_go(cuda):
    """A bf16 wire sum and peer counts the kernel is not built for
    launch nothing."""
    state = {"x": torch.randn(4, 64, device=cuda)}
    eight = {"x": torch.randn(8, 64, device=cuda)}
    big = {"x": torch.randn(18, 64, device=cuda)}
    mar_rounds.launches = 0
    mar.mar_aggregate_device(state, GridPlan(4, (2, 2)),
                             comm_dtype="bfloat16")
    mar.mar_aggregate_device(eight, GridPlan(8, (2, 2, 2)))
    mar.mar_aggregate_device(big, GridPlan(18, (3, 6)))
    torch.cuda.synchronize()
    assert mar_rounds.launches == 0
    assert all(torch.isfinite(x).all() for x in tree_leaves(
        (state, eight, big)))
