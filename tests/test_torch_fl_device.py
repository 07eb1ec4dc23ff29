"""The port's device-backend MAR-FL (``core/fl_device.py``, the device
backend of ``core/mar_allreduce.py`` and ``core/aggregation.py``)
against the JAX package's, every peer stacked on one device.

* ``mar_aggregate_device`` against the reference's on the same
  peer-stacked trees under random masks (an all-dropped group
  included), ``one_shot``, and a bf16 wire (``comm_dtype``: within one
  bf16 ulp of the reference, as both round the cross-peer sum to bf16);
  the port writes each leaf in place, one column block at a time.
* ``make_fl_train_step`` for 3 steps from the reference's theta^0
  (``init_fl_state(params=)``) on the same batches: 2 local steps of 2
  microbatches, U != A masks, with and without int8 EF, at the
  starcoder2-3b and musicgen-medium (prefix embeddings) smoke configs
  and xlstm-350m's (the plain scan on the CPU), 2 layers, f32. Losses
  within 1e-5, theta and m within 1e-5 (int8: rare one-quantum flips,
  ``assert_int8_close``).
* ``apply_membership`` and ``resize_fl_state`` at 4 -> 2 -> 4, the FL
  state crossing ``convert`` both ways, ``fl_state_shape`` on the meta
  device, the serving-step wrappers, and the forward-only kernel
  wrappers refusing autograd off the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.core import fl_device as ref_fl
from repro.core import mar_allreduce as ref_mar
from repro.core.aggregation import build_pipeline as ref_build_pipeline
from repro.core.moshpit import plan_grid as ref_plan_grid
from repro.core.replan import plan_membership_change as ref_plan_change
from repro.models.model import Model as RefModel
from repro.models.transformer import PREFIX_LEN

from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import fl_device, mar_allreduce
from repro_torch.core.aggregation import build_pipeline
from repro_torch.core.moshpit import GridPlan, plan_grid
from repro_torch.core.replan import plan_membership_change
from repro_torch.kernels import (decode_attention, flash_attention,
                                 group_mean, paged_attention, ssd_scan)
from repro_torch.models.model import Model
from repro_torch.tree import tree_leaves
from test_torch_federation import one_torch_thread  # noqa: F401

ATOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(port, ref, atol=ATOL):
    got = tree_leaves(port)
    want = jax.tree.leaves(_np(ref))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = convert.params_to_numpy(g.detach()) if g.dtype != torch.bfloat16 \
            else g.float().numpy()
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=atol,
                                   rtol=0)


def assert_int8_close(port, ref):
    """int8 EF parity as ``tests/test_torch_federation.py`` holds it:
    every leaf within 1e-5 except where a rounding within the packages'
    f32 differences of a half-quantum became a quantum; such flips <=
    0.5% of a leaf and no larger than two quanta of its largest value."""
    for p, r in zip(tree_leaves(port), jax.tree.leaves(_np(ref))):
        d = np.abs(p.float().numpy() - np.asarray(r, np.float32))
        assert (d > ATOL).mean() <= 5e-3
        assert d.max() <= ATOL + 2 * np.abs(np.asarray(r)).max() / 127


def _tree(rng, n):
    return {"a": rng.normal(size=(n, 3, 5)).astype(np.float32),
            "b": {"w": rng.normal(size=(n, 700)).astype(np.float32),
                  "v": rng.normal(size=(n,)).astype(np.float32)}}


# ---------------------------------------------------------------------------
# the device backend of MAR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("one_shot", [False, True])
@pytest.mark.parametrize("n", [4, 8, 9])
def test_mar_aggregate_device_matches_reference(monkeypatch, n, one_shot):
    # small column blocks, so every leaf but the [n] one runs several
    monkeypatch.setattr(mar_allreduce, "DEVICE_BLOCK_ELEMS", 64)
    rng = np.random.default_rng(n)
    tree = _tree(rng, n)
    mask = (rng.random(n) < 0.6).astype(np.float32)
    plan = plan_grid(n)
    # drop a whole round-0 group: it keeps its own values
    mask[np.asarray(plan.groups_for_round(0)[0])] = 0.0
    want = ref_mar.mar_aggregate_device(
        jax.tree.map(jnp.asarray, tree), ref_plan_grid(n),
        jnp.asarray(mask), one_shot=one_shot)
    port = convert.params_from_numpy(tree)
    leaves = tree_leaves(port)
    got = mar_allreduce.mar_aggregate_device(
        port, plan, torch.from_numpy(mask), one_shot=one_shot)
    assert all(a is b for a, b in zip(tree_leaves(got), leaves))  # in place
    _close(got, want)


def test_mar_aggregate_device_bf16_wire_within_one_ulp():
    rng = np.random.default_rng(2)
    tree = _tree(rng, 8)
    mask = np.array([1, 1, 0, 1, 1, 1, 1, 0], np.float32)
    want = _np(ref_mar.mar_aggregate_device(
        jax.tree.map(jnp.asarray, tree), ref_plan_grid(8),
        jnp.asarray(mask), comm_dtype="bfloat16"))
    got = mar_allreduce.mar_aggregate_device(
        convert.params_from_numpy(tree), plan_grid(8),
        torch.from_numpy(mask), comm_dtype="bfloat16")
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert np.all(np.abs(g.numpy() - w) <= ulp)


def test_device_backend_needs_an_exact_grid_and_only_mar_has_it():
    with pytest.raises(AssertionError, match="exact grids"):
        mar_allreduce.mar_round_device(
            {"x": torch.zeros(6, 2)}, GridPlan(6, (2, 2, 2)), 0)
    with pytest.raises(ValueError, match="no device backend"):
        build_pipeline("fedavg", plan_grid(4), backend="device")
    pipe = build_pipeline("mar", plan_grid(4), backend="device",
                          one_shot=True, comm_dtype="bfloat16")
    again = pipe.with_plan(plan_grid(8)).aggregator
    assert (again.backend, again.one_shot, again.comm_dtype) == \
        ("device", True, "bfloat16")


# ---------------------------------------------------------------------------
# the FL train step
# ---------------------------------------------------------------------------

P, B, N_MICRO, MB, S = 4, 2, 2, 1, 16
#: (U, A) per step: step 1 drops peer 1 from both and peer 2 from A only
MASKS = [(np.ones(P), np.ones(P)),
         (np.array([1, 0, 1, 1]), np.array([1, 0, 0, 1])),
         (np.ones(P), np.array([1, 1, 0, 1]))]


def _cfgs(arch):
    kw = dict(dtype="float32", num_layers=2)
    return (dataclasses.replace(ref_smoke_config(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _batches(cfg, steps=3):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (P, B, N_MICRO, MB, S))
        b = {"tokens": toks.astype(np.int32),
             "labels": np.roll(toks, -1, -1).astype(np.int32)}
        if cfg.frontend != "none":
            b["prefix_embeds"] = rng.normal(
                size=(P, B, N_MICRO, MB, PREFIX_LEN[cfg.frontend],
                      cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _run_pair(arch, compress=None, async_aggregation=False):
    rcfg, cfg = _cfgs(arch)
    kw = dict(compress=compress, async_aggregation=async_aggregation)
    rpipe = ref_build_pipeline("mar", ref_plan_grid(P), backend="device",
                               **kw)
    pipe = build_pipeline("mar", plan_grid(P), backend="device", **kw)
    rmodel = RefModel(rcfg)
    rstate = ref_fl.init_fl_state(rmodel, P, jax.random.PRNGKey(0),
                                  pipeline=rpipe)
    theta0 = jax.tree.map(lambda x: np.asarray(x[0]), rstate["params"])
    state = fl_device.init_fl_state(Model(cfg), P, device="cpu",
                                    pipeline=pipe,
                                    params=convert.params_from_numpy(theta0))
    rstep = jax.jit(ref_fl.make_fl_train_step(rmodel, ref_plan_grid(P),
                                              lr=0.1, pipeline=rpipe))
    step = fl_device.make_fl_train_step(Model(cfg), plan_grid(P), lr=0.1,
                                        pipeline=pipe)
    for batch, (u, a) in zip(_batches(cfg), MASKS):
        u, a = u.astype(np.float32), a.astype(np.float32)
        rstate, rmet = rstep(rstate, jax.tree.map(jnp.asarray, batch),
                             jnp.asarray(u), jnp.asarray(a))
        same = state
        state, met = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()},
                          torch.from_numpy(u), torch.from_numpy(a))
        assert state is same
        assert abs(float(met["loss"]) - float(rmet["loss"])) <= ATOL
    assert int(state["step"]) == int(rstate["step"]) == 3
    return state, rstate


@pytest.mark.parametrize("arch", ["starcoder2-3b", "musicgen-medium",
                                  "xlstm-350m"])
def test_fl_train_step_matches_reference(arch):
    state, rstate = _run_pair(arch)
    _close(state["params"], rstate["params"])
    _close(state["momentum"], rstate["momentum"])


@pytest.mark.parametrize("arch", ["starcoder2-3b", "musicgen-medium",
                                  "xlstm-350m"])
def test_fl_train_step_int8_ef_matches_reference(arch):
    state, rstate = _run_pair(arch, compress="int8_ef")
    assert_int8_close(state["params"], rstate["params"])
    assert_int8_close(state["pipe"]["int8_ef"]["ref"],
                      rstate["pipe"]["int8_ef"]["ref"])
    _close(state["momentum"], rstate["momentum"], atol=1e-4)


def test_fl_train_step_async_over_the_device_backend():
    """The staleness-1 stage over the in-place device aggregator: its
    pending aggregate and snapshot are copies, so the in-place local
    update and aggregation leave them as the reference's."""
    state, rstate = _run_pair("starcoder2-3b", async_aggregation=True)
    _close(state["params"], rstate["params"])
    _close(state["pipe"]["async"]["pending"],
           rstate["pipe"]["async"]["pending"])


def test_fl_train_step_updates_the_peer_slices_in_place():
    _, cfg = _cfgs("starcoder2-3b")
    state = fl_device.init_fl_state(Model(cfg), P, device="cpu")
    ptrs = [x.data_ptr() for x in tree_leaves(state["params"])]
    step = fl_device.make_fl_train_step(Model(cfg), plan_grid(P))
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, 1)[0].items()}
    state, met = step(state, batch)
    assert [x.data_ptr() for x in tree_leaves(state["params"])] == ptrs
    assert np.isfinite(float(met["loss"]))
    # full participation over (2, 2): every peer holds the global mean
    for x in tree_leaves(state["params"]):
        assert torch.equal(x, x[:1].expand_as(x))


# ---------------------------------------------------------------------------
# membership, state crossing, shapes
# ---------------------------------------------------------------------------

def test_apply_membership_and_resize_match_reference():
    rcfg, cfg = _cfgs("starcoder2-3b")
    rpipe = ref_build_pipeline("mar", ref_plan_grid(4), backend="device",
                               compress="int8_ef")
    pipe = build_pipeline("mar", plan_grid(4), backend="device",
                          compress="int8_ef")
    rstate = ref_fl.init_fl_state(RefModel(rcfg), 4, jax.random.PRNGKey(3),
                                  pipeline=rpipe)
    # distinct peers, so a wrong survivor or mean shows
    rng = np.random.default_rng(0)
    rstate = {**rstate, "momentum": jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=x.shape), x.dtype),
        rstate["momentum"])}
    state = convert.params_from_numpy(_np(rstate))
    for new_n in (2, 4):
        old = ref_plan_grid(int(jax.tree.leaves(rstate["params"])[0]
                                .shape[0]))
        rchange = ref_plan_change(old, new_n, exact_only=True)
        change = plan_membership_change(plan_grid(old.n_peers), new_n,
                                        exact_only=True)
        assert tuple(change.survivors) == tuple(rchange.survivors)
        rstate, rpipe = ref_fl.apply_membership(rstate, rchange, rpipe)
        state, pipe = fl_device.apply_membership(state, change, pipe)
        assert pipe.aggregator.plan.dims == rpipe.aggregator.plan.dims
        _close(state["momentum"], rstate["momentum"])
        _close(state["pipe"], rstate["pipe"])
    back, rback = state, rstate
    for new_n in (2, 4):
        back = fl_device.resize_fl_state(back, new_n, pipe)
        rback = ref_fl.resize_fl_state(rback, new_n, rpipe)
        _close(back["momentum"], rback["momentum"])
        _close(back["pipe"], rback["pipe"])
    assert fl_device.resize_fl_state(state, 4, pipe) is state


def test_fl_state_crosses_convert_both_ways():
    """A whole FL state — peer-stacked bf16 params, f32 momentum, the
    int32 step and the int8 EF state — crosses bit for bit: the
    reference's state through ``params_from_numpy`` equals the port's
    ``init_fl_state`` from the same theta^0, and comes back through
    ``params_to_numpy`` as the reference's arrays."""
    rcfg, cfg = ref_smoke_config("musicgen-medium"), \
        get_smoke_config("musicgen-medium")
    assert cfg.dtype == "bfloat16"
    rpipe = ref_build_pipeline("mar", ref_plan_grid(4), backend="device",
                               compress="int8_ef")
    pipe = build_pipeline("mar", plan_grid(4), backend="device",
                          compress="int8_ef")
    rstate = _np(ref_fl.init_fl_state(RefModel(rcfg), 4,
                                      jax.random.PRNGKey(0),
                                      pipeline=rpipe))
    crossed = convert.params_from_numpy(rstate)
    theta0 = convert.params_from_numpy(
        jax.tree.map(lambda x: x[0], rstate["params"]))
    ours = fl_device.init_fl_state(Model(cfg), 4, device="cpu",
                                   pipeline=pipe, params=theta0)
    assert crossed["step"].dtype == ours["step"].dtype == torch.int32
    assert sorted(crossed) == sorted(ours)
    for a, b in zip(tree_leaves(crossed), tree_leaves(ours)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    back = convert.params_to_numpy(ours)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rstate)):
        np.testing.assert_array_equal(a, np.asarray(b).view(a.dtype))


@pytest.mark.parametrize("arch", ["musicgen-medium", "zamba2-2.7b"])
def test_fl_state_shape_is_the_references_on_meta(arch):
    shape = fl_device.fl_state_shape(Model(get_config(arch)), 4)
    want = ref_fl.fl_state_shape(RefModel(ref_config(arch)), 4)
    got = tree_leaves(shape)
    assert all(x.device.type == "meta" for x in got)
    wl = jax.tree.leaves(want)
    assert [tuple(x.shape) for x in got] == [tuple(x.shape) for x in wl]
    assert [convert.dtype_name(x) for x in got] == \
        [str(x.dtype) for x in wl]


def test_serving_step_wrappers_match_the_model():
    _, cfg = _cfgs("starcoder2-3b")
    model = Model(cfg)
    params = model.init(seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 8))
    last, cache = fl_device.make_prefill_step(model, max_len=12)(
        params, {"tokens": toks})
    logits, _, _ = model.forward(params, toks)
    torch.testing.assert_close(last, logits[:, -1])
    tok, cache = fl_device.make_serve_step(model)(params, cache,
                                                  last.argmax(-1))
    assert tok.dtype == torch.int32 and int(cache["pos"][0]) == 9
    pages = model.init_paged_cache(4, 8, device="cpu")
    nxt, lg, pages = fl_device.make_paged_serve_step(model)(
        params, pages, torch.tensor([[1], [2]], dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32), toks[:, 0])
    assert nxt.shape == (2,) and lg.shape == (2, cfg.vocab_size)


# ---------------------------------------------------------------------------
# forward-only kernels refuse autograd off the CPU; the SSD scan's
# Function validates
# ---------------------------------------------------------------------------

def _meta(*shape, grad=False):
    return torch.zeros(shape, device="meta", requires_grad=grad)


GUARDED = {
    "ssd_scan": lambda g: ssd_scan.ssd_scan_fwd(
        _meta(1, 2, 8, 16, grad=g), _meta(1, 2, 8, 16),
        _meta(1, 2, 8, 16), _meta(1, 2, 8), _meta(1, 2, 16, 16)),
    "group_mean": lambda g: group_mean.group_mean_fwd(
        _meta(2, 2, 8, grad=g), _meta(2, 2)),
    "group_mean_round": lambda g: group_mean.group_mean_round(
        [_meta(4, 8, grad=g)],
        torch.zeros(4, dtype=torch.int64, device="meta"), _meta(4), 2),
    "decode_attention": lambda g: decode_attention.decode_attention_fwd(
        _meta(1, 2, 16, grad=g), _meta(1, 8, 1, 16), _meta(1, 8, 1, 16),
        torch.ones(1, dtype=torch.int32, device="meta")),
    "paged_decode_attention": lambda g: paged_attention
    .paged_decode_attention_fwd(
        _meta(1, 2, 16, grad=g), _meta(2, 4, 1, 16), _meta(2, 4, 1, 16),
        torch.ones(1, 1, dtype=torch.int32, device="meta"),
        torch.ones(1, dtype=torch.int32, device="meta")),
    "flash_attention": lambda g: flash_attention.flash_attention_fwd(
        _meta(1, 8, 2, 16, grad=g), _meta(1, 8, 1, 16),
        _meta(1, 8, 1, 16)),
}


@pytest.mark.parametrize("kernel", sorted(GUARDED))
def test_forward_only_wrappers_refuse_autograd_off_the_cpu(kernel):
    """Off the CPU (here the meta device, which takes the same branch as
    CUDA) a wrapper whose kernel has no backward raises
    ``NotImplementedError`` under autograd before it validates or
    launches, instead of returning a tensor without a ``grad_fn``;
    without autograd it goes on to its checks (which refuse a non-CUDA
    device). The SSD scan has a backward (``_SsdScanFn``, the plain
    VJP): under autograd its Function is entered and reaches the same
    validation, which refuses the non-CUDA device."""
    if kernel == "ssd_scan":
        with pytest.raises(ValueError, match="one CUDA device"):
            GUARDED[kernel](True)
    else:
        with pytest.raises(NotImplementedError, match="forward-only"):
            GUARDED[kernel](True)
    with torch.no_grad():
        with pytest.raises(ValueError):
            GUARDED[kernel](True)
    with pytest.raises(ValueError):
        GUARDED[kernel](False)
