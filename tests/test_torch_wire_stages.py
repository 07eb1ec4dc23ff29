"""The port's wire stages (int8 error feedback, staleness-1 async) and
the pipeline that composes them, against the JAX package's.

Federation steps run both packages on the same inputs: the reference's
theta^0 injected into the port and its minibatch indices replayed
(``test_torch_federation.ref_step_inputs``). The ledger is numpy and
agrees exactly.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as ref_agg
from repro.core import compression as ref_comp
from repro.core.moshpit import GridPlan as RefGridPlan

from repro_torch import convert
from repro_torch.core import aggregation, compression
from repro_torch.core.federation import Federation, FederationConfig
from repro_torch.core.moshpit import GridPlan
from test_torch_federation import (one_torch_thread,  # noqa: F401
                                   _assert_trees_close, _np, _pair,
                                   assert_int8_close, run_pair)

ATOL = 1e-5


# ---------------------------------------------------------------------------
# int8 quantization: bit-exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 300), (8, 5, 7), (8,), (3, 1)])
def test_quantize_int8_bit_exact(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.normal(size=shape) * rng.uniform(0.01, 10)).astype(np.float32)
    q_ref, s_ref = ref_comp.quantize_int8(jnp.asarray(x))
    q, s = compression.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(
        compression.dequantize_int8(q, s).numpy(),
        np.asarray(ref_comp.dequantize_int8(q_ref, s_ref)))


def test_quantize_rounds_half_to_even():
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]], np.float32)
    q, _ = compression.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), [[127, 0, 2, 2, 0, -2]])


@pytest.mark.parametrize("with_error", [False, True])
def test_compress_tree_bit_exact(with_error):
    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(size=(6, 40)).astype(np.float32),
            "b": {"w": rng.normal(size=(6, 3, 4)).astype(np.float32)}}
    err = jax.tree.map(lambda x: (1e-3 * rng.normal(size=x.shape))
                       .astype(np.float32), tree) if with_error else None
    deq_r, err_r = ref_comp.compress_tree(
        jax.tree.map(jnp.asarray, tree),
        None if err is None else jax.tree.map(jnp.asarray, err))
    deq, new_err = compression.compress_tree(
        convert.params_from_numpy(tree),
        None if err is None else convert.params_from_numpy(err))
    for got, want in ((deq, deq_r), (new_err, err_r)):
        for g, w in zip(jax.tree.leaves(convert.params_to_numpy(got)),
                        jax.tree.leaves(_np(want))):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the pipeline: stages, order, bytes, resize rules
# ---------------------------------------------------------------------------

FLAGS = ("async_aggregation", "use_dp", "use_secagg", "compress")


@pytest.mark.parametrize("on", list(itertools.product((False, True),
                                                      repeat=4)))
def test_build_pipeline_stage_order(on):
    kw = {f: (("int8_ef" if f == "compress" else True) if o
              else (None if f == "compress" else False))
          for f, o in zip(FLAGS, on)}
    port = aggregation.build_pipeline("mar", GridPlan(9, (3, 3)), **kw)
    ref = ref_agg.build_pipeline("mar", RefGridPlan(9, (3, 3)), **kw)
    assert port.stage_names == ref.stage_names


@pytest.mark.parametrize("technique", ["mar", "fedavg", "ar", "gossip"])
@pytest.mark.parametrize("compress", [None, "int8_ef"])
def test_iteration_and_wire_bytes_exact(technique, compress):
    n = 16
    mask = (np.random.default_rng(5).random(n) < 0.7).astype(np.float32)
    kw = dict(compress=compress, use_dp=True, async_aggregation=True)
    port = aggregation.build_pipeline(technique, GridPlan(n, (4, 4)), **kw)
    ref = ref_agg.build_pipeline(technique, RefGridPlan(n, (4, 4)), **kw)
    na = int(mask.sum())
    assert port.iteration_bytes(na, 808096, mask) == \
        ref.iteration_bytes(na, 808096, mask)
    assert port.wire_model_bytes(808096, na) == \
        ref.wire_model_bytes(808096, na)
    for use_kd in (False, True):
        assert port.message_plan(mask, 808096, na, use_kd, 5120) \
            .total_bytes == ref.message_plan(mask, 808096, na, use_kd,
                                             5120).total_bytes
        lp, lr = aggregation.CommLedger(), ref_agg.CommLedger()
        port.record_iteration(lp, na, 808096, use_kd, 5120, mask)
        ref.record_iteration(lr, na, 808096, use_kd, 5120, mask)
        assert lp.by_source == lr.by_source


def _pipe_template(n):
    rng = np.random.default_rng(n)
    p = {"w": rng.normal(size=(n, 5)).astype(np.float32),
         "b": rng.normal(size=(n,)).astype(np.float32)}
    m = jax.tree.map(lambda x: (0.1 * x).astype(np.float32), p)
    return {"p": p, "m": m}


@pytest.mark.parametrize("grow", [True, False])
def test_resize_state_zero_keys(grow):
    """int8's ``err`` and DP's ``has_delta`` start at zero for joiners;
    everything else bootstraps from the mean; survivors are bit-exact."""
    old, new = (6, 9) if grow else (9, 6)
    kw = dict(use_dp=True, compress="int8_ef", async_aggregation=True)
    port = aggregation.build_pipeline("mar", GridPlan(old, (3, 2)), **kw)
    ref = ref_agg.build_pipeline("mar", RefGridPlan(old, (3, 2)), **kw)
    tmpl = _pipe_template(old)
    ps = port.init_state(convert.params_from_numpy(tmpl))
    rs = ref.init_state(jax.tree.map(jnp.asarray, tmpl))
    rng = np.random.default_rng(1)
    # give every stage state a non-trivial value before resizing
    fill = lambda x: (rng.normal(size=x.shape) + 1).astype(np.float32)  # noqa: E731
    vals = jax.tree.map(fill, _np(rs))
    ps = port.resize_state(convert.params_from_numpy(vals), old, new)
    rs = ref.resize_state(jax.tree.map(jnp.asarray, vals), old, new)
    _assert_trees_close(ps, rs, atol=1e-6)
    if grow:
        for leaf in jax.tree.leaves(convert.params_to_numpy(
                ps["int8_ef"]["err"])):
            assert not leaf[old:].any()
        assert not ps["dp"]["has_delta"][old:].any()
    for got, x in zip(jax.tree.leaves(convert.params_to_numpy(ps)),
                      jax.tree.leaves(vals)):
        if x.ndim and x.shape[0] == old:
            k = min(old, new)
            np.testing.assert_array_equal(got[:k], x[:k])


# ---------------------------------------------------------------------------
# federation steps against the reference
# ---------------------------------------------------------------------------

def _assert_ledgers_equal(fed, ref_fed):
    assert fed.comm_bytes == ref_fed.comm_bytes
    assert fed.ledger.by_source == ref_fed.ledger.by_source
    assert fed.sim_seconds == ref_fed.sim_seconds


@pytest.mark.parametrize("technique,kernel", [("mar", False), ("mar", True),
                                              ("fedavg", False)])
def test_int8_ef_steps_match_reference(technique, kernel):
    ref_fed, ref_state, fed, state = _pair(
        "text", 9, kernel, technique=technique, compress="int8_ef",
        local_batches=2, participation_rate=0.8, dropout_rate=0.1)
    ref_state, state = run_pair(ref_fed, ref_state, fed, state, 3)
    _assert_ledgers_equal(fed, ref_fed)
    assert_int8_close(state.params, ref_state.params)
    assert_int8_close(state.ref, ref_state.ref)
    _assert_trees_close(state.momentum, ref_state.momentum)


@pytest.mark.parametrize("technique,kernel", [("mar", False), ("mar", True),
                                              ("fedavg", False)])
def test_async_steps_match_reference(technique, kernel):
    ref_fed, ref_state, fed, state = _pair(
        "text", 9, kernel, technique=technique, async_aggregation=True,
        local_batches=2, participation_rate=0.8, dropout_rate=0.1)
    ref_state, state = run_pair(ref_fed, ref_state, fed, state, 3)
    _assert_ledgers_equal(fed, ref_fed)
    _assert_trees_close(state.params, ref_state.params)
    _assert_trees_close(state.momentum, ref_state.momentum)
    _assert_trees_close(state.pending, ref_state.pending)
    assert float(state.pipe["async"]["has"]) == 1.0


def test_int8_bytes_are_a_quarter_of_plain():
    out = {}
    for comp in (None, "int8_ef"):
        fed = Federation(FederationConfig(n_peers=8, task="text",
                                          compress=comp, seed=3),
                         device="cpu")
        state = fed.init_state()
        for _ in range(2):
            state = fed.step(state)
        out[comp] = fed.comm_bytes
    assert out["int8_ef"] == out[None] / compression.INT8_RATIO


def test_compressed_peers_agree():
    """The reference's ``test_compressed_peers_agree``: every peer
    re-anchors on the shared reference point."""
    fed = Federation(FederationConfig(n_peers=8, technique="mar",
                                      task="text", compress="int8_ef",
                                      seed=1), device="cpu")
    state = fed.init_state()
    for _ in range(3):
        state = fed.step(state)
    for x in (state.params["fc1"]["w"], state.params["fc2"]["b"]):
        spread = float((x - x.mean(0, keepdim=True)).abs().max())
        assert spread < 1e-5
