"""The port's elastic membership (``core/replan.py`` and
``Federation.apply_membership``) against the JAX package's.

Survivors are a pure reindex and must be bit-exact; joiners take the f32
mean over the old fleet (within 1e-6: the two packages sum in another
order); EF residuals and DP bot markers start at zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import replan as ref_replan
from repro.core.moshpit import GridPlan as RefGridPlan

from repro_torch import convert
from repro_torch.core import replan
from repro_torch.core.federation import Federation, FederationConfig
from repro_torch.core.moshpit import GridPlan
from test_torch_federation import (one_torch_thread,  # noqa: F401
                                   _assert_trees_close, _np, _pair,
                                   assert_int8_close, run_pair)


def _tree(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(n, 3, 2)).astype(np.float32),
            "b": {"c": rng.normal(size=(n,)).astype(np.float32),
                  "s": np.float32(rng.normal())}}


def _both(fn_port, fn_ref, tree, *args, **kw):
    got = convert.params_to_numpy(fn_port(
        convert.params_from_numpy(tree), *args, **kw))
    want = _np(fn_ref(jax.tree.map(jnp.asarray, tree), *args, **kw))
    return got, want


def _equal(got, want, atol=0.0):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


@pytest.mark.parametrize("old,new,fill", [(6, 4, "mean"), (4, 7, "mean"),
                                          (4, 7, "zero"), (5, 5, "mean")])
def test_resize_peer_axis_matches_reference(old, new, fill):
    got, want = _both(replan.resize_peer_axis, ref_replan.resize_peer_axis,
                      _tree(old), old, new, fill)
    _equal(got, want, atol=1e-6)
    k = min(old, new)
    np.testing.assert_array_equal(got["a"][:k], _tree(old)["a"][:k])


@pytest.mark.parametrize("old,new", [(6, 9), (9, 6)])
def test_resize_state_tree_zero_keys(old, new):
    own = {"ref": _tree(old, 1), "err": _tree(old, 2)}
    got, want = _both(replan.resize_state_tree, ref_replan.resize_state_tree,
                      own, old, new, zero_keys=("err",))
    _equal(got, want, atol=1e-6)
    if new > old:
        assert not got["err"]["a"][old:].any()


@pytest.mark.parametrize("survivors", [(0, 1, 2), (4, 0, 2), (0, 1, 2, 3, 4,
                                                              5)])
def test_select_survivors_matches_reference(survivors):
    got, want = _both(replan.select_survivors, ref_replan.select_survivors,
                      _tree(6), 6, survivors)
    _equal(got, want)


@pytest.mark.parametrize("old,new,survivors", [(8, 5, None), (8, 12, None),
                                               (8, 6, (7, 1, 3, 0))])
def test_membership_change_matches_reference(old, new, survivors):
    kw = dict(iteration=3, survivors=survivors)
    ch = replan.plan_membership_change(GridPlan(old, (2, 2, 2)), new, **kw)
    rch = ref_replan.plan_membership_change(RefGridPlan(old, (2, 2, 2)),
                                            new, **kw)
    assert (ch.old_n, ch.new_n, ch.survivors, ch.iteration) == \
        (rch.old_n, rch.new_n, rch.survivors, rch.iteration)
    assert ch.new_plan.dims == rch.new_plan.dims
    assert (ch.same_n, ch.n_joiners, ch.contiguous) == \
        (rch.same_n, rch.n_joiners, rch.contiguous)
    got = convert.params_to_numpy(ch.apply_to_tree(
        convert.params_from_numpy(_tree(old))))
    want = _np(rch.apply_to_tree(jax.tree.map(jnp.asarray, _tree(old))))
    _equal(got, want, atol=1e-6)
    k = len(ch.survivors)
    np.testing.assert_array_equal(got["a"][:k],
                                  _tree(old)["a"][list(ch.survivors)])


def test_membership_change_validation_and_exact_only():
    plan = GridPlan(8, (2, 2, 2))
    for bad in ((8, 1), (0, 0), (9,)):
        for mod, gp in ((replan, plan), (ref_replan, RefGridPlan(8, (2,) * 3))):
            with pytest.raises(ValueError):
                mod.MembershipChange(8, 4, mod.plan_membership_change(
                    gp, 4).new_plan, bad)
    for mod, gp in ((replan, plan), (ref_replan, RefGridPlan(8, (2,) * 3))):
        with pytest.raises(ValueError, match="exact grid"):
            mod.plan_membership_change(gp, 13, exact_only=True)
        with pytest.raises(ValueError):
            mod.plan_membership_change(gp, 0)


def test_regroup_change_and_schedule_validation():
    ch = replan.regroup_change(GridPlan(16, (4, 4)), GridPlan(16, (2,) * 4),
                               iteration=2)
    rch = ref_replan.regroup_change(RefGridPlan(16, (4, 4)),
                                    RefGridPlan(16, (2,) * 4), iteration=2)
    assert ch.same_n and rch.same_n and ch.survivors == rch.survivors
    with pytest.raises(ValueError, match="regroup keeps membership"):
        replan.regroup_change(GridPlan(16, (4, 4)), GridPlan(8, (2,) * 3))
    replan.validate_membership_schedule(GridPlan(8, (2,) * 3),
                                        [(2, 4), (4, 16)])
    for mod, gp in ((replan, GridPlan(8, (2,) * 3)),
                    (ref_replan, RefGridPlan(8, (2,) * 3))):
        with pytest.raises(ValueError, match="planned resize at step 4"):
            mod.validate_membership_schedule(gp, [(2, 4), (4, 13)])


ELASTIC = dict(participation_rate=0.9, dropout_rate=0.1,
               resize_schedule=((1, 4), (3, 10)))


@pytest.mark.parametrize("kw", [{}, {"use_dp": True, "compress": "int8_ef"},
                                {"async_aggregation": True}],
                         ids=["plain", "dp_int8", "async"])
def test_resize_schedule_run_matches_reference(kw):
    """8 -> 4 at iteration 1 and 4 -> 10 at iteration 3 (a 3x2x2 grid
    with two virtual slots), iid churn, step for step on the reference's
    draws."""
    ref_fed, ref_state, fed, state = _pair("text", 8, True, local_batches=2,
                                           **ELASTIC, **kw)
    ref_state, state = run_pair(ref_fed, ref_state, fed, state, 4,
                                sizes=[8, 4, 4, 10])
    assert fed.cfg.n_peers == ref_fed.cfg.n_peers == 10
    assert fed.plan.capacity == 12
    assert fed.plan.dims == ref_fed.plan.dims
    assert fed.comm_bytes == ref_fed.comm_bytes
    assert fed.ledger.by_source == ref_fed.ledger.by_source
    assert fed.sim_seconds == ref_fed.sim_seconds
    assert len(fed.lifecycle.event_log) == len(ref_fed.lifecycle.event_log)
    np.testing.assert_array_equal(fed.data_x.numpy(),
                                  np.asarray(ref_fed.data_x))
    if "compress" in kw:
        assert_int8_close(state.params, ref_state.params)
    else:
        _assert_trees_close(state.params, ref_state.params)
    _assert_trees_close(state.momentum, ref_state.momentum)
    if "use_dp" in kw:
        assert float(state.dp["clip"]) == pytest.approx(
            float(ref_state.dp["clip"]), rel=1e-6)


@pytest.mark.parametrize("old,new", [(9, 4), (4, 10)])
def test_resize_survivors_bit_exact_joiners_mean(old, new):
    fed = Federation(FederationConfig(n_peers=old, task="text", seed=2,
                                      use_dp=True, compress="int8_ef",
                                      async_aggregation=True),
                     device="cpu")
    state = fed.init_state()
    for _ in range(2):
        state = fed.step(state)
    before = state
    after = fed.resize(state, new)
    k = min(old, new)
    assert fed.cfg.n_peers == new and fed.plan.n_peers == new
    assert fed.data_x.shape[0] == new and fed.lifecycle.n_peers == new
    for tree_b, tree_a in ((before.params, after.params),
                           (before.momentum, after.momentum),
                           (before.pipe, after.pipe)):
        for b, a in zip(jax.tree.leaves(convert.params_to_numpy(tree_b)),
                        jax.tree.leaves(convert.params_to_numpy(tree_a))):
            if b.ndim and b.shape[0] == old:
                assert a.shape[0] == new
                np.testing.assert_array_equal(a[:k], b[:k])
            else:
                np.testing.assert_array_equal(a, b)
    if new > old:
        for b, a in zip(jax.tree.leaves(convert.params_to_numpy(
                before.params)), jax.tree.leaves(convert.params_to_numpy(
                    after.params))):
            mean = b.astype(np.float64).mean(0)
            np.testing.assert_allclose(a[old:], np.broadcast_to(
                mean, a[old:].shape), atol=1e-6, rtol=0)
        err = after.pipe["int8_ef"]["err"]
        assert all(not x[old:].any() for x in jax.tree.leaves(
            convert.params_to_numpy(err)))
        assert not after.pipe["dp"]["has_delta"][old:].any()
        assert after.pipe["dp"]["has_delta"][:old].all()
    state = fed.step(after)
    assert all(np.isfinite(x).all() for x in jax.tree.leaves(
        convert.params_to_numpy(state.params)))


def test_same_n_change_raises_queue_item_13():
    fed = Federation(FederationConfig(n_peers=16, task="text"), device="cpu")
    state = fed.init_state()
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        fed.regroup(state, GridPlan(16, (2, 2, 2, 2)))
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        fed.apply_membership(state, replan.regroup_change(
            fed.plan, GridPlan(16, (2, 2, 2, 2))))
    with pytest.raises(ValueError, match="planned for 8"):
        fed.apply_membership(state, replan.plan_membership_change(
            GridPlan(8, (2, 2, 2)), 4))
    assert fed.resize(state, 16) is state
