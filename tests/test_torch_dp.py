"""The port's DP wire stage (Alg. 4) and secure indicator aggregation
(§A.2), against the JAX package's.

DP's noise is the reference's own: the unit normals its stage key
draws (``fold_in(k_agg, stage) -> split -> normal``) are handed to the
port through ``Federation.step(draws=)``. Secure aggregation's pairwise
masks come from another PRF in each package (a ``fold_in`` chain there,
a splitmix64 hash here): they cancel in every group sum, so the average
agrees to rounding, and the tests hold the protocol's properties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dp as ref_dp
from repro.core import mar_allreduce as ref_mar
from repro.core.moshpit import GridPlan as RefGridPlan

from repro_torch import convert
from repro_torch.core import dp, mar_allreduce, secagg
from repro_torch.core.federation import Federation, FederationConfig
from repro_torch.core.moshpit import GridPlan, plan_grid
from test_torch_federation import (one_torch_thread,  # noqa: F401
                                   _assert_trees_close, _np, _pair,
                                   ref_step_inputs)

ATOL = 1e-5


def _state(n, seed):
    rng = np.random.default_rng(seed)
    p = {"fc": {"w": rng.normal(size=(n, 6, 4)).astype(np.float32),
                "b": rng.normal(size=(n, 4)).astype(np.float32)}}
    m = jax.tree.map(lambda x: (0.1 * x).astype(np.float32), p)
    return {"p": p, "m": m}


@pytest.mark.parametrize("use_secagg", [False, True])
@pytest.mark.parametrize("has_delta", [False, True])
def test_dp_transform_matches_reference(use_secagg, has_delta):
    n, dims = 9, (3, 3)
    s = _state(n, seed=1)
    mask = np.array([1, 1, 0, 1, 1, 1, 1, 0, 1], np.float32)
    ref_dps = ref_dp.dp_init(jax.tree.map(jnp.asarray, s["p"]), 0.5)
    dps = _np(ref_dps)
    rng = np.random.default_rng(2)
    dps["last_global"] = jax.tree.map(
        lambda x: (x + 0.3 * rng.normal(size=x.shape)).astype(np.float32),
        s["p"])
    dps["smooth_delta"] = jax.tree.map(
        lambda x: (0.1 * rng.normal(size=x.shape)).astype(np.float32),
        s["p"])
    dps["has_delta"] = (np.ones(n, np.float32) if has_delta
                        else np.zeros(n, np.float32))
    key = jax.random.PRNGKey(4)
    keys = jax.random.split(key, len(jax.tree.leaves(s["p"])))
    noise = {"delta": [torch.from_numpy(np.array(
                 jax.random.normal(k, x.shape, jnp.float32)))
                 for k, x in zip(keys, jax.tree.leaves(s["p"]))],
             "b": torch.tensor(float(jax.random.normal(
                 jax.random.fold_in(key, 12345), ())))}
    ref_plan, plan = RefGridPlan(n, dims), GridPlan(n, dims)
    ref_out, ref_new = ref_dp.dp_transform(
        lambda st: ref_mar.mar_aggregate_sim(st, ref_plan,
                                             jnp.asarray(mask)),
        jax.tree.map(jnp.asarray, s), jax.tree.map(jnp.asarray, dps),
        jnp.asarray(mask), key, noise_multiplier=0.3, plan=ref_plan,
        use_secagg=use_secagg)
    out, new = dp.dp_transform(
        lambda st: mar_allreduce.mar_aggregate_sim(
            st, plan, torch.from_numpy(mask)),
        convert.params_from_numpy(s), convert.params_from_numpy(dps),
        torch.from_numpy(mask), noise, noise_multiplier=0.3, plan=plan,
        use_secagg=use_secagg, secagg_root=torch.tensor(77))
    _assert_trees_close(out, ref_out)
    # secagg's masks cancel to f32 rounding of values ~MASK_RANGE
    tol = 1e-4 if use_secagg else ATOL
    _assert_trees_close(new, ref_new, atol=tol)
    assert sorted(out) == ["m", "p"]


def _dp_pair(technique, kernel, **kw):
    return _pair("text", 9, kernel, technique=technique, use_dp=True,
                 noise_multiplier=0.3, local_batches=2,
                 participation_rate=0.8, dropout_rate=0.1, **kw)


def _run_with_clips(ref_fed, ref_state, fed, state, steps):
    clips = []
    for _ in range(steps):
        idx, draws = ref_step_inputs(ref_fed, ref_state)
        ref_state = ref_fed.step(ref_state)
        state = fed.step(state, batch_indices=idx, draws=draws)
        clips.append((float(state.dp["clip"]), float(ref_state.dp["clip"])))
    return ref_state, state, clips


@pytest.mark.parametrize("technique,kernel", [("mar", False), ("mar", True),
                                              ("fedavg", False)])
def test_dp_steps_match_reference(technique, kernel):
    ref_fed, ref_state, fed, state = _dp_pair(technique, kernel)
    assert fed.pipeline.stage_names == ref_fed.pipeline.stage_names == \
        ("dp",)
    ref_state, state, clips = _run_with_clips(ref_fed, ref_state, fed,
                                              state, 3)
    for got, want in clips:
        assert got == pytest.approx(want, rel=1e-6)
    assert clips[-1][0] != 1.0             # the bound moved
    _assert_trees_close(state.params, ref_state.params)
    _assert_trees_close(state.momentum, ref_state.momentum)
    _assert_trees_close(state.dp, ref_state.dp)
    assert fed.comm_bytes == ref_fed.comm_bytes
    assert fed.ledger.by_source == ref_fed.ledger.by_source
    assert fed.sim_seconds == ref_fed.sim_seconds


@pytest.mark.parametrize("kernel", [False, True])
def test_dp_with_secagg_matches_reference(kernel):
    """Secagg's root is not replayable; the average it yields agrees to
    rounding, so params and the clip bound agree within 1e-4."""
    ref_fed, ref_state, fed, state = _dp_pair("mar", kernel,
                                              use_secagg=True)
    ref_state, state, clips = _run_with_clips(ref_fed, ref_state, fed,
                                              state, 3)
    for got, want in clips:
        assert got == pytest.approx(want, abs=1e-4)
    _assert_trees_close(state.params, ref_state.params, atol=1e-4)
    _assert_trees_close(state.dp, ref_state.dp, atol=1e-4)
    assert fed.comm_bytes == ref_fed.comm_bytes


def test_dp_calibration_nan_at_small_fleets_in_both():
    """Alg. 4's z_Delta is NaN when n_t <= 10 sigma_mult (dp.py:79-81):
    at 8 peers and sigma = 1.0 both packages train to NaN."""
    ref_fed, ref_state, fed, state = _pair(
        "text", 8, False, use_dp=True, noise_multiplier=1.0, seed=7)
    for _ in range(2):
        ref_state = ref_fed.step(ref_state)
        state = fed.step(state)
    for leaf in jax.tree.leaves(_np(ref_state.params)):
        assert np.isnan(leaf).all()
    for leaf in jax.tree.leaves(convert.params_to_numpy(state.params)):
        assert np.isnan(leaf).all()


@pytest.mark.parametrize("iters,z,q", [(100, 1.0, 1.0), (100, 0.3, 1.0),
                                       (200, 1.0, 1.0), (100, 1.0, 0.1),
                                       (10, 0.0, 1.0), (150, 0.1, 1.0)])
def test_epsilon_estimate_equal(iters, z, q):
    assert dp.epsilon_estimate(iters, z, sampling_rate=q) == \
        ref_dp.epsilon_estimate(iters, z, sampling_rate=q)


# ---------------------------------------------------------------------------
# secure aggregation: the reference's properties (tests/test_secagg.py)
# ---------------------------------------------------------------------------

def _root(seed):
    return torch.tensor(seed, dtype=torch.int64)


def test_masks_cancel_in_group_sums():
    plan = GridPlan(16, (4, 4))
    b = torch.from_numpy(np.random.default_rng(0).integers(0, 2, 16)
                         .astype(np.float32))
    for rnd in range(2):
        sums, _ = secagg.secure_group_sum(b, plan, rnd, _root(7), t=3)
        for g in plan.groups_for_round(rnd):
            want = float(b[torch.as_tensor(g)].sum())
            for peer in g:
                assert abs(float(sums[peer]) - want) <= 1e-4


def test_individual_submissions_are_masked():
    plan = GridPlan(16, (4, 4))
    sub = secagg.masked_submissions(torch.zeros(16), plan, 0, _root(1), t=0)
    assert float((sub.abs() > 1.0).float().mean()) > 0.8
    assert float(sub.abs().max()) < 3 * secagg.MASK_RANGE


def test_submissions_change_per_round_key():
    plan = GridPlan(8, (2, 2, 2))
    s1 = secagg.masked_submissions(torch.ones(8), plan, 0, _root(1), t=0)
    s2 = secagg.masked_submissions(torch.ones(8), plan, 0, _root(1), t=1)
    s3 = secagg.masked_submissions(torch.ones(8), plan, 0, _root(2), t=0)
    assert float((s1 - s2).abs().max()) > 1.0
    assert float((s1 - s3).abs().max()) > 1.0


def test_full_depth_average_exact():
    plan = plan_grid(27)
    b = torch.from_numpy(np.random.default_rng(2).integers(0, 2, 27)
                         .astype(np.float32))
    avg = secagg.secure_indicator_average(b, plan, _root(3), t=5)
    np.testing.assert_allclose(avg.numpy(), float(b.mean()) * np.ones(27),
                               atol=1e-4)


def test_dropout_consistency():
    plan = GridPlan(16, (4, 4))
    b = torch.from_numpy(np.random.default_rng(4).integers(0, 2, 16)
                         .astype(np.float32))
    alive = torch.ones(16)
    alive[5] = 0.0
    sums, cnts = secagg.secure_group_sum(b, plan, 0, _root(5), t=0,
                                         alive=alive)
    for g in plan.groups_for_round(0):
        live = [i for i in g.tolist() if i != 5]
        want = float(b[torch.as_tensor(live)].sum())
        for peer in g:
            assert abs(float(sums[peer]) - want) <= 1e-4
            assert float(cnts[peer]) == len(live)


def test_pair_masks_are_uniform_and_symmetric():
    """The PRF: the same (root, lo, hi, t) gives the same mask, and the
    masks spread evenly over [-MASK_RANGE, MASK_RANGE)."""
    lo = torch.arange(4000, dtype=torch.int64)
    m1 = secagg._pair_mask_table(_root(9), lo, lo + 1, 0)
    m2 = secagg._pair_mask_table(_root(9), lo, lo + 1, 0)
    assert torch.equal(m1, m2)
    r = secagg.MASK_RANGE
    assert float(m1.min()) >= -r and float(m1.max()) < r
    hist = torch.histc(m1, bins=4, min=-r, max=r)
    assert float(hist.min()) > 800


@pytest.mark.parametrize("m,d,seed", [(2, 1, 0), (3, 2, 11), (4, 2, 7),
                                      (2, 3, 400), (3, 3, 5)])
def test_secure_average_property(m, d, seed):
    n = m ** d
    plan = GridPlan(n, (m,) * d)
    b = torch.from_numpy(np.random.default_rng(seed).random(n)
                         .astype(np.float32))
    avg = secagg.secure_indicator_average(b, plan, _root(seed), t=1)
    np.testing.assert_allclose(avg.numpy(), float(b.mean()) * np.ones(n),
                               atol=2e-4)


def test_dp_with_secagg_end_to_end():
    cfg = FederationConfig(n_peers=8, technique="mar", task="text",
                           use_dp=True, use_secagg=True,
                           noise_multiplier=0.3, seed=9)
    fed = Federation(cfg, device="cpu")
    state = fed.init_state()
    clip0 = float(state.dp["clip"])
    for _ in range(4):
        state = fed.step(state)
    assert bool(torch.isfinite(state.params["fc1"]["w"]).all())
    assert float(state.dp["clip"]) != clip0
