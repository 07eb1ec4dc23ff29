"""The port's sim MAR and aggregators against the JAX package's.

Same state and churn masks (numpy seeds) through both packages, with and
without the group-mean kernel path (the plain version on the CPU),
mirroring ``tests/test_aggregation.py``'s kernel-parity grids. atol 1e-6:
the sums differ only in f32 summation order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as ref_agg
from repro.core import mar_allreduce as ref_mar
from repro.core.moshpit import GridPlan as RefGridPlan
from repro.runtime.network import NetworkSim as RefNetworkSim

from repro_torch.core import aggregation, mar_allreduce
from repro_torch.core.moshpit import GridPlan
from repro_torch.runtime.network import NetworkSim

ATOL = 1e-6


def _state(n, seed):
    rng = np.random.default_rng(seed)
    return {"p": rng.normal(size=(n, 5, 3)).astype(np.float32),
            "m": rng.normal(size=(n,)).astype(np.float32),
            "w": {"b": rng.normal(size=(n, 7)).astype(np.float32)}}


def _mask(n, seed, rate=0.7):
    mask = (np.random.default_rng(seed + 100).random(n) < rate)
    mask = mask.astype(np.float32)
    mask[0] = 1.0
    return mask


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _assert_close(port, ref, atol=ATOL):
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _assert_close(port[k], ref[k], atol)
        return
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("n,dims", [(16, (4, 4)), (27, (3, 3, 3)),
                                    (12, (4, 4))])  # last one: padded grid
def test_mar_aggregate_sim_matches_reference(n, dims, use_kernel):
    s, mask = _state(n, seed=n), _mask(n, seed=n)
    ref = ref_mar.mar_aggregate_sim(_to_jax(s), RefGridPlan(n, dims),
                                    jnp.asarray(mask))
    port = mar_allreduce.mar_aggregate_sim(
        _to_torch(s), GridPlan(n, dims), torch.from_numpy(mask),
        use_kernel=use_kernel)
    _assert_close(port, ref)


def test_kernel_path_matches_reference_kernel_path():
    """The port's kernel route (its plain version here) against the
    reference's Pallas route (interpret mode) on the padded grid."""
    n, dims = 12, (4, 4)
    s, mask = _state(n, seed=5), _mask(n, seed=5, rate=0.5)
    ref = ref_mar.mar_aggregate_sim(_to_jax(s), RefGridPlan(n, dims),
                                    jnp.asarray(mask), use_kernel=True)
    port = mar_allreduce.mar_aggregate_sim(
        _to_torch(s), GridPlan(n, dims), torch.from_numpy(mask),
        use_kernel=True)
    _assert_close(port, ref)


@pytest.mark.parametrize("rnd", [0, 1, 2])
def test_single_round_and_full_participation(rnd):
    n, dims = 27, (3, 3, 3)
    s = _state(n, seed=rnd)
    ref = ref_mar.mar_round_sim(_to_jax(s), RefGridPlan(n, dims), rnd)
    for use_kernel in (False, True):
        port = mar_allreduce.mar_round_sim(_to_torch(s), GridPlan(n, dims),
                                           rnd, use_kernel=use_kernel)
        _assert_close(port, ref)


@pytest.mark.parametrize("technique", ["mar", "fedavg", "ar", "rdfl",
                                       "hierarchical", "gossip"])
@pytest.mark.parametrize("n", [12, 16])
def test_every_technique_matches_reference(technique, n):
    s, mask = _state(n, seed=3 * n), _mask(n, seed=n)
    dims = (4, 4) if n == 16 else (3, 2, 2)
    ref_a = ref_agg.make_aggregator(technique, RefGridPlan(n, dims))
    port_a = aggregation.make_aggregator(technique, GridPlan(n, dims))
    assert port_a.num_rounds == ref_a.num_rounds
    _assert_close(port_a(_to_torch(s), torch.from_numpy(mask)),
                  ref_a(_to_jax(s), jnp.asarray(mask)))
    assert port_a.iteration_bytes(int(mask.sum()), 1000, mask) == \
        ref_a.iteration_bytes(int(mask.sum()), 1000, mask)


def test_ring_allreduce_and_finalize_match():
    s, mask = _state(8, seed=1), _mask(8, seed=1)
    _assert_close(mar_allreduce.ring_allreduce_sim(_to_torch(s),
                                                   torch.from_numpy(mask)),
                  ref_mar.ring_allreduce_sim(_to_jax(s), jnp.asarray(mask)))
    rng = np.random.default_rng(2)
    num, own = rng.normal(size=(4, 3)), rng.normal(size=(4, 3))
    den = np.array([[0.0], [1.0], [2.5], [0.0]])
    for floor in (1.0, 1e-12):
        port = aggregation.finalize_masked_mean(
            torch.tensor(num, dtype=torch.float32),
            torch.tensor(den, dtype=torch.float32),
            torch.tensor(own, dtype=torch.float32), floor=floor)
        ref = ref_agg.finalize_masked_mean(
            jnp.asarray(num, jnp.float32), jnp.asarray(den, jnp.float32),
            jnp.asarray(own, jnp.float32), floor=floor)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("technique", ["mar", "gossip", "hierarchical"])
def test_pipeline_ledger_matches_reference(technique):
    n, mask = 16, _mask(16, seed=9)
    ref_p = ref_agg.build_pipeline(technique, RefGridPlan(n, (4, 4)))
    port_p = aggregation.build_pipeline(technique, GridPlan(n, (4, 4)))
    ref_l, port_l = ref_agg.CommLedger(), aggregation.CommLedger()
    ref_net = RefNetworkSim(n, "wireless", seed=4)
    port_net = NetworkSim(n, "wireless", seed=4)
    for _ in range(2):
        ref_p.record_transcript(
            ref_l, ref_net.run(ref_p.message_plan(mask, 808096, 0)),
            int(mask.sum()), 808096)
        port_p.record_transcript(
            port_l, port_net.run(port_p.message_plan(mask, 808096, 0)),
            int(mask.sum()), 808096)
    assert port_l.by_source == ref_l.by_source
    assert port_l.total_bytes == ref_l.total_bytes
    assert port_l.total_seconds == ref_l.total_seconds


@pytest.mark.parametrize("flag", [{"async_aggregation": True},
                                  {"use_dp": True}, {"use_secagg": True},
                                  {"compress": "int8_ef"}])
def test_wire_stages_build(flag):
    """Each stage flag builds the reference's stage list."""
    port = aggregation.build_pipeline("mar", GridPlan(4, (2, 2)), **flag)
    ref = ref_agg.build_pipeline("mar", RefGridPlan(4, (2, 2)), **flag)
    assert port.stage_names == ref.stage_names
    assert set(port.stage_names) <= set(aggregation.WIRE_STAGES)
    with pytest.raises(ValueError):
        aggregation.make_aggregator("pigeon", GridPlan(4, (2, 2)))


# ---------------------------------------------------------------------------
# one MAR round through the round entry (its plain version on the CPU)
# against the reference's Pallas route (interpret mode)
# ---------------------------------------------------------------------------

def _drop_group(mask, plan, rnd, slot):
    """``mask`` with every real peer of the round-``rnd`` group holding
    grid slot ``slot`` set to 0; returns (mask, those peers)."""
    keys = plan.group_key(np.arange(plan.capacity), rnd)
    peers = [p for p in np.flatnonzero(keys == keys[slot])
             if p < plan.n_peers]
    mask = mask.copy()
    mask[peers] = 0.0
    return mask, peers


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("n,dims,rnd", [
    (27, (3, 3, 3), 0), (27, (3, 3, 3), 1), (27, (3, 3, 3), 2),
    (12, (4, 4), 0), (12, (4, 4), 1),                  # virtual slots
    (13, (2, 2, 2, 2), 0), (13, (2, 2, 2, 2), 1), (13, (2, 2, 2, 2), 2),
    (13, (2, 2, 2, 2), 3)])
def test_kernel_round_matches_reference_kernel_round(n, dims, rnd, drop):
    """Leaves [N, 5, 3], [N] (d = 1) and [N, 7]; with ``drop`` one whole
    group (the one holding the last slot, a virtual one on the padded
    grids) is dropped and must keep its rows exactly."""
    s, mask = _state(n, seed=7 * n + rnd), _mask(n, seed=n + rnd)
    plan = GridPlan(n, dims)
    peers = []
    if drop:
        mask, peers = _drop_group(mask, plan, rnd, plan.capacity - 1)
    ref = ref_mar._kernel_round(_to_jax(s), RefGridPlan(n, dims), rnd,
                                jnp.asarray(mask))
    port = mar_allreduce._kernel_round(_to_torch(s), plan, rnd,
                                       torch.from_numpy(mask))
    _assert_close(port, ref)
    for got, x in zip((port["p"], port["m"], port["w"]["b"]),
                      (s["p"], s["m"], s["w"]["b"])):
        np.testing.assert_array_equal(got.numpy()[peers], x[peers])


@pytest.mark.parametrize("rnd", [0, 1, 2])
def test_kernel_round_bf16_leaf_matches_reference(rnd):
    """A bf16 leaf beside f32 ones (two launches on the card: one per
    dtype); the dropped group keeps its bf16 rows bit for bit."""
    n, dims = 27, (3, 3, 3)
    rng = np.random.default_rng(20 + rnd)
    h = rng.normal(size=(n, 40)).astype(np.float32)
    f = rng.normal(size=(n, 6)).astype(np.float32)
    plan = GridPlan(n, dims)
    mask, peers = _drop_group(_mask(n, seed=rnd), plan, rnd, 0)
    ref = ref_mar._kernel_round(
        {"f": jnp.asarray(f), "h": jnp.asarray(h).astype(jnp.bfloat16)},
        RefGridPlan(n, dims), rnd, jnp.asarray(mask))
    h_t = torch.from_numpy(h).to(torch.bfloat16)
    port = mar_allreduce._kernel_round(
        {"f": torch.from_numpy(f), "h": h_t}, plan, rnd,
        torch.from_numpy(mask))
    assert port["h"].dtype == torch.bfloat16
    np.testing.assert_allclose(port["f"].numpy(), np.asarray(ref["f"]),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(port["h"].float().numpy(),
                               np.asarray(ref["h"], np.float32),
                               atol=2e-2, rtol=0)
    assert torch.equal(port["h"][peers], h_t[peers])


@pytest.mark.parametrize("n,dims,rnd", [(27, (3, 3, 3), 1),
                                        (13, (2, 2, 2, 2), 2),
                                        (26, (3, 3, 3), 0), (125, (125,), 0)])
def test_group_sums_are_the_index_add_sums(n, dims, rnd):
    """The card's kernel-off route sums each group's rows after
    gathering them by the round's order (``index_add_``'s atomics add in
    another order on every run there); on the same rows it gives the
    CPU's ``index_add_`` sums, every group's rows ascending."""
    plan = GridPlan(n, dims)
    idx = mar_allreduce.round_index(plan, rnd, torch.device("cpu"))
    cap, groups = plan.capacity, plan.capacity // plan.dims[rnd]
    x = torch.from_numpy(np.random.default_rng(n).normal(
        size=(cap, 5, 3)).astype(np.float32))
    assert bool((idx.order.reshape(groups, -1).diff(dim=1) > 0).all())
    want = torch.zeros((groups, 5, 3)).index_add_(0, idx.seg, x)
    got = mar_allreduce._group_sums(x, idx.order, groups)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
