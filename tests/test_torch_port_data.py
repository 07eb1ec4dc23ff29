"""The port's framework-free copies equal the JAX package's modules.

Grid, partitions, synthetic data, lifecycle masks, message plans and the
network simulator are numpy in both packages, so every comparison here
is exact.
"""
import numpy as np
import pytest
import torch

from repro.core import moshpit as ref_moshpit
from repro.core import topology as ref_topology
from repro.core import transport as ref_transport
from repro.data import partition as ref_partition
from repro.data import synthetic as ref_synthetic
from repro.runtime import fault as ref_fault
from repro.runtime import lifecycle as ref_lifecycle
from repro.runtime.network import NetworkSim as RefNetworkSim

from repro_torch import convert
from repro_torch.core import moshpit, topology, transport
from repro_torch.data import partition, synthetic
from repro_torch.runtime import fault, lifecycle
from repro_torch.runtime.network import NetworkSim
from repro_torch.runtime.transport_base import (available_transports,
                                                build_transport)


@pytest.mark.parametrize("n", [8, 12, 16, 27, 125])
def test_plan_grid_dims_and_group_keys(n):
    ref, port = ref_moshpit.plan_grid(n), moshpit.plan_grid(n)
    assert port.dims == ref.dims and port.n_peers == ref.n_peers
    slots = np.arange(ref.capacity)
    for rnd in range(ref.depth):
        np.testing.assert_array_equal(port.group_key(slots, rnd),
                                      ref.group_key(slots, rnd))
        np.testing.assert_array_equal(port.partner_matrix(rnd),
                                      ref.partner_matrix(rnd))


def test_placement_and_elastic_replan_match():
    perm = np.random.default_rng(3).permutation(27)
    ref = ref_moshpit.GridPlan(27, (3, 3, 3)).with_placement(perm)
    port = moshpit.GridPlan(27, (3, 3, 3)).with_placement(perm)
    assert port.placement == ref.placement
    for rnd in range(3):
        np.testing.assert_array_equal(port.group_key(np.arange(27), rnd),
                                      ref.group_key(np.arange(27), rnd))
    for old, new_n in [((4, 4), 64), ((4, 4), 12), ((3, 3, 3), 9)]:
        r = ref_fault.elastic_replan(ref_moshpit.GridPlan(16, old), new_n)
        p = fault.elastic_replan(moshpit.GridPlan(16, old), new_n)
        assert p.dims == r.dims


@pytest.mark.parametrize("alpha", [None, 1.0, 0.1])
def test_partitions_equal(alpha):
    labels = np.random.default_rng(0).integers(0, 10, size=500)
    if alpha is None:
        ref = ref_partition.iid_partition(500, 7, seed=2)
        port = partition.iid_partition(500, 7, seed=2)
    else:
        ref = ref_partition.dirichlet_partition(labels, 7, alpha=alpha,
                                                seed=2)
        port = partition.dirichlet_partition(labels, 7, alpha=alpha, seed=2)
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("task", ["text", "vision"])
def test_classification_task_bit_equal(task):
    rs, rtrain, rtest = ref_synthetic.classification_task(task, seed=4)
    ps, ptrain, ptest = synthetic.classification_task(task, seed=4)
    assert (ps.name, ps.num_classes, ps.feature_dim) == \
        (rs.name, rs.num_classes, rs.feature_dim)
    for p, r in [(ptrain, rtrain), (ptest, rtest)]:
        for k in ("x", "y"):
            assert p[k].dtype == r[k].dtype
            np.testing.assert_array_equal(p[k], r[k])


@pytest.mark.parametrize("churn,params", [
    (None, {}),
    ("sessions", {"mean_up": 4.0, "mean_down": 2.0}),
    ("correlated", {"n_regions": 3, "outage_rate": 0.3}),
])
def test_lifecycle_ticks_equal(churn, params):
    kw = dict(seed=5, participation_rate=0.7, dropout_rate=0.1,
              churn_params=params)
    ref = ref_lifecycle.build_lifecycle(churn, 12, **kw)
    port = lifecycle.build_lifecycle(churn, 12, **kw)
    for t in range(10):
        r, p = ref.tick(t), port.tick(t)
        np.testing.assert_array_equal(p.u, r.u)
        np.testing.assert_array_equal(p.a, r.a)
        assert p.resize_to == r.resize_to
    assert [(e.iteration, e.kind, e.peers) for e in port.event_log] == \
        [(e.iteration, e.kind, e.peers) for e in ref.event_log]


def _assert_transcripts_equal(p, r):
    assert p.total_bytes == r.total_bytes
    assert p.iteration_s == r.iteration_s
    assert p.n_messages == r.n_messages
    assert p.bytes_by_round == r.bytes_by_round
    assert p.round_s == r.round_s
    assert p.bytes_by_link == r.bytes_by_link
    assert p.link_time_stats == r.link_time_stats
    np.testing.assert_array_equal(p.peer_finish_s, r.peer_finish_s)
    np.testing.assert_array_equal(p.lost_senders, r.lost_senders)
    assert [(m.src, m.dst, m.nbytes) for m in p.dropped] == \
        [(m.src, m.dst, m.nbytes) for m in r.dropped]


@pytest.mark.parametrize("technique", ["mar", "fedavg", "ar", "gossip",
                                       "rdfl", "hierarchical"])
@pytest.mark.parametrize("profile,link_params", [
    ("uniform", {}),
    ("wireless", {"loss": 0.15}),
])
def test_network_transcripts_equal(technique, profile, link_params):
    n = 12
    mask = (np.random.default_rng(1).random(n) < 0.8).astype(np.float32)
    mask[0] = 1.0
    ref_plan = ref_moshpit.plan_grid(n)
    port_plan = moshpit.plan_grid(n)
    ref_net = RefNetworkSim(n, profile, seed=3, link_params=link_params)
    port_net = NetworkSim(n, profile, seed=3, link_params=link_params)
    for _ in range(3):        # the loss stream advances per iteration
        rp = ref_transport.build_message_plan(technique, ref_plan, mask,
                                              808096.0)
        pp = transport.build_message_plan(technique, port_plan, mask,
                                          808096.0)
        assert pp.rounds == tuple(
            tuple(transport.Message(m.src, m.dst, m.nbytes) for m in rnd)
            for rnd in rp.rounds)
        _assert_transcripts_equal(port_net.run(pp), ref_net.run(rp))
    assert port_net.clock == ref_net.clock


@pytest.mark.parametrize("technique", ["mar", "fedavg", "ar", "gossip",
                                       "rdfl", "hierarchical"])
def test_topology_oracles_equal(technique):
    mask = np.ones(16, np.float32)
    mask[[2, 9]] = 0.0
    for m in (None, mask):
        assert topology.iteration_bytes(
            technique, 14, 1000, moshpit.plan_grid(16), mask=m) == \
            ref_topology.iteration_bytes(
                technique, 14, 1000, ref_moshpit.plan_grid(16), mask=m)


def test_pytree_bytes_over_tensors():
    tree = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5,
                                                        dtype=torch.bfloat16)}}
    assert topology.pytree_bytes(tree) == \
        ref_topology.pytree_bytes({"a": np.zeros((3, 4), np.float32),
                                   "b": {"c": np.zeros(5, np.float16)}})


def test_only_the_socket_transport_is_unported():
    """The last of the reference's transports is ported: all four are
    registered and build by name."""
    assert available_transports() == ["sim", "socket", "super_sim",
                                      "vector_sim"]
    for name in ("sim", "socket", "super_sim", "vector_sim"):
        assert build_transport(name, 8).name == name
    with pytest.raises(ValueError):
        build_transport("pigeon", 8)


def test_convert_round_trip():
    rng = np.random.default_rng(0)
    tree = {"fc1": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                    "b": np.zeros(3, np.float32)},
            "conv1": rng.normal(size=(3, 3, 1, 2)).astype(np.float32)}
    back = convert.params_to_numpy(convert.params_from_numpy(tree))
    for k in ("w", "b"):
        np.testing.assert_array_equal(back["fc1"][k], tree["fc1"][k])
    np.testing.assert_array_equal(back["conv1"], tree["conv1"])


# ---------------------------------------------------------------------------
# mixing (Eq. 1): numpy-seeded, the same draws in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,r", [(8, 2), (27, 9), (125, 25), (16, 1)])
def test_mixing_contraction_factor_equal(n, r):
    from repro.core import mixing as ref_mixing

    from repro_torch.core import mixing
    assert mixing.contraction_factor(n, r) == \
        ref_mixing.contraction_factor(n, r)
    assert mixing.predicted_distortion(2.5, n, r, 4) == \
        ref_mixing.predicted_distortion(2.5, n, r, 4)


def test_mixing_random_group_average_and_contraction():
    """The random partition is the reference's draw for draw, so one
    averaging step is bit-exact; distortions agree to f32 rounding."""
    import jax.numpy as jnp

    from repro.core import mixing as ref_mixing

    from repro_torch.core import mixing
    x = np.random.default_rng(0).normal(size=(12, 16)).astype(np.float32)
    got = mixing.random_group_average(torch.from_numpy(x), 3,
                                      np.random.default_rng(5))
    want = ref_mixing.random_group_average(jnp.asarray(x), 3,
                                           np.random.default_rng(5))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert mixing.distortion(got) == pytest.approx(
        ref_mixing.distortion(want), rel=1e-6)
    emp, pred = mixing.empirical_contraction(16, 4, 3, trials=4, seed=1)
    ref_emp, ref_pred = ref_mixing.empirical_contraction(16, 4, 3, trials=4,
                                                         seed=1)
    assert pred == ref_pred
    assert emp == pytest.approx(ref_emp, rel=1e-5)
