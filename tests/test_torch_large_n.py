"""The port's large-N engines and controllers against the JAX package's.

``core/transport.py``'s array and symbolic plans, ``runtime/
vector_network.py``, ``runtime/super_network.py``, ``core/adaptive.py``
and ``core/placement.py`` are numpy, copied with their imports
rewritten. For the same inputs:

* ``build_array_plan`` (with the MKD prefix rounds) and
  ``build_super_plan`` equal the reference's for every technique, masks
  and placements included, and the array plan equals the port's own
  list plan message for message;
* the ``vector_sim`` and ``super_sim`` transcripts equal the port's
  ``sim`` engine's and the reference's engines' — bytes, per-round and
  per-link bytes and seconds, finish times, drops — at N <= 64 on the
  uniform, wireless and regions profiles, lossy links included (exactly:
  the engines are the same numpy);
* ``candidate_grids``, ``validate_proposal``, ``carry_placement``, every
  controller's proposals over one transcript stream, the link estimator,
  ``cluster_permutation`` and every placement policy's proposals (probes
  included) equal the reference's.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import adaptive as ref_adaptive
from repro.core import moshpit as ref_moshpit
from repro.core import placement as ref_placement
from repro.core import transport as ref_transport
from repro.runtime import network as ref_network
from repro.runtime import super_network as ref_super
from repro.runtime import vector_network as ref_vector

from repro_torch.core import adaptive, moshpit, placement, transport
from repro_torch.runtime import network, super_network, vector_network
from repro_torch.runtime.transport_base import available_transports

TECHNIQUES = ("mar", "fedavg", "ar", "rdfl", "gossip", "hierarchical")
MB = 4e6


def _mask(n: int, seed: int, drop: float):
    if drop == 0:
        return None
    m = (np.random.default_rng(seed).random(n) >= drop).astype(np.float32)
    m[0] = 1.0
    return m


def _plans(n: int, placed: bool):
    """(port, reference) GridPlans of ``plan_grid(n)``, optionally with a
    seeded peer -> slot permutation."""
    dims = moshpit.plan_grid(n).dims
    perm = None
    if placed:
        cap = int(np.prod(dims))
        perm = tuple(int(x) for x in
                     np.random.default_rng(n).permutation(cap))
    return (moshpit.GridPlan(n, dims, perm),
            ref_moshpit.GridPlan(n, dims, perm))


def _arrays(ap):
    return (ap.technique, ap.n_peers, ap.n_nodes, ap.kd_rounds,
            ap.src.tolist(), ap.dst.tolist(), ap.nbytes.tolist(),
            ap.round_ptr.tolist())


def _transcript(tr) -> dict:
    """A transcript as plain values, messages as (src, dst, nbytes)."""
    out = {}
    for f in dataclasses.fields(tr):
        v = getattr(tr, f.name)
        if isinstance(v, np.ndarray):
            v = v.tolist()
        elif f.name == "dropped":
            v = [dataclasses.astuple(m) for m in v]
        out[f.name] = v
    return out


@pytest.mark.parametrize("kd", [False, True])
@pytest.mark.parametrize("drop,placed", [(0.0, False), (0.3, True)])
@pytest.mark.parametrize("technique", TECHNIQUES)
def test_array_and_super_plans_equal_the_references(technique, drop,
                                                    placed, kd):
    n = 27
    plan, ref_plan = _plans(n, placed)
    mask = _mask(n, 3, drop)
    got = transport.build_array_plan(technique, plan, mask, MB)
    want = ref_transport.build_array_plan(technique, ref_plan, mask, MB)
    listed = transport.ArrayMessagePlan.from_plan(
        transport.build_message_plan(technique, plan, mask, MB))
    if kd and technique == "mar":
        got = transport.with_mkd_traffic_arrays(got, plan, mask, MB, 640)
        want = ref_transport.with_mkd_traffic_arrays(want, ref_plan, mask,
                                                     MB, 640)
        listed = transport.ArrayMessagePlan.from_plan(
            transport.with_mkd_traffic(
                transport.build_message_plan(technique, plan, mask, MB),
                plan, mask, MB, 640))
    assert _arrays(got) == _arrays(want) == _arrays(listed)
    use_kd = kd and technique == "mar"
    sp = transport.build_super_plan(technique, plan, mask, MB,
                                    use_kd=use_kd, raw_model_bytes=MB,
                                    kd_logit_bytes=640)
    ref_sp = ref_transport.build_super_plan(technique, ref_plan, mask, MB,
                                            use_kd=use_kd,
                                            raw_model_bytes=MB,
                                            kd_logit_bytes=640)
    assert (sp.n_nodes, sp.kd_rounds, sp.n_messages_estimate()) == \
        (ref_sp.n_nodes, ref_sp.kd_rounds, ref_sp.n_messages_estimate())
    assert _arrays(sp.to_array_plan()) == _arrays(ref_sp.to_array_plan()) \
        == _arrays(got)


ENGINES = {"vector_sim": (vector_network.VectorNetworkSim,
                          ref_vector.VectorNetworkSim),
           "super_sim": (super_network.SuperNetworkSim,
                         ref_super.SuperNetworkSim)}


@pytest.mark.parametrize("profile,link_params", [
    ("uniform", None), ("wireless", {"loss": 0.1}),
    ("regions", {"shuffle": True})])
@pytest.mark.parametrize("technique", ["mar", "fedavg", "rdfl", "gossip",
                                       "hierarchical"])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_engine_transcripts_equal_sim_and_the_references(engine, technique,
                                                         profile,
                                                         link_params):
    """Two iterations at N = 64 (a 2^6 grid) and N = 27, the second with
    a mask, through the port's engine, the port's ``sim`` and the
    reference's engine: every field equal. ``super_sim`` on the regions
    profile is byte-exact only (its closed forms skip the pairwise WAN
    terms the vector path times), as the reference states."""
    port_cls, ref_cls = ENGINES[engine]
    for n in (64, 27):
        plan, ref_plan = _plans(n, placed=n == 27)
        nets = [port_cls(n, profile=profile, seed=1,
                         link_params=link_params),
                network.NetworkSim(n, profile=profile, seed=1,
                                   link_params=link_params),
                ref_cls(n, profile=profile, seed=1,
                        link_params=link_params)]
        for it in range(2):
            mask = _mask(n, it, 0.25 * it)
            if engine == "super_sim":
                plans = [transport.build_super_plan(technique, plan, mask,
                                                    MB),
                         transport.build_message_plan(technique, plan,
                                                      mask, MB),
                         ref_transport.build_super_plan(technique,
                                                        ref_plan, mask, MB)]
            else:
                plans = [transport.build_array_plan(technique, plan, mask,
                                                    MB),
                         transport.build_message_plan(technique, plan,
                                                      mask, MB),
                         ref_transport.build_array_plan(technique,
                                                        ref_plan, mask, MB)]
            got, sim, ref = (_transcript(net.run(p))
                             for net, p in zip(nets, plans))
            assert got == ref
            if engine == "super_sim" and profile == "regions":
                for key in ("total_bytes", "bytes_by_round", "n_messages"):
                    assert got[key] == sim[key]
            else:
                # the heap engine lists drops in arrival order, the
                # batched engines round by round: the same set
                for tr in (got, sim):
                    tr["dropped"] = sorted(tr["dropped"])
                assert got == sim
        assert nets[0].clock == nets[2].clock


def test_every_engine_of_the_reference_but_socket_is_registered():
    """Every engine of the reference, the socket included since it was
    ported, is registered: the same names as the reference's registry."""
    from repro.runtime.transport_base import \
        available_transports as ref_available_transports

    assert available_transports() == ["sim", "socket", "super_sim",
                                      "vector_sim"]
    assert available_transports() == ref_available_transports()


@pytest.mark.parametrize("n", [8, 16, 27, 36, 64, 125])
@pytest.mark.parametrize("exact_only", [False, True])
def test_candidate_grids_and_proposals_equal(n, exact_only):
    got = adaptive.candidate_grids(n, exact_only=exact_only)
    want = ref_adaptive.candidate_grids(n, exact_only=exact_only)
    assert [c.dims for c in got] == [c.dims for c in want]
    plan, ref_plan = _plans(n, placed=True)
    for c, rc in zip(got, want):
        new = adaptive.validate_proposal(adaptive.carry_placement(plan, c),
                                         n, exact_only=exact_only)
        ref_new = ref_adaptive.validate_proposal(
            ref_adaptive.carry_placement(ref_plan, rc), n,
            exact_only=exact_only)
        assert (new.dims, new.placement) == (ref_new.dims,
                                             ref_new.placement)
    with pytest.raises(ValueError):
        adaptive.validate_proposal(moshpit.GridPlan(n + 1, (n + 1,)), n)


@pytest.mark.parametrize("controller,params,profile", [
    ("static", {}, "wireless"),
    ("tail_aware", {}, "wireless"),
    ("tail_aware", {"window": 2, "hi": 1.2, "lo": 1.05}, "regions"),
    ("schedule", {"schedule": ((1, (4, 4, 4)), (4, (8, 8)))},
     "uniform")])
def test_controllers_propose_what_the_references_propose(controller, params,
                                                         profile):
    """Each package's controller, fed the transcripts of its own engine
    over the grid in force, for 8 iterations at N = 64: the same grids."""
    n = 64
    plan, ref_plan = _plans(n, placed=False)
    ctl = adaptive.build_controller(controller, plan, **params)
    ref_ctl = ref_adaptive.build_controller(controller, ref_plan, **params)
    net = vector_network.VectorNetworkSim(n, profile=profile, seed=2)
    ref_net = ref_vector.VectorNetworkSim(n, profile=profile, seed=2)
    seen = []
    for t in range(8):
        tr = net.run(transport.build_array_plan("mar", plan, None, MB))
        ref_tr = ref_net.run(ref_transport.build_array_plan(
            "mar", ref_plan, None, MB))
        got, want = ctl.observe(t, tr, plan), ref_ctl.observe(t, ref_tr,
                                                              ref_plan)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.dims, got.placement) == (want.dims, want.placement)
            plan, ref_plan = got, want
            seen.append((t, got.dims))
    if controller == "schedule":
        assert seen == [(1, (4, 4, 4)), (4, (8, 8))]


@pytest.mark.parametrize("n", [16, 27, 64])
def test_cluster_labels_and_permutation_equal(n):
    rng = np.random.default_rng(n)
    feats = np.concatenate([rng.normal(c, 0.1, size=(n // 4 + (i < n % 4),
                                                      3))
                            for i, c in enumerate((0.0, 1.0, 2.0, 3.0))])
    labels = placement.cluster_labels(feats, seed=0)
    assert labels.tolist() == ref_placement.cluster_labels(
        feats, seed=0).tolist()
    plan, ref_plan = _plans(n, placed=False)
    for cap, align in ((None, None), (plan.capacity, plan.dims[0]),
                       (2 * n, 4)):
        assert placement.cluster_permutation(labels, cap, align).tolist() \
            == ref_placement.cluster_permutation(labels, cap, align).tolist()


@pytest.mark.parametrize("policy", ["identity", "random", "clustered"])
@pytest.mark.parametrize("n", [27, 64])
def test_placement_policies_propose_what_the_references_propose(policy, n):
    """Each package's policy, probing through its own engine on the
    shuffled regions profile, for 6 iterations: the same targets, the
    same probe transcripts, the same learned labels."""
    plan, ref_plan = _plans(n, placed=False)
    shuf = {"shuffle": True}
    net = network.NetworkSim(n, "regions", seed=0, link_params=shuf)
    ref_net = ref_network.NetworkSim(n, "regions", seed=0, link_params=shuf)
    pol = placement.build_placement(policy, plan, seed=0)
    ref_pol = ref_placement.build_placement(policy, ref_plan, seed=0)
    probes, ref_probes = [], []
    pol.bind_prober(lambda mp: probes.append(net.run(mp)) or probes[-1])
    ref_pol.bind_prober(lambda mp: ref_probes.append(ref_net.run(mp))
                        or ref_probes[-1])
    for t in range(6):
        tr = net.run(transport.build_message_plan("mar", plan, None, MB))
        ref_tr = ref_net.run(ref_transport.build_message_plan(
            "mar", ref_plan, None, MB))
        got = pol.observe(t, tr, plan)
        want = ref_pol.observe(t, ref_tr, ref_plan)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.dims, got.placement) == (want.dims, want.placement)
            plan, ref_plan = got, want
    assert [_transcript(p) for p in probes] == \
        [_transcript(p) for p in ref_probes]
    if policy == "clustered":
        assert probes and pol.labels.tolist() == ref_pol.labels.tolist()
