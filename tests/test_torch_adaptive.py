"""The port's federation under adaptive group sizing and topology-aware
placement, step for step against the JAX package's.

``FederationConfig.adaptive_m`` and ``.placement`` (``core/adaptive.py``,
``core/placement.py``) regroup the grid at the same N through
``Federation.apply_membership``; ``transport`` picks the ``sim``,
``vector_sim`` or ``super_sim`` engine. From the reference's theta^0 and
replayed minibatch indices (``test_torch_federation.run_pair``), at N =
16 to 27: the ledger by source, ``regroup_log`` and ``placement_log``
equal, ``sim_seconds`` within 1e-9, and theta and m within 1e-5 after
every step — through a scripted regroup onto a padded grid (virtual
slots) and back, the tail-aware controller, the clustered policy (its
probes billed as ``placement_probe``) and both at once, with the
group-mean kernel's route (its plain version here) and without.
"""
import numpy as np
import pytest

from repro_torch.core import mar_allreduce
from repro_torch.core.moshpit import GridPlan
from test_torch_federation import (one_torch_thread,  # noqa: F401
                                   _assert_trees_close, _pair,
                                   ref_step_inputs)

SHUF = {"shuffle": True}
CASES = {
    # 27 on (3, 3, 3) -> (2, 2, 2, 2, 2): 32 slots, 5 virtual; then back
    "schedule_padded": dict(n=27, kernel=True, adaptive_m="schedule",
                            adaptive_m_params={"schedule": (
                                (0, (2, 2, 2, 2, 2)), (2, (3, 3, 3)))},
                            link_profile="wireless"),
    "tail_aware_wireless": dict(n=27, kernel=False, adaptive_m="tail_aware",
                                adaptive_m_params={"window": 1, "hi": 1.1,
                                                   "lo": 1.05},
                                link_profile="wireless"),
    "clustered_vector_sim": dict(n=16, kernel=True, placement="clustered",
                                 link_profile="regions", link_params=SHUF,
                                 transport="vector_sim"),
    "both_super_sim": dict(n=27, kernel=True, placement="clustered",
                           adaptive_m="tail_aware",
                           adaptive_m_params={"window": 1, "hi": 1.1,
                                              "lo": 1.05},
                           link_profile="regions", link_params=SHUF,
                           transport="super_sim"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_controlled_federation_matches_reference(case):
    kw = dict(CASES[case])
    n, kernel = kw.pop("n"), kw.pop("kernel")
    ref_fed, ref_state, fed, state = _pair("text", n, kernel, **kw)
    for _ in range(5):
        idx, draws = ref_step_inputs(ref_fed, ref_state)
        ref_state = ref_fed.step(ref_state)
        state = fed.step(state, batch_indices=idx, draws=draws)
        assert (fed.plan.dims, fed.plan.placement) == \
            (ref_fed.plan.dims, ref_fed.plan.placement)
        _assert_trees_close(state.params, ref_state.params)
        _assert_trees_close(state.momentum, ref_state.momentum)
    assert fed.regroup_log == ref_fed.regroup_log
    assert fed.placement_log == ref_fed.placement_log
    assert dict(fed.ledger.by_source) == dict(ref_fed.ledger.by_source)
    assert abs(fed.sim_seconds - ref_fed.sim_seconds) <= 1e-9
    if "adaptive_m" in kw:
        assert fed.regroup_log, "no regroup: the case tests nothing"
    if "placement" in kw:
        assert fed.placement_log
        assert fed.ledger.by_source["placement_probe"] > 0
    if case == "schedule_padded":
        assert [r[2] for r in fed.regroup_log] == [(2, 2, 2, 2, 2),
                                                   (3, 3, 3)]


def test_regroup_reads_the_new_grids_round_tables():
    """The group-mean kernel reads every row through the round's order,
    so a table of the old grid would be a silent wrong answer. The round
    tables are keyed on the frozen plan, placement included: after a
    regroup onto new dims, and after one that only permutes the peers,
    the next step reads the new grid's order and matches the reference.
    The plan cache is dropped."""
    ref_fed, ref_state, fed, state = _pair("text", 16, True,
                                           link_profile="wireless")
    RefPlan = ref_fed.plan.__class__
    perm = np.random.default_rng(0).permutation(16)
    for new, ref_new in [(GridPlan(16, (4, 4)), RefPlan(16, (4, 4))),
                         (GridPlan(16, (4, 4)).with_placement(perm),
                          RefPlan(16, (4, 4)).with_placement(perm))]:
        idx, draws = ref_step_inputs(ref_fed, ref_state)
        ref_state = ref_fed.step(ref_state)
        state = fed.step(state, batch_indices=idx, draws=draws)
        old = fed.plan
        state = fed.regroup(state, new)
        ref_state = ref_fed.regroup(ref_state, ref_new)
        assert not fed._plan_cache and fed.pipeline.aggregator.plan == new
        for rnd in range(len(new.dims)):
            got = mar_allreduce.round_index(
                new, rnd, fed.device).order.cpu().numpy()
            want = np.argsort(new.group_key(np.arange(16), rnd),
                              kind="stable")
            np.testing.assert_array_equal(got, want)
        assert any(not np.array_equal(
            mar_allreduce.round_index(old, r, "cpu").order.numpy(),
            mar_allreduce.round_index(new, r, "cpu").order.numpy())
            for r in range(len(new.dims)))
        idx, draws = ref_step_inputs(ref_fed, ref_state)
        ref_state = ref_fed.step(ref_state)
        state = fed.step(state, batch_indices=idx, draws=draws)
        _assert_trees_close(state.params, ref_state.params)
        assert fed.comm_bytes == ref_fed.comm_bytes
    # a regroup to the grid in force changes nothing
    assert fed.regroup(state, new) is state
    with pytest.raises(ValueError):
        fed.regroup(state, GridPlan(16, (2, 2, 2)))
    assert np.isfinite(fed.evaluate(state))


def test_each_step_span_is_recorded_once_with_the_controllers():
    """With a controller and a placement policy the step still opens
    each of its ``torch.profiler`` labels once (the profile phases count
    ranges per step); the controllers run after the aggregation span."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import federation as F

    fed = F.Federation(F.FederationConfig(
        n_peers=16, adaptive_m="tail_aware", placement="clustered",
        link_profile="regions", link_params=SHUF), device="cpu")
    state = fed.step(fed.init_state())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            state = fed.step(state)
    names = [e.name for e in prof.events()]
    for span in (F.SPAN_TRANSPORT, F.SPAN_LOCAL_UPDATE, F.SPAN_AGGREGATE):
        assert names.count(span) == 2, span
