"""The constants ``chip_smoke.py`` holds its large-N and recurrent
training phases to, reached by the port on the CPU.

* Each ``federation_large_n`` run (``chipsmoke.refs.LARGE_N_RUNS``: the text
  model at N = 125 under tail-aware adaptive group sizing on each
  transport, clustered placement at N = 64; 20 iterations, the
  group-mean kernel's route) ends with the reference's ledger by source
  and ``comm_bytes`` exactly, ``sim_seconds`` within 1e-9, the
  reference's ``regroup_log`` and ``placement_log``
  (``chipsmoke.refs.LARGE_N_REF``, from ``tools/reference_constants.py``),
  one group-mean round a step per round of the grid in force, and its
  accuracy at 20 inside the reference's seed band (torch's draws run
  free of jax's).
* The full-width zamba2-2.7b and xlstm-350m trainer runs
  (``chipsmoke.refs.TRAIN_RECURRENT``): the port's FL state on the meta
  device has the stated parameters a peer, and its ledger after 6
  steps of 4 peers is the constant, which is the reference's from
  ``jax.eval_shape``.
"""
from pathlib import Path

import pytest

from repro.configs.registry import get_config as ref_config
from repro.core import fl_device as ref_fl
from repro.core import topology as ref_topology
from repro.models.model import Model as RefModel

from repro_torch.configs import get_config
from repro_torch.core import fl_device, mar_allreduce, topology
from repro_torch.core.aggregation import CommLedger, build_pipeline
from repro_torch.core.federation import Federation, FederationConfig
from repro_torch.core.moshpit import plan_grid
from repro_torch.models.model import Model
from repro_torch.tree import tree_leaves
from test_torch_federation import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def refs(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    from chipsmoke import refs
    return refs


@pytest.mark.parametrize("run", ["adaptive_sim", "adaptive_vector_sim",
                                 "adaptive_super_sim",
                                 "placement_vector_sim"])
def test_large_n_run_reaches_the_references_ledger(refs, monkeypatch,
                                                   run):
    ref = refs.LARGE_N_REF[run]
    cfg = FederationConfig(kernel_group_mean=True,
                           **refs.LARGE_N_RUNS[run])
    fed = Federation(cfg, device="cpu")
    rounds = []
    real = mar_allreduce._kernel_round

    def counting(*args, **kw):
        rounds[-1] += 1
        return real(*args, **kw)

    monkeypatch.setattr(mar_allreduce, "_kernel_round", counting)
    state, depths = fed.init_state(), []
    for _ in range(20):
        depths.append(fed.plan.depth)
        rounds.append(0)
        state = fed.step(state)
    assert rounds == depths
    assert dict(fed.ledger.by_source) == ref["by_source"]
    assert fed.comm_bytes == ref["comm_bytes"]
    assert fed.sim_seconds == pytest.approx(ref["sim_seconds"], abs=1e-9)
    assert [[t, list(a), list(b)] for t, a, b in fed.regroup_log] == \
        ref["regroup_log"]
    assert [list(x) for x in fed.placement_log] == ref["placement_log"]
    lo, hi = ref["band"]
    assert lo <= fed.evaluate(state) <= hi


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-350m"])
def test_recurrent_training_ledger_is_the_constant(refs, arch):
    want = refs.TRAIN_RECURRENT[arch]
    n, steps = 4, 6
    shape = fl_device.fl_state_shape(Model(get_config(arch)), n)
    assert sum(x[0].numel() for x in tree_leaves(shape["params"])) == \
        want["params"]
    peer_bytes = (topology.pytree_bytes(shape["params"])
                  + topology.pytree_bytes(shape["momentum"])) // n
    rshape = ref_fl.fl_state_shape(RefModel(ref_config(arch)), n)
    assert peer_bytes == (ref_topology.pytree_bytes(rshape["params"])
                          + ref_topology.pytree_bytes(rshape["momentum"])
                          ) // n
    pipeline = build_pipeline("mar", plan_grid(n), backend="device")
    ledger = CommLedger()
    for _ in range(steps):
        pipeline.record_iteration(ledger, n, peer_bytes)
    assert ledger.total_bytes == want["comm_bytes"]
    assert all(x.device.type == "meta" for x in tree_leaves(shape))
