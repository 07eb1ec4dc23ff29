"""The port's federation, step for step against the JAX package's.

The reference draws theta^0 and the minibatch indices from ``jax.random``;
these tests inject the reference's theta^0 into the port and replay its
index chain (``split(state.rng)`` -> ``split(it_rng, 3)[0]`` ->
``split(k_local, N)`` -> ``split(key, local_batches)`` ->
``randint(bkey, (batch_size,), 0, P)``, federation.py:604/532/523/519/505)
so both packages see the same inputs. Parameters agree to 1e-5 (f32
matmuls sum in another order); the ledger is numpy and agrees exactly.
Also the guards: the port imports neither JAX nor the reference.
"""
import ast
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core.federation import Federation as RefFederation
from repro.core.federation import FederationConfig as RefConfig

from repro_torch import convert, quickstart
from repro_torch.core.federation import (Federation, FederationConfig,
                                         run_federation)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors on a CPU shared by several test workers: one torch
    thread each, restored after the module (the test files that import
    this fixture use it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ref_batch_indices(ref_fed, ref_state):
    """The reference's minibatch indices for its next step."""
    cfg = ref_fed.cfg
    _, it_rng = jax.random.split(ref_state.rng)
    k_local = jax.random.split(it_rng, 3)[0]
    keys = jax.random.split(k_local, cfg.n_peers)
    n_rows = ref_fed.data_x.shape[1]
    out = np.empty((cfg.n_peers, cfg.local_batches, cfg.batch_size),
                   np.int64)
    for i in range(cfg.n_peers):
        for j, bkey in enumerate(jax.random.split(keys[i],
                                                  cfg.local_batches)):
            out[i, j] = np.asarray(jax.random.randint(
                bkey, (cfg.batch_size,), 0, n_rows))
    return out


def ref_step_inputs(ref_fed, ref_state, n=None):
    """(batch_indices, draws) of the reference's next step, for the
    port's ``step(batch_indices=, draws=)``: the minibatch indices as
    above, the MKD rows (``split(k_kd)[0] -> randint``, mkd.py:90-92)
    and DP's unit normals (``fold_in(k_agg, stage index) -> split(.,
    n_leaves)`` normals and ``fold_in(., 12345)`` for the scalar;
    aggregation.py:553, dp.py:95-100 and :141). ``n`` is the fleet size
    after any resize the step makes."""
    cfg = ref_fed.cfg
    n = cfg.n_peers if n is None else n
    rows = ref_fed.data_x.shape[1]
    _, it_rng = jax.random.split(ref_state.rng)
    k_local, k_kd, k_agg = jax.random.split(it_rng, 3)
    per_peer = jax.vmap(lambda k: jax.vmap(
        lambda b: jax.random.randint(b, (cfg.batch_size,), 0, rows))(
            jax.random.split(k, cfg.local_batches)))
    batch = np.asarray(per_peer(jax.random.split(k_local, n)), np.int64)
    draws = {"kd_indices": np.asarray(jax.random.randint(
        jax.random.split(k_kd)[0],
        (n, cfg.local_batches * cfg.batch_size), 0, rows), np.int64)}
    names = ref_fed.pipeline.stage_names
    if "dp" in names:
        k_dp = jax.random.fold_in(k_agg, names.index("dp"))
        shapes = [(n,) + x.shape[1:]
                  for x in jax.tree.leaves(ref_state.params)]
        keys = jax.random.split(k_dp, len(shapes))
        draws["dp_noise"] = {
            "delta": [torch.from_numpy(np.array(
                jax.random.normal(k, s, jax.numpy.float32)))
                for k, s in zip(keys, shapes)],
            "b": torch.tensor(float(jax.random.normal(
                jax.random.fold_in(k_dp, 12345), ())))}
    return batch, draws


def run_pair(ref_fed, ref_state, fed, state, steps, sizes=None):
    """``steps`` steps of both federations on the reference's inputs;
    ``sizes[t]`` is the fleet size step ``t`` runs at (resizes)."""
    for t in range(steps):
        n = None if sizes is None else sizes[t]
        idx, draws = ref_step_inputs(ref_fed, ref_state, n)
        ref_state = ref_fed.step(ref_state)
        state = fed.step(state, batch_indices=idx, draws=draws)
    return ref_state, state


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_close(port, ref, atol=ATOL, rtol=0.0):
    ref = _np(ref)
    port = convert.params_to_numpy(port)
    assert jax.tree.structure(port) == jax.tree.structure(ref)
    for p, r in zip(jax.tree.leaves(port), jax.tree.leaves(ref)):
        np.testing.assert_allclose(p, r, atol=atol, rtol=rtol)


def assert_int8_close(port, ref):
    """Parity under int8 error feedback: every leaf within 1e-5 except
    where a rounding sat within the packages' f32 differences (~1e-7)
    of a half-quantum boundary and became a whole quantum. Such flips
    must be rare (<= 0.5% of a leaf) and no larger than two of the
    leaf's quanta (absmax / 127; MAR's group means halve one at most
    once per round, error feedback returns it the next step)."""
    for (path, p), r in zip(
            jax.tree_util.tree_leaves_with_path(
                convert.params_to_numpy(port)),
            jax.tree.leaves(_np(ref))):
        d = np.abs(p - r)
        assert (d > ATOL).mean() <= 5e-3, (path, (d > ATOL).mean())
        assert d.max() <= ATOL + 2 * np.abs(r).max() / 127, (path, d.max())


def _pair(task, n, kernel, **kw):
    base = dict(n_peers=n, technique="mar", task=task, seed=6)
    base.update(kw)
    ref_fed = RefFederation(RefConfig(pallas_group_mean=kernel, **base))
    fed = Federation(FederationConfig(kernel_group_mean=kernel, **base),
                     device="cpu")
    ref_state = ref_fed.init_state()
    theta0 = jax.tree.map(lambda x: np.asarray(x[0]), ref_state.params)
    state = fed.init_state(params=convert.params_from_numpy(theta0))
    return ref_fed, ref_state, fed, state


@pytest.fixture(scope="module")
def text_pair():
    return _pair("text", 8, False, local_batches=2,
                 participation_rate=0.8, dropout_rate=0.1)


def test_data_and_model_bytes_match(text_pair):
    ref_fed, _, fed, _ = text_pair
    np.testing.assert_array_equal(fed.data_x.numpy(),
                                  np.asarray(ref_fed.data_x))
    np.testing.assert_array_equal(fed.data_y.numpy(),
                                  np.asarray(ref_fed.data_y))
    assert fed.model_bytes == ref_fed.model_bytes == 808096
    assert fed.plan == fed.cfg.grid() and fed.plan.dims == ref_fed.plan.dims


def test_local_update_matches_reference(text_pair):
    ref_fed, ref_state, fed, state = text_pair
    rng = np.random.default_rng(11)
    mom = jax.tree.map(
        lambda x: (0.1 * rng.normal(size=x.shape)).astype(np.float32),
        _np(ref_state.params))
    _, it_rng = jax.random.split(ref_state.rng)
    k_local = jax.random.split(it_rng, 3)[0]
    ref_p, ref_m = ref_fed._local_update(
        ref_state.params, jax.tree.map(jax.numpy.asarray, mom), k_local)
    idx = torch.from_numpy(ref_batch_indices(ref_fed, ref_state))
    p, m = fed._local_update(state.params, convert.params_from_numpy(mom),
                             idx)
    _assert_trees_close(p, ref_p, atol=1e-5, rtol=1e-5)
    _assert_trees_close(m, ref_m, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kernel", [False, True])
def test_two_steps_match_reference(kernel):
    ref_fed, ref_state, fed, state = _pair(
        "text", 8, kernel, local_batches=2, participation_rate=0.8,
        dropout_rate=0.1)
    assert fed.pipeline.aggregator.use_kernel is kernel
    for _ in range(2):
        idx = ref_batch_indices(ref_fed, ref_state)
        ref_state = ref_fed.step(ref_state)
        state = fed.step(state, batch_indices=idx)
    assert state.iteration == ref_state.iteration == 2
    _assert_trees_close(state.params, ref_state.params)
    _assert_trees_close(state.momentum, ref_state.momentum)
    assert fed.comm_bytes == ref_fed.comm_bytes
    assert fed.ledger.by_source == ref_fed.ledger.by_source
    assert fed.sim_seconds == ref_fed.sim_seconds
    assert abs(fed.evaluate(state) - ref_fed.evaluate(ref_state)) <= 1 / 1024
    assert abs(fed.evaluate_mean_model(state)
               - ref_fed.evaluate_mean_model(ref_state)) <= 1 / 1024
    assert fed.peer_disagreement(state) == pytest.approx(
        ref_fed.peer_disagreement(ref_state), rel=1e-3, abs=1e-12)


def test_vision_step_matches_reference():
    ref_fed, ref_state, fed, state = _pair("vision", 4, False)
    idx = ref_batch_indices(ref_fed, ref_state)
    ref_state = ref_fed.step(ref_state)
    state = fed.step(state, batch_indices=idx)
    _assert_trees_close(state.params, ref_state.params)
    _assert_trees_close(state.momentum, ref_state.momentum)
    assert fed.comm_bytes == ref_fed.comm_bytes


def test_explicit_masks_and_lossy_links_match_reference():
    ref_fed, ref_state, fed, state = _pair(
        "text", 8, False, link_profile="wireless",
        link_params={"loss": 0.2})
    u = np.ones(8, np.float32)
    a = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)
    idx = ref_batch_indices(ref_fed, ref_state)
    ref_state = ref_fed.step(ref_state, masks=(u, a))
    state = fed.step(state, masks=(u, a), batch_indices=idx)
    np.testing.assert_array_equal(fed.last_transcript.lost_senders,
                                  ref_fed.last_transcript.lost_senders)
    assert fed.sim_seconds == ref_fed.sim_seconds
    _assert_trees_close(state.params, ref_state.params)


def test_free_running_steps_and_history():
    cfg = FederationConfig(n_peers=8, task="text", seed=1,
                           kernel_group_mean=True)
    fed = Federation(cfg, device="cpu")
    state = fed.init_state()
    first = fed._draw_batch_indices(fed.init_state())
    assert tuple(first.shape) == (8, 1, 16) and first.dtype == torch.int64
    for _ in range(3):
        state = fed.step(state)
    assert fed.peer_disagreement(state) < 1e-10
    hist = run_federation(cfg, iterations=3, eval_every=2, device="cpu")
    assert hist["iteration"] == [2, 3]
    assert hist["comm_bytes"][-1] == fed.comm_bytes
    assert hist["grid"][-1] == (2, 2, 2)


def test_batch_indices_are_checked():
    fed = Federation(FederationConfig(n_peers=4, task="text"), device="cpu")
    state = fed.init_state()
    with pytest.raises(ValueError, match="batch_indices must be"):
        fed.step(state, batch_indices=np.zeros((4, 2, 16), np.int64))
    bad = np.full((4, 1, 16), fed.data_x.shape[1], np.int64)
    with pytest.raises(ValueError, match="must lie in"):
        fed.step(state, batch_indices=bad)


def test_quickstart_runs_on_cpu(capsys):
    cfg = quickstart.quickstart_config()
    assert cfg.kernel_group_mean and cfg.n_peers == 27
    quickstart.main(["--device", "cpu", "--iterations", "1"])
    assert "MAR grid: (3, 3, 3)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Federation(FederationConfig(n_peers=4))


@pytest.mark.parametrize("field,value", [("transport", "socket")])
def test_unported_fields_raise(field, value):
    """Once refused (Queue 1 item 14), the socket transport now runs: one
    step over loopback TCP bills the sim's bytes and moves real ones."""
    fed = Federation(FederationConfig(n_peers=8, **{field: value}),
                     device="cpu")
    state = fed.step(fed.init_state())
    assert state.iteration == 1 and fed.network.name == "socket"
    assert fed.comm_bytes == fed.last_transcript.total_bytes > 0
    assert fed.last_transcript.payload_bytes == fed.comm_bytes


@pytest.mark.parametrize("field,value", [
    ("adaptive_m", "tail_aware"), ("placement", "clustered"),
    ("transport", "vector_sim"), ("transport", "super_sim"),
])
def test_large_n_fields_run(field, value):
    """The fields the large-N slice ported: two steps on the CPU over
    modeled wireless links give the reference's ledger and logs."""
    kw = {field: value, "link_profile": "wireless", "n_peers": 16}
    fed = Federation(FederationConfig(**kw), device="cpu")
    ref = RefFederation(RefConfig(**kw))
    state, ref_state = fed.init_state(), ref.init_state()
    for _ in range(2):
        state, ref_state = fed.step(state), ref.step(ref_state)
    assert state.iteration == 2
    assert dict(fed.ledger.by_source) == dict(ref.ledger.by_source)
    assert fed.sim_seconds == ref.sim_seconds
    assert fed.regroup_log == ref.regroup_log
    assert fed.placement_log == ref.placement_log


@pytest.mark.parametrize("field,value", [
    ("use_kd", True), ("use_dp", True), ("use_secagg", True),
    ("async_aggregation", True), ("compress", "int8_ef"),
    ("resize_schedule", ((2, 8),)),
])
def test_extension_fields_run(field, value):
    """The config fields the extensions slice ported: the config builds,
    one step runs on the CPU, and the pipeline's stages are the
    reference's."""
    cfg = FederationConfig(n_peers=8, **{field: value})
    fed = Federation(cfg, device="cpu")
    state = fed.step(fed.init_state())
    assert state.iteration == 1
    assert all(np.isfinite(x).all() for x in jax.tree.leaves(
        convert.params_to_numpy(state.params)))
    ref = RefFederation(RefConfig(n_peers=8, **{field: value}))
    assert fed.pipeline.stage_names == ref.pipeline.stage_names


def test_lifecycle_resize_follows_reference():
    """A lifecycle resize (4 -> 8 peers at iteration 1) goes through
    ``apply_membership``, and the ledger matches the reference's."""
    from repro.runtime.lifecycle import build_lifecycle as ref_lifecycle

    from repro_torch.runtime.lifecycle import build_lifecycle
    cfg = dict(n_peers=4)
    fed = Federation(FederationConfig(**cfg), device="cpu",
                     lifecycle=build_lifecycle(None, 4, schedule=((1, 8),)))
    ref = RefFederation(RefConfig(**cfg),
                        lifecycle=ref_lifecycle(None, 4, schedule=((1, 8),)))
    state, ref_state = fed.init_state(), ref.init_state()
    for _ in range(2):
        state, ref_state = fed.step(state), ref.step(ref_state)
    assert fed.cfg.n_peers == ref.cfg.n_peers == 8
    assert fed.plan.dims == ref.plan.dims
    assert all(x.shape[0] == 8 for x in jax.tree.leaves(
        convert.params_to_numpy(state.params)))
    assert fed.comm_bytes == ref.comm_bytes
    assert fed.sim_seconds == ref.sim_seconds


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_port_imports_with_jax_and_repro_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import repro_torch.core.federation as f\n"
        "fed = f.Federation(f.FederationConfig(n_peers=4), device='cpu')\n"
        "fed.step(fed.init_state())\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("rates", [(0.7, 0.2), (0.05, 0.0), (0.5, 0.99)])
def test_sample_masks_match_reference(rates):
    """The legacy mask API draws the reference's masks from one numpy
    generator, including the at-least-one-peer fallbacks."""
    kw = dict(n_peers=8, participation_rate=rates[0],
              dropout_rate=rates[1])
    fed = Federation(FederationConfig(**kw), device="cpu")
    ref = RefFederation(RefConfig(**kw))
    rng, ref_rng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(20):
        got, want = fed.sample_masks(rng), ref.sample_masks(ref_rng)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
