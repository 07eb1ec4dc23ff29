"""The port's Moshpit-KD (Alg. 2/3) and its traffic, against the JAX
package's.

The distillation rows the reference draws from its ``k_kd`` key are
handed to the port through ``Federation.step(draws=)``; the teacher
ranking is a sort of KL divergences, so it agrees as long as no two
candidates sit within the packages' f32 differences of each other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mkd as ref_mkd
from repro.core import transport as ref_transport
from repro.core.moshpit import GridPlan as RefGridPlan

from repro_torch.core import mkd, transport
from repro_torch.core.moshpit import GridPlan
from test_torch_federation import (one_torch_thread,  # noqa: F401
                                   _assert_trees_close, _pair,
                                   ref_step_inputs, run_pair)

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def test_kl_divergence_matches_reference():
    rng = np.random.default_rng(0)
    p = rng.dirichlet(np.ones(7), size=(5, 4)).astype(np.float32)
    q = rng.dirichlet(np.ones(7), size=(5, 4)).astype(np.float32)
    q[0, 0, 3] = 0.0                      # hits the eps clip
    np.testing.assert_allclose(
        mkd.kl_divergence(_t(p), _t(q)).numpy(),
        np.asarray(ref_mkd.kl_divergence(jnp.asarray(p), jnp.asarray(q))),
        atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("alpha", [0.0, 0.4, 1.0])
def test_student_loss_matches_reference(alpha):
    rng = np.random.default_rng(1)
    s = rng.normal(size=(3, 6, 5)).astype(np.float32)
    z = rng.normal(size=(3, 6, 5)).astype(np.float32)
    y = rng.integers(0, 5, size=(3, 6))
    got = mkd.student_loss(_t(s), _t(z), _t(y), 3.0, alpha)
    for i in range(3):
        want = ref_mkd.student_loss(jnp.asarray(s[i]), jnp.asarray(z[i]),
                                    jnp.asarray(y[i]), 3.0,
                                    jnp.asarray(alpha))
        assert float(got[i]) == pytest.approx(float(want), rel=1e-5,
                                              abs=1e-6)


def _cands(seed, m=5, b=8, c=10):
    rng = np.random.default_rng(seed)
    my = rng.normal(size=(b, c)).astype(np.float32)
    noise = rng.uniform(0.01, 5.0, size=m)
    cands = np.stack([my + s * rng.normal(size=(b, c))
                      for s in noise]).astype(np.float32)
    return my, cands


@pytest.mark.parametrize("mask,rho", [
    ([1, 1, 1, 1, 1], 0.4), ([1, 0, 1, 1, 0], 0.5),     # masked candidates
    ([0, 0, 0, 0, 0], 0.4),                             # no teacher
    ([0, 0, 1, 0, 0], 0.9), ([1, 1, 1, 1, 1], 1.0)])
def test_select_teachers_matches_reference(mask, rho):
    my, cands = _cands(len(mask) + int(10 * rho) + sum(mask))
    mask = np.asarray(mask, np.float32)
    want = ref_mkd.select_teachers(jnp.asarray(my), jnp.asarray(cands),
                                   jnp.asarray(mask), 3.0, rho)
    got = mkd.select_teachers(_t(my), _t(cands), _t(mask), 3.0, rho)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not mask.any():
        assert not got.any()


def test_select_teachers_tie_goes_to_lower_index():
    """Identical candidates tie exactly; both sorts are stable."""
    my, cands = _cands(3, m=4)
    cands[2] = cands[1]
    cands[3] = cands[1]
    mask = np.ones(4, np.float32)
    for rho in (0.25, 0.5):
        want = ref_mkd.select_teachers(jnp.asarray(my), jnp.asarray(cands),
                                       jnp.asarray(mask), 3.0, rho)
        got = mkd.select_teachers(_t(my), _t(cands), _t(mask), 3.0, rho)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_select_teachers_batched_over_peers():
    """One call over [N, M, ...] equals the reference per peer."""
    pairs = [_cands(s) for s in range(4)]
    masks = np.array([[1, 1, 0, 1, 1], [0, 0, 0, 0, 0], [1, 0, 0, 0, 1],
                      [1, 1, 1, 1, 1]], np.float32)
    got = mkd.select_teachers(_t(np.stack([p[0] for p in pairs])),
                              _t(np.stack([p[1] for p in pairs])),
                              _t(masks), 3.0, 0.4)
    for i, (my, c) in enumerate(pairs):
        want = ref_mkd.select_teachers(jnp.asarray(my), jnp.asarray(c),
                                       jnp.asarray(masks[i]), 3.0, 0.4)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


@pytest.mark.parametrize("n,dims", [(9, (3, 3)), (7, (2, 2, 2)),
                                    (16, (4, 4))])
def test_mkd_message_rounds_equal(n, dims):
    mask = (np.random.default_rng(n).random(n) < 0.7).astype(np.float32)
    for m in (None, mask):
        got = transport.mkd_message_rounds(GridPlan(n, dims), m, 808096,
                                           5120)
        want = ref_transport.mkd_message_rounds(RefGridPlan(n, dims), m,
                                                808096, 5120)
        assert [[(x.src, x.dst, x.nbytes) for x in r] for r in got] == \
            [[(x.src, x.dst, x.nbytes) for x in r] for r in want]


@pytest.mark.parametrize("kernel", [False, True])
def test_mkd_steps_match_reference(kernel):
    """``kd_iterations=2`` over 3 steps: two distilling steps, then the
    gate turns MKD off; the KD bytes are the reference's exactly."""
    ref_fed, ref_state, fed, state = _pair(
        "text", 9, kernel, use_kd=True, kd_iterations=2, local_batches=2,
        participation_rate=0.8, dropout_rate=0.1)
    kd_bytes = []
    for _ in range(3):
        ref_state, state = run_pair(ref_fed, ref_state, fed, state, 1)
        kd_bytes.append((fed.last_transcript.kd_bytes,
                         ref_fed.last_transcript.kd_bytes))
        assert state.kd_lambda == ref_state.kd_lambda
    assert [a for a, _ in kd_bytes] == [b for _, b in kd_bytes]
    assert kd_bytes[0][0] > 0 and kd_bytes[1][0] > 0 and kd_bytes[2][0] == 0
    assert fed.ledger.by_source == ref_fed.ledger.by_source
    assert fed.ledger.by_source["kd"] == sum(a for a, _ in kd_bytes)
    assert fed.comm_bytes == ref_fed.comm_bytes
    assert fed.sim_seconds == ref_fed.sim_seconds
    _assert_trees_close(state.params, ref_state.params)
    _assert_trees_close(state.momentum, ref_state.momentum)


def test_mkd_rounds_match_reference_with_virtual_slots():
    """N=7 on a 2x2x2 grid (one virtual slot) and a dropped peer: the
    MKD rounds alone, from the same params, agree with the reference."""
    ref_fed, ref_state, fed, state = _pair("text", 7, False, use_kd=True)
    a = np.array([1, 1, 0, 1, 1, 1, 1], np.float32)
    _, draws = ref_step_inputs(ref_fed, ref_state)
    _, it_rng = jax.random.split(ref_state.rng)
    k_kd = jax.random.split(it_rng, 3)[1]
    rp, rm = ref_mkd.mkd_rounds(ref_fed, ref_state.params,
                                ref_state.momentum, jnp.asarray(a), k_kd,
                                jnp.asarray(1.0, jnp.float32))
    p, m = mkd.mkd_rounds(fed, state.params, state.momentum,
                          torch.from_numpy(a),
                          torch.from_numpy(draws["kd_indices"]), 1.0)
    _assert_trees_close(p, rp)
    _assert_trees_close(m, rm)
