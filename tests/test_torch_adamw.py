"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's
over five steps, f32 and bf16 params (f32 moments), same inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import adamw_init as ref_init
from repro.optim.adamw import adamw_step as ref_step

from repro_torch.optim import adamw_init, adamw_step
from repro_torch.optim.adamw import AdamWState

SHAPES = {"w": (16, 8), "b": (8,), "blk": {"u": (3, 4, 5)}}


def _tree(fn, shapes):
    if isinstance(shapes, dict):
        return {k: _tree(fn, v) for k, v in shapes.items()}
    return fn(shapes)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_over_five_steps(dtype):
    rng = np.random.default_rng(0)
    p0 = _tree(lambda s: rng.standard_normal(s).astype(np.float32), SHAPES)
    ref_p = jax.tree.map(lambda x: jnp.asarray(x, jnp.dtype(dtype)), p0)
    tp = jax.tree.map(lambda x: torch.from_numpy(x).to(getattr(torch, dtype)),
                      p0)
    ref_s, st = ref_init(ref_p), adamw_init(tp)
    assert isinstance(st, AdamWState)
    assert all(m.dtype == torch.float32 for m in _leaves(st.mu))
    for step in range(5):
        g = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), p0)
        ref_p, ref_s = ref_step(
            ref_p, ref_s, jax.tree.map(lambda x: jnp.asarray(
                x, jnp.dtype(dtype)), g), lr=1e-2)
        tp, st = adamw_step(tp, st, jax.tree.map(
            lambda x: torch.from_numpy(x).to(getattr(torch, dtype)), g),
            lr=1e-2)
        assert int(st.count) == int(ref_s.count) == step + 1
        for a, b in zip(_leaves(tp), jax.tree.leaves(ref_p)):
            assert a.dtype == getattr(torch, dtype)
            np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6)
        for a, b in zip(_leaves(st.mu) + _leaves(st.nu),
                        jax.tree.leaves(ref_s.mu)
                        + jax.tree.leaves(ref_s.nu)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6)
