"""The port's Checkpointer against the JAX package's, on one directory.

Either package writes, the other restores: the arrays must come back bit
for bit (f32, bf16 as its uint16 bits, float8 as uint8 bits, and a tree
holding tuples), and the manifests must agree field for field. The
elastic paths (``restore(like=)`` at another peer count and
``restore_elastic``) are held to the reference's results: survivors and
cyclic copies bit for bit, mean-bootstrapped joiners within 1e-6 (the
f32 mean summed in another order).
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer

from repro_torch import convert
from repro_torch.checkpoint import Checkpointer, treedef_str
from repro_torch.tree import tree_leaves, tree_map


def _np_tree(kind: str, n: int = 3, seed: int = 0):
    """An FL-style state with a peer axis of ``n`` (numpy)."""
    rng = np.random.default_rng(seed)

    def arr(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return x.astype(ml_dtypes.bfloat16) if kind == "bf16" else x

    tree = {"params": {"w": arr(n, 4, 5), "b": arr(n, 5)},
            "momentum": {"w": arr(n, 4, 5), "b": arr(n, 5)},
            "count": np.arange(n, dtype=np.int32)}
    if kind == "tuple":
        tree["carry"] = (arr(n, 2), (arr(n, 3), np.float32(0.5)))
    return tree


def _torch_tree(np_tree):
    return tree_map(lambda x: convert._leaf_from_numpy(x, "cpu"), np_tree)


def _bits(x) -> np.ndarray:
    """A leaf of either package as comparable bits."""
    if isinstance(x, torch.Tensor):
        return convert._leaf_to_numpy(x)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_bit_equal(got, want):
    g = tree_leaves(got) if not isinstance(got, np.ndarray) else [got]
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = _bits(a), _bits(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


KINDS = ["f32", "bf16", "tuple"]


@pytest.mark.parametrize("with_like", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_reference_checkpoint_restores_bit_for_bit_in_the_port(
        tmp_path, kind, with_like):
    tree = _np_tree(kind)
    RefCheckpointer(str(tmp_path)).save(
        5, jax.tree.map(jnp.asarray, tree), metadata={"n_peers": 3})
    like = _torch_tree(tree) if with_like else None
    got, meta = Checkpointer(str(tmp_path)).restore(like=like,
                                                    device="cpu")
    assert meta == {"n_peers": 3}
    if with_like:
        assert isinstance(got.get("carry", ()), tuple)
        _assert_bit_equal(got, tree)
    else:
        want, _ = RefCheckpointer(str(tmp_path)).restore()
        assert jax.tree.structure(jax.tree.map(np.asarray, want)) == \
            jax.tree.structure(convert.params_to_numpy(got))
        _assert_bit_equal(got, want)


@pytest.mark.parametrize("with_like", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_port_checkpoint_restores_bit_for_bit_in_the_reference(
        tmp_path, kind, with_like):
    tree = _np_tree(kind)
    Checkpointer(str(tmp_path)).save(5, _torch_tree(tree),
                                     metadata={"n_peers": 3})
    like = jax.tree.map(jnp.asarray, tree) if with_like else None
    got, meta = RefCheckpointer(str(tmp_path)).restore(like=like)
    assert meta == {"n_peers": 3}
    if with_like:
        _assert_bit_equal(convert.params_from_numpy(
            jax.tree.map(np.asarray, got)), tree)
    else:
        want, _ = Checkpointer(str(tmp_path)).restore(device="cpu")
        _assert_bit_equal(want, got)


@pytest.mark.parametrize("kind", KINDS)
def test_manifests_are_the_references(tmp_path, kind):
    tree = _np_tree(kind)
    meta = {"n_peers": 3, "iteration": 7, "grid": [3, 1]}
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    RefCheckpointer(str(ref_dir)).save(12, jax.tree.map(jnp.asarray, tree),
                                       metadata=meta)
    Checkpointer(str(port_dir)).save(12, _torch_tree(tree), metadata=meta)
    name = os.path.join("step_0000000012", "manifest.json")
    with open(ref_dir / name) as f:
        want = json.load(f)
    with open(port_dir / name) as f:
        got = json.load(f)
    assert got == want
    assert got["treedef"] == str(jax.tree.structure(tree))
    with np.load(ref_dir / "step_0000000012" / "arrays.npz") as a, \
            np.load(port_dir / "step_0000000012" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_treedef_string_matches_jax_on_odd_trees():
    for tree in [{"a": (1,), "b": {}}, (1, 2), {"z": [1, (2, 3)], "a": ()},
                 np.zeros(2)]:
        assert treedef_str(tree) == str(jax.tree.structure(tree))


def test_float8_leaves_cross_as_their_bits(tmp_path):
    x = torch.randn(4, 8)
    tree = {"e4": x.to(torch.float8_e4m3fn), "e5": x.to(torch.float8_e5m2)}
    Checkpointer(str(tmp_path)).save(1, tree)
    got, _ = Checkpointer(str(tmp_path)).restore(device="cpu")
    ref, _ = RefCheckpointer(str(tmp_path)).restore()
    for k in tree:
        assert got[k].dtype == tree[k].dtype
        assert torch.equal(got[k].view(torch.uint8),
                           tree[k].view(torch.uint8))
        assert np.asarray(ref[k]).dtype.name == str(tree[k].dtype)[6:]
        np.testing.assert_array_equal(np.asarray(ref[k]).view(np.uint8),
                                      tree[k].view(torch.uint8).numpy())


def test_keep_last_k_atomic_async_and_poll(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = _torch_tree(_np_tree("f32"))
    assert ck.latest_step() is None and ck.poll() is None
    for step in (1, 2, 3):
        ck.save(step, tree)
    assert ck.steps() == [2, 3]
    ck.save(4, tree, blocking=False)
    ck.wait()
    assert ck.steps() == [3, 4] and ck.latest_step() == 4
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp-")]
    assert ck.poll(None) == 4 and ck.poll(3) == 4 and ck.poll(4) is None
    # an async save's host copy is taken at once: later writes to the
    # tensors do not reach the checkpoint
    before = tree["params"]["w"].clone()
    ck.save(5, tree, blocking=False)
    tree["params"]["w"].add_(1.0)
    got, _ = ck.restore(5, device="cpu")
    assert torch.equal(got["params"]["w"], before)
    # the reference reads the same directory
    assert RefCheckpointer(str(tmp_path)).steps() == ck.steps()


@pytest.mark.parametrize("new_n", [2, 5])
def test_restore_like_at_another_peer_count(tmp_path, new_n):
    tree = _np_tree("f32")
    Checkpointer(str(tmp_path)).save(3, _torch_tree(tree),
                                     metadata={"n_peers": 3})
    like_np = _np_tree("f32", n=new_n, seed=9)
    got, _ = Checkpointer(str(tmp_path)).restore(like=_torch_tree(like_np))
    want, _ = RefCheckpointer(str(tmp_path)).restore(
        like=jax.tree.map(jnp.asarray, like_np))
    for a, b, saved in zip(tree_leaves(got), jax.tree.leaves(want),
                           jax.tree.leaves(tree)):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape and a.shape[0] == new_n
        keep = min(3, new_n)
        np.testing.assert_array_equal(a[:keep].numpy(), saved[:keep])
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("new_n", [2, 7])
def test_restore_elastic_matches_the_reference(tmp_path, new_n):
    tree = _np_tree("tuple")
    tree["extra"] = np.ones((3, 2), np.float32)      # not in ``like``
    RefCheckpointer(str(tmp_path)).save(
        4, jax.tree.map(jnp.asarray, tree), metadata={"n_peers": 3})
    ck, ref = Checkpointer(str(tmp_path)), RefCheckpointer(str(tmp_path))
    got, meta = ck.restore_elastic(new_n, device="cpu")
    want, ref_meta = ref.restore_elastic(new_n)
    assert meta == ref_meta == {"n_peers": new_n}
    _assert_bit_equal(got, want)
    # with like: matched by path; a path the checkpoint lacks keeps the
    # template's value
    like_np = _np_tree("tuple", n=new_n, seed=2)
    like_np["fresh"] = np.full((new_n,), 3.0, np.float32)
    got, _ = ck.restore_elastic(new_n, like=_torch_tree(like_np))
    want, _ = ref.restore_elastic(new_n,
                                  like=jax.tree.map(jnp.asarray, like_np))
    assert "extra" not in got and isinstance(got["carry"], tuple)
    _assert_bit_equal(got, want)
    assert torch.equal(got["fresh"], torch.full((new_n,), 3.0))


def test_restore_without_like_runs_on_cuda_by_default(tmp_path, monkeypatch):
    Checkpointer(str(tmp_path)).save(1, {"w": torch.ones(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Checkpointer(str(tmp_path)).restore()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Checkpointer(str(tmp_path)).restore_elastic(2)
    got, _ = Checkpointer(str(tmp_path)).restore(device="cpu")
    assert got["w"].device == torch.device("cpu")
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(device="cpu")
