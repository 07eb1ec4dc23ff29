"""The port's sharding rules (``repro_torch.runtime.sharding``) against
the reference's, leaf by leaf, for all ten configs at full width on
five meshes: state (plain and peer-stacked), batch and decode-cache
specs must be equal to the reference's PartitionSpecs. The reference's
rules run in process on ``jax.sharding.AbstractMesh`` (no forced device
count); the port's on ``MeshShape``. Also the Megatron case of
``tests/test_distribution.py`` and the DTensor placements on a fake
process group."""
import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding as RefNamedSharding

from repro.configs.registry import get_config as ref_config
from repro.core.fl_device import fl_state_shape as ref_fl_state_shape
from repro.models.model import Model as RefModel
from repro.models.model import batch_specs as ref_batch_specs
from repro.models.model import input_specs as ref_input_specs
from repro.runtime import sharding as ref

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.fl_device import fl_state_shape
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.model import Model, batch_specs, input_specs
from repro_torch.runtime import sharding
from repro_torch.runtime.sharding import MeshShape
from repro_torch.tree import tree_leaves

MESHES = [((16, 16), ("data", "model"), None),
          ((2, 16, 16), ("pod", "data", "model"), None),
          ((2, 16, 16), ("pod", "data", "model"), ("pod",)),
          ((2, 4), ("data", "model"), None),
          ((4, 2), ("data", "model"), None)]
MESH_IDS = ["16x16", "2x16x16", "2x16x16-pod", "2x4", "4x2"]


def _specs(ref_tree, port_tree):
    """(reference specs as tuples, the port's) in leaf order."""
    return ([tuple(s.spec) for s in jax.tree.leaves(ref_tree)],
            [s.spec for s in tree_leaves(port_tree)])


@pytest.fixture(scope="module")
def shapes():
    """Each arch's full-width params, both packages, without allocating."""
    return {arch: (RefModel(ref_config(arch)).init_shape(),
                   Model(get_config(arch)).init_shape())
            for arch in ARCH_IDS}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_reference(arch, shapes):
    cfg, rcfg = get_config(arch), ref_config(arch)
    head_kw = dict(head_dim=cfg.head_dim, num_heads=cfg.num_heads,
                   num_kv_heads=cfg.num_kv_heads)
    ref_params, params = shapes[arch]
    n_leaves = len(tree_leaves(params))
    assert n_leaves == len(jax.tree.leaves(ref_params))
    cache_ref = ref_input_specs(rcfg, SHAPES["decode_32k"])["cache"]
    cache = input_specs(cfg, SHAPES["decode_32k"])["cache"]
    for shape, names, peer_axes in MESHES:
        rplan = ref.make_shard_plan(AbstractMesh(shape, names), peer_axes)
        plan = sharding.make_shard_plan(MeshShape(shape, names), peer_axes)
        assert (plan.peer_axes, plan.fsdp_axes, plan.tp_axes,
                plan.n_peers) == (rplan.peer_axes, rplan.fsdp_axes,
                                  rplan.tp_axes, rplan.n_peers)
        # parameters as served (no peer axis)
        want, got = _specs(
            ref.state_shardings(ref_params, rplan, peer_stacked=False,
                                **head_kw),
            sharding.state_shardings(params, plan, peer_stacked=False,
                                     **head_kw))
        assert got == want, (shape, names)
        # the peer-stacked FL state
        want, got = _specs(
            ref.state_shardings(ref_fl_state_shape(RefModel(rcfg),
                                                   rplan.n_peers),
                                rplan, **head_kw),
            sharding.state_shardings(fl_state_shape(Model(cfg),
                                                    plan.n_peers),
                                     plan, **head_kw))
        assert len(got) == 2 * n_leaves + 1 and got == want
        # peer-led train batches and flat serve batches
        for kind in ("train_4k", "prefill_32k"):
            kw = (dict(n_peers=plan.n_peers) if kind == "train_4k"
                  else {})
            lead = kind == "train_4k"
            want, got = _specs(
                ref.batch_shardings(ref_batch_specs(rcfg, SHAPES[kind],
                                                    **kw), rplan, lead),
                sharding.batch_shardings(batch_specs(cfg, SHAPES[kind],
                                                     **kw), plan, lead))
            assert got == want, (kind, shape)
        # the 32k decode cache
        want, got = _specs(ref.cache_shardings(cache_ref, rplan, 128),
                           sharding.cache_shardings(cache, plan, 128))
        assert got == want, shape
    rep = sharding.report(params, sharding.make_shard_plan(
        MeshShape((16, 16), ("data", "model"))), peer_stacked=False,
        **head_kw)
    assert len(rep) == n_leaves


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_input_specs_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for shape in SHAPES.values():
        kw = dict(n_peers=4, local_steps=2, n_micro=4) \
            if shape.kind == "train" else {}
        want = jax.tree.leaves(ref_input_specs(rcfg, shape, **kw))
        got = tree_leaves(input_specs(cfg, shape, **kw))
        assert [(tuple(x.shape), str(x.dtype)) for x in want] == \
            [(tuple(x.shape), str(x.dtype).removeprefix("torch."))
             for x in got], shape.name
        assert all(x.device.type == "meta" for x in got)
        if shape.kind in ("train", "prefill"):
            b = batch_specs(cfg, shape, **kw)
            assert sorted(b) == sorted(ref_batch_specs(rcfg, shape, **kw))


def test_sharding_rules_megatron_layout():
    """``tests/test_distribution.py``'s Megatron case, on a (2, 4) mesh."""
    plan = sharding.make_shard_plan(MeshShape((2, 4), ("data", "model")),
                                    ("data",))
    tree = {
        "wq": torch.zeros((2, 64, 128)),     # peer-stacked col-parallel
        "wo": torch.zeros((2, 128, 64)),     # row-parallel
        "wd": torch.zeros((2, 8, 16, 64)),   # MoE [P, E, ff, d]
        "norm1": torch.zeros((2, 64)),
        "tok": torch.zeros((2, 256, 64)),
    }
    sh = sharding.state_shardings(tree, plan, head_dim=32, num_heads=4,
                                  num_kv_heads=4)
    assert sh["wq"].spec == ("data", None, "model")
    assert sh["wo"].spec[:2] == ("data", "model")
    assert sh["wd"].spec[:2] == ("data", "model")       # EP on E=8%4==0
    assert sh["norm1"].spec == ("data", None)
    assert sh["tok"].spec[:2] == ("data", "model")      # vocab-parallel


def test_placements_and_local_shapes_on_a_fake_mesh():
    """Specs become ``Shard(d)`` / ``Replicate()`` per mesh dim, and each
    ``meta`` DTensor's local shape is the reference's shard shape."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    cfg = get_config("moonshot-v1-16b-a3b")
    head_kw = dict(head_dim=cfg.head_dim, num_heads=cfg.num_heads,
                   num_kv_heads=cfg.num_kv_heads)
    state = fl_state_shape(Model(cfg), 2)
    amesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    rplan = ref.make_shard_plan(amesh)
    rsh = ref.state_shardings(ref_fl_state_shape(RefModel(ref_config(
        "moonshot-v1-16b-a3b")), 2), rplan, **head_kw)
    with fake_world(8):
        mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"),
                              device_type="cpu")
        plan = sharding.make_shard_plan(mesh)
        sh = sharding.state_shardings(state, plan, **head_kw)
        dt = sharding.shard_tree(state, sh)
        for x, d, s, r in zip(tree_leaves(state), tree_leaves(dt),
                              tree_leaves(sh), jax.tree.leaves(rsh)):
            assert isinstance(d, DTensor) and d.shape == x.shape
            assert d.to_local().device.type == "meta"
            assert tuple(d.to_local().shape) == tuple(RefNamedSharding(
                amesh, r.spec).shard_shape(tuple(x.shape)))
            for i, name in enumerate(("pod", "data", "model")):
                dims = [k for k, e in enumerate(s.spec) if e == name or (
                    isinstance(e, tuple) and name in e)]
                want = Shard(dims[0]) if dims else Replicate()
                assert s.placements[i] == want
    with pytest.raises(ValueError, match="out of the mesh's order"):
        sharding.spec_placements(MeshShape((2, 2), ("data", "model")),
                                 (("model", "data"),))
