"""Divisibility-aware sharding rules for the production mesh.

Port of the JAX package's ``repro/runtime/sharding.py``.
``make_shard_plan`` maps a (mesh, n_peers) pair to a :class:`ShardPlan`;
``state_shardings`` walks any peer-stacked tree and assigns each leaf:

  dim 0              -> the peer axes (MAR replicas; "pod" on the
                        multi-pod mesh, "data" on the single-pod mesh)
  largest other dim  -> TP axis ("model"), if divisible
  next largest dim   -> FSDP axes (remaining DP axes inside a peer), if
                        divisible

Greedy-with-fallback: any dim that fails divisibility is replicated on
that axis instead, so no config fails to shard, it just shards less
(``report`` lists what each leaf got). MoE expert stacks [L, E, d, f]
get E->model + d->fsdp, dense stacks [L, d, ff] get ff->model +
d->fsdp, vocab embeddings [V, d] get V->model, SSM conv and gate vectors
stay replicated.

Batch arrays shard their leading (global-batch or peer) dim over *all*
DP axes.

A leaf's spec is the reference's PartitionSpec as a tuple: per tensor
dim a mesh axis name, a tuple of names, or ``None``. The rules need
only the mesh's axis names and sizes, so a :class:`MeshShape` plans a
mesh without a process group. :class:`NamedSharding` turns a spec into
``torch.distributed.tensor`` placements (``Shard(d)`` or
``Replicate()`` per mesh dim) on a ``DeviceMesh``; ``shard_tree`` lays a
tree out as DTensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.tree import Tree, tree_map

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes without devices or a process group
    (the reference's ``jax.sharding.AbstractMesh``)."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a :class:`MeshShape`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    mesh: Any                      # DeviceMesh or MeshShape
    peer_axes: Tuple[str, ...]     # mesh axes enumerating MAR peers
    fsdp_axes: Tuple[str, ...]     # within-peer param-shard axes
    tp_axes: Tuple[str, ...]       # tensor-parallel axes
    n_peers: int

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return self.peer_axes + self.fsdp_axes

    def axis_size(self, axes: Sequence[str]) -> int:
        sizes = mesh_sizes(self.mesh)
        return int(np.prod([sizes[a] for a in axes])) if axes else 1


def make_shard_plan(mesh, peer_axes: Optional[Sequence[str]] = None
                    ) -> ShardPlan:
    """Default plans for the two production meshes:

    * (data=16, model=16)           -> peers over "data" (16 peers, MAR
                                       grid 4x4), TP over "model", no FSDP
    * (pod=2, data=16, model=16)    -> peers over "pod" (2 peers), FSDP
                                       over "data", TP over "model":
                                       cross-pod traffic only in the MAR
                                       round over the pod axis
    """
    names = tuple(mesh.mesh_dim_names)
    sizes = mesh_sizes(mesh)
    if peer_axes is None:
        peer_axes = ("pod",) if "pod" in names else ("data",)
    peer_axes = tuple(peer_axes)
    tp_axes = ("model",) if ("model" in names
                             and "model" not in peer_axes) else ()
    fsdp_axes = tuple(a for a in names
                      if a not in peer_axes and a not in tp_axes)
    n_peers = int(np.prod([sizes[a] for a in peer_axes]))
    return ShardPlan(mesh, peer_axes, fsdp_axes, tp_axes, n_peers)


# ---------------------------------------------------------------------------
# leaf rules: name-aware Megatron-style TP with divisibility fallbacks
# ---------------------------------------------------------------------------

# column-parallel (shard the OUTPUT dim, -1): activations stay sharded,
# no collective until the paired row-parallel matmul
_COL_PARALLEL = {"wg", "wu", "up_proj", "w_in"}
# row-parallel (shard the INPUT dim, -2): consumes col-parallel output,
# emits one all-reduce
_ROW_PARALLEL = {"wd", "out_proj"}
# attention projections: shard only on whole-head boundaries
_ATTN_COL = {"wq"}          # out dim = num_heads * head_dim
_ATTN_KV = {"wk", "wv"}     # out dim = num_kv_heads * head_dim
_ATTN_ROW = {"wo"}          # in  dim = num_heads * head_dim
_NEVER_TP = {"router", "a_log", "dt_bias", "d_skip", "bias", "conv_w",
             "r_rec", "norm", "norm1", "norm2", "final_norm",
             "frontend_norm"}


def _axes_entry(axes: Sequence[str]):
    return tuple(axes) if len(axes) > 1 else axes[0]


def _leaf_spec(name: str, shape: Tuple[int, ...], plan: ShardPlan,
               peer_stacked: bool, head_dim: int = 0,
               num_heads: int = 0, num_kv_heads: int = 0) -> Spec:
    nd = len(shape)
    spec: List[Any] = [None] * nd
    start = 0
    if peer_stacked and nd >= 1 and shape[0] == plan.n_peers \
            and plan.n_peers > 1:
        spec[0] = _axes_entry(plan.peer_axes)
        start = 1

    tp = plan.axis_size(plan.tp_axes)
    tp_dim: Optional[int] = None

    if tp > 1 and nd - start >= 1 and name not in _NEVER_TP:
        cand: Optional[int] = None
        if name in _COL_PARALLEL or name in _ATTN_COL or name in _ATTN_KV:
            # column-parallel; for attention, whole-head alignment is
            # preferred but plain divisibility still shards
            cand = nd - 1
        elif (name in _ROW_PARALLEL or name in _ATTN_ROW) \
                and nd - start >= 2:
            cand = nd - 2
        elif name == "tok" and nd - start >= 2:
            cand = nd - 2                   # vocab-parallel embedding
        elif name == "unembed":
            cand = nd - 1                   # vocab-parallel logits
        else:  # fallback: largest dim, preferring later (output) dims
            cand = max(range(start, nd), key=lambda i: (shape[i], i)) \
                if nd > start else None
        # MoE expert stacks [*, E, d, ff]: prefer expert-parallel on E
        if name in ("wg", "wu", "wd") and nd - start >= 3 \
                and shape[nd - 3] % tp == 0:
            cand = nd - 3
        if cand is not None and cand >= start \
                and shape[cand] % tp == 0 and shape[cand] >= tp:
            spec[cand] = _axes_entry(plan.tp_axes)
            tp_dim = cand

    fsdp = plan.axis_size(plan.fsdp_axes)
    if fsdp > 1:
        order = sorted((i for i in range(start, nd) if i != tp_dim),
                       key=lambda i: -shape[i])
        for i in order:
            if shape[i] % fsdp == 0 and shape[i] >= fsdp:
                spec[i] = _axes_entry(plan.fsdp_axes)
                break
    return tuple(spec)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh; ``placements`` are its DTensor form."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return spec_placements(self.mesh, self.spec)


def spec_placements(mesh, spec: Spec) -> tuple:
    """``Shard(d)`` on every mesh dim that a tensor dim ``d`` of ``spec``
    names, ``Replicate()`` on the others. A dim sharded over several
    axes must name them in mesh order (DTensor splits a dim over its
    mesh dims major to minor, as the reference's spec does)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} is sharded over {axes}, out of the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def _named_leaves(tree: Tree, prefix: Tuple[str, ...] = ()):
    """(path, leaf) pairs in ``tree_leaves`` order; the path holds dict
    keys and tuple indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], prefix + (k,))
    elif isinstance(tree, tuple):
        for i, t in enumerate(tree):
            yield from _named_leaves(t, prefix + (i,))
    else:
        yield prefix, tree


def _leaf_name(path) -> str:
    """The last dict key on the path (tuple indices skipped)."""
    for p in reversed(path):
        if isinstance(p, str):
            return p
    return ""


def _map_with_path(fn, tree: Tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], prefix + (k,))
                for k in sorted(tree)}
    if isinstance(tree, tuple):
        return tuple(_map_with_path(fn, t, prefix + (i,))
                     for i, t in enumerate(tree))
    return fn(prefix, tree)


def state_shardings(tree: Tree, plan: ShardPlan,
                    peer_stacked: bool = True, head_dim: int = 0,
                    num_heads: int = 0, num_kv_heads: int = 0) -> Tree:
    """NamedShardings for a (possibly peer-stacked) state tree. Leaf
    names (last dict key on the path) select Megatron-style TP rules."""
    return _map_with_path(
        lambda path, x: NamedSharding(plan.mesh, _leaf_spec(
            _leaf_name(path), tuple(x.shape), plan, peer_stacked, head_dim,
            num_heads, num_kv_heads)), tree)


def batch_shardings(tree: Tree, plan: ShardPlan,
                    peer_leading: bool = True) -> Tree:
    """Token/batch arrays: leading dim(s) over DP axes.

    Peer-led train batches [P, B, n_micro, mb, ...]: dim0 -> peer axes,
    mb dim -> fsdp axes. Flat serve batches [b, ...]: dim0 -> all DP
    axes (fallback: fewer axes when b isn't divisible).
    """
    sizes = mesh_sizes(plan.mesh)

    def leaf(x):
        shape = tuple(x.shape)
        spec: List[Any] = [None] * len(shape)
        if peer_leading and shape[0] == plan.n_peers and plan.n_peers > 1:
            spec[0] = _axes_entry(plan.peer_axes)
            if plan.fsdp_axes:
                size = plan.axis_size(plan.fsdp_axes)
                # shard the microbatch dim (index -2 for [..., mb, seq])
                for i in range(len(shape) - 2, 0, -1):
                    if shape[i] % size == 0 and shape[i] >= size:
                        spec[i] = _axes_entry(plan.fsdp_axes)
                        break
        else:
            # flat batch: greedily shard dim0 over as many DP axes as divide
            axes: List[str] = []
            for a in plan.dp_axes:
                if shape[0] % int(np.prod(
                        [sizes[x] for x in axes + [a]])) == 0:
                    axes.append(a)
            if axes:
                spec[0] = _axes_entry(axes)
        return NamedSharding(plan.mesh, tuple(spec))
    return tree_map(leaf, tree)


def cache_shardings(cache: Tree, plan: ShardPlan, batch_size: int) -> Tree:
    """Decode-cache rules: the batch dim shards over DP axes; the largest
    remaining dim (the 32k seq axis of KV caches, the head or state dims
    of SSM caches) shards over TP: seq-over-model is the split-K
    flash-decode layout, whose softmax reductions are tiny collectives.
    """
    sizes = mesh_sizes(plan.mesh)

    def leaf(x):
        shape = tuple(x.shape)
        spec: List[Any] = [None] * len(shape)
        # locate the batch dim (first exact size match)
        bdim = None
        for i, s in enumerate(shape):
            if s == batch_size:
                bdim = i
                break
        if bdim is not None:
            axes: List[str] = []
            for a in plan.dp_axes:
                if batch_size % int(np.prod(
                        [sizes[x] for x in axes + [a]])) == 0:
                    axes.append(a)
            if axes:
                spec[bdim] = _axes_entry(axes)
        if plan.tp_axes:
            size = plan.axis_size(plan.tp_axes)
            order = sorted((i for i in range(len(shape)) if i != bdim),
                           key=lambda i: -shape[i])
            for i in order:
                if shape[i] % size == 0 and shape[i] >= size:
                    spec[i] = _axes_entry(plan.tp_axes)
                    break
        return NamedSharding(plan.mesh, tuple(spec))
    return tree_map(leaf, cache)


def local_shape(shape: Sequence[int], sharding: NamedSharding
                ) -> Tuple[int, ...]:
    """The shape of this rank's shard of a ``shape`` tensor."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    local, _ = compute_local_shape_and_global_offset(
        tuple(shape), sharding.mesh, list(sharding.placements))
    return tuple(local)


def shard_tree(tree: Tree, shardings: Tree) -> Tree:
    """Lay ``tree`` out as DTensors, each leaf on its sharding's mesh and
    placements. Every rank passes the same global values and keeps its
    own shard (no collective); a ``meta`` leaf gives a ``meta`` DTensor
    of the same global shape."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def leaf(x: torch.Tensor, sh: NamedSharding):
        placements = list(sh.placements)
        if x.device.type == "meta":
            loc = torch.empty(local_shape(x.shape, sh), dtype=x.dtype,
                              device="meta")
            return DTensor.from_local(loc, sh.mesh, placements,
                                      run_check=False, shape=x.shape,
                                      stride=x.stride())
        return distribute_tensor(x, sh.mesh, placements, src_data_rank=None)
    return tree_map(leaf, tree, shardings)


def report(tree: Tree, plan: ShardPlan, peer_stacked: bool = True,
           **head_kw) -> Dict[str, str]:
    """Human-readable leaf -> spec table."""
    out = {}
    for path, leaf in _named_leaves(tree):
        spec = _leaf_spec(_leaf_name(path), tuple(leaf.shape), plan,
                          peer_stacked, **head_kw)
        out["/".join(str(p) for p in path)] = \
            f"{tuple(leaf.shape)} -> {spec}"
    return out
