"""Production mesh construction: functions only, so importing this
module never touches the process group.

Port of the JAX package's ``repro/launch/mesh.py``: a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group (one rank a card).

Meshes:
  single-pod: (data=16, model=16)            — 256 ranks
  multi-pod : (pod=2, data=16, model=16)     — 512 ranks

MAR peer mapping:
  single-pod: peers = "data" axis -> 16 peers on a 4x4 MAR grid
  multi-pod : peers = ("pod", "data") -> 32 peers on a (2,4,4) grid with
              the pod axis as the *outermost* MAR round, so traffic
              between pods happens in exactly one of the three rounds.
  big-model fallback (``peer_axes=("pod",)``): 2 peers, FSDP over "data",
  for a per-peer state larger than 16 TP ranks' memory (kimi-k2 1T).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from repro_torch.core.moshpit import GridPlan, mesh_grid_plan
from repro_torch.runtime.sharding import ShardPlan, make_shard_plan


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    n = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} devices, have {have} — the dry-run entry point "
            f"must start a process group of {n} ranks first")
    if have > n:
        raise RuntimeError(f"mesh {shape} needs a world of {n} ranks, "
                           f"the process group has {have}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) or (2, 16, 16) production mesh over the default
    process group, on CUDA unless ``device_type`` names another."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_test_mesh(shape: Tuple[int, ...] = (2, 2),
                   axes: Tuple[str, ...] = ("data", "model"),
                   device_type: str = "cuda"):
    """Reduced mesh for tests (a world of prod(shape) ranks)."""
    return _mesh(tuple(shape), tuple(axes), device_type)


def production_plans(mesh, peer_axes: Optional[Sequence[str]] = None
                     ) -> Tuple[ShardPlan, GridPlan]:
    """(ShardPlan, MAR GridPlan) for a production mesh."""
    names = tuple(mesh.mesh_dim_names)
    if peer_axes is None:
        peer_axes = ("pod", "data") if "pod" in names else ("data",)
    splan = make_shard_plan(mesh, peer_axes)
    sizes = dict(zip(names, tuple(mesh.shape)))
    grid = mesh_grid_plan([sizes[a] for a in splan.peer_axes])
    return splan, grid
