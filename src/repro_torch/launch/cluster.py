"""Multi-host bootstrap for real deployments.

Port of the JAX package's ``repro/launch/cluster.py``. The dry run
proves the mesh plans; this module is the glue an actual multi-host
launch uses: environment-based topology discovery, one
``torch.distributed.init_process_group`` per process (NCCL on CUDA,
gloo otherwise), and the guard rails for elastic restarts.

Supported environments (first match wins):
  * explicit env: REPRO_COORDINATOR, REPRO_NUM_PROCESSES,
    REPRO_PROCESS_ID
  * SLURM: SLURM_STEP_NODELIST / SLURM_NTASKS / SLURM_PROCID
  * torchrun: MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK (where the
    reference lets the TPU runtime detect its pod)

Usage in every process:

    from repro_torch.launch.cluster import initialize_cluster
    info = initialize_cluster()          # a no-op for one process
    mesh = make_production_mesh(multi_pod=info.num_processes > 256)
"""
from __future__ import annotations

import dataclasses
import os
import re
import socket
from datetime import timedelta
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ClusterInfo:
    coordinator: Optional[str]
    num_processes: int
    process_id: int
    initialized: bool

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def _first_host(nodelist: str) -> str:
    """SLURM nodelist -> first hostname ('node[003-008]' -> 'node003')."""
    m = re.match(r"([^\[,]+)(?:\[(\d+)[-,\d]*\])?", nodelist)
    if not m:
        return nodelist.split(",")[0]
    base, first = m.group(1), m.group(2)
    return f"{base}{first}" if first else base


def detect_topology() -> ClusterInfo:
    env = os.environ
    if "REPRO_NUM_PROCESSES" in env:
        return ClusterInfo(
            coordinator=env.get("REPRO_COORDINATOR",
                                f"{socket.gethostname()}:8476"),
            num_processes=int(env["REPRO_NUM_PROCESSES"]),
            process_id=int(env.get("REPRO_PROCESS_ID", "0")),
            initialized=False)
    if "SLURM_NTASKS" in env and int(env["SLURM_NTASKS"]) > 1:
        host = _first_host(env.get("SLURM_STEP_NODELIST",
                                   env.get("SLURM_NODELIST", "")))
        return ClusterInfo(
            coordinator=f"{host}:8476",
            num_processes=int(env["SLURM_NTASKS"]),
            process_id=int(env.get("SLURM_PROCID", "0")),
            initialized=False)
    if "WORLD_SIZE" in env and int(env["WORLD_SIZE"]) > 1:
        return ClusterInfo(
            coordinator=f"{env.get('MASTER_ADDR', 'localhost')}:"
                        f"{env.get('MASTER_PORT', '29500')}",
            num_processes=int(env["WORLD_SIZE"]),
            process_id=int(env.get("RANK", "0")),
            initialized=False)
    return ClusterInfo(coordinator=None, num_processes=1, process_id=0,
                       initialized=False)


def initialize_cluster(timeout_s: int = 300) -> ClusterInfo:
    """Multi-process init of the default process group; a no-op for one
    process or when the group already exists."""
    import torch
    import torch.distributed as dist

    info = detect_topology()
    if info.num_processes <= 1:
        return dataclasses.replace(info, initialized=False)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if torch.cuda.is_available() else "gloo",
            init_method=f"tcp://{info.coordinator}",
            world_size=info.num_processes, rank=info.process_id,
            timeout=timedelta(seconds=timeout_s))
    return dataclasses.replace(info, initialized=True)


def assert_mesh_feasible(num_hosts: int, chips_per_host: int,
                         mesh_shape) -> None:
    """Fail fast before building the step when the scheduler's
    allocation cannot realize the requested mesh."""
    import numpy as np
    need = int(np.prod(mesh_shape))
    have = num_hosts * chips_per_host
    if have < need:
        raise RuntimeError(
            f"mesh {tuple(mesh_shape)} needs {need} chips; allocation has "
            f"{num_hosts} hosts x {chips_per_host} = {have}")
