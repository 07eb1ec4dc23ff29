"""Multi-pod dry run: run every (arch x shape x mesh) cell's step on
``meta`` tensors as one rank of a fake process group.

Port of the JAX package's ``repro/launch/dryrun.py``. The reference
lowers and compiles each cell for 512 forced host devices; this port
starts a fake process group (``torch.testing``'s ``FakeStore``) of 256
or 512 ranks, builds the production ``DeviceMesh`` on it, lays the
(state, batch) stand-ins out as ``meta`` DTensors by the sharding rules
(``runtime/sharding.py``), and runs rank 0's step under
``runtime/op_analysis.py``: the ops compute shapes only, and the
collectives of the fake group move nothing. Success means the sharding
rules, the MAR collective schedule and the step agree on every shape;
the counts feed the roofline terms (``runtime/roofline.py``).

On a mesh a rank gathers the leaves of a peer's parameters that the
rules shard over TP and FSDP when the step uses them (as the sharded
train step does on the card), so its FLOPs are the whole peer's and its
collectives include those gathers. A serving cell gathers the
parameters and keeps its shard of the batch and of the cache's batch
dim. Argument bytes are exactly the rank's shards of the inputs; the
peak is an estimate: the arguments plus the most bytes that the step's
own allocations hold at once (the plain attention materializes its
scores, which the flash kernel does not).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod --out results.json
  python -m repro_torch.launch.dryrun --all --mesh both --out results.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.configs.registry import ARCH_IDS, get_config, get_shape
from repro_torch.core.fl_device import (fl_state_shape, make_fl_train_step,
                                        make_prefill_step, make_serve_step)
from repro_torch.launch.mesh import make_production_mesh, production_plans
from repro_torch.models.model import Model, batch_specs, input_specs
from repro_torch.runtime import roofline
from repro_torch.runtime.op_analysis import OpAnalysis
from repro_torch.runtime.sharding import (batch_shardings, cache_shardings,
                                          local_shape, make_shard_plan,
                                          shard_tree, state_shardings)
from repro_torch.tree import tree_leaves, tree_map


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake default process group of ``world_size`` ranks, this process
    rank 0, destroyed on exit; collectives on it move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _arg_bytes(tree, shardings) -> int:
    """Bytes of this rank's shards of ``tree``'s leaves."""
    return sum(int(np.prod(local_shape(x.shape, sh))) * x.element_size()
               for x, sh in zip(tree_leaves(tree), tree_leaves(shardings)))


def _gather(x, keep_dim: Optional[int] = None) -> torch.Tensor:
    """DTensor ``x`` replicated on every mesh dim except one that shards
    ``keep_dim``; this rank's local tensor."""
    from torch.distributed.tensor import Replicate, Shard

    placements = [pl if isinstance(pl, Shard) and pl.dim == keep_dim
                  else Replicate() for pl in x.placements]
    return x.redistribute(placements=placements).to_local()


def _batch_dim(x: torch.Tensor, batch_size: int) -> Optional[int]:
    """The first dim of size ``batch_size`` (``cache_shardings``'s)."""
    for i, s in enumerate(x.shape):
        if s == batch_size:
            return i
    return None


def dryrun_cell(arch_id: str, shape_id: str, multi_pod: bool,
                peer_axes: Optional[tuple] = None, one_shot: bool = False,
                local_steps: int = 1, n_micro: Optional[int] = None,
                momentum_dtype: str = "float32",
                comm_dtype: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None,
                verbose: bool = True, mesh=None) -> Dict[str, Any]:
    """Run one cell's step on ``meta`` as rank 0; returns the roofline
    record.

    ``overrides`` patches ModelConfig fields (e.g. attn_impl="xla") for
    before/after comparisons. ``mesh`` plans on a given ``DeviceMesh``
    (with the production axis names) in place of the production mesh;
    without one the cell starts and ends its own fake process group.
    """
    cfg = get_config(arch_id)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = get_shape(shape_id)
    if not shape_applicable(cfg, shape):
        return {"arch": arch_id, "shape": shape_id, "status": "skipped",
                "reason": "long_500k needs sub-quadratic attention"}
    if mesh is None:
        n = 512 if multi_pod else 256
        with fake_world(n):
            return dryrun_cell(arch_id, shape_id, multi_pod, peer_axes,
                               one_shot, local_steps, n_micro,
                               momentum_dtype, comm_dtype, overrides,
                               verbose, make_production_mesh(
                                   multi_pod=multi_pod, device_type="cpu"))

    splan, grid = production_plans(mesh, peer_axes)
    model = Model(cfg)
    mesh_name = "multi-pod-" if multi_pod else "single-pod-"
    mesh_name += "x".join(str(s) for s in tuple(mesh.shape))
    chips = mesh.size()
    t0 = time.time()
    head_kw = dict(head_dim=cfg.head_dim, num_heads=cfg.num_heads,
                   num_kv_heads=cfg.num_kv_heads)

    if shape.kind == "train":
        n_micro = n_micro or default_n_micro(cfg, shape, splan)
        state_shape = fl_state_shape(model, splan.n_peers,
                                     getattr(torch, momentum_dtype))
        batch = batch_specs(cfg, shape, splan.n_peers, local_steps, n_micro)
        step = make_fl_train_step(model, grid, one_shot=one_shot,
                                  comm_dtype=comm_dtype)
        st_sh = state_shardings(state_shape, splan, **head_kw)
        args = _arg_bytes(state_shape, st_sh) \
            + _arg_bytes(batch, batch_shardings(batch, splan))
        pm = {k: state_shape[k] for k in ("params", "momentum")}
        state = shard_tree(pm, {k: st_sh[k] for k in pm})
        state["step"] = state_shape["step"]

        def run():
            step(state, batch)
    elif shape.kind == "prefill":
        params_shape = model.init_shape()
        batch = batch_specs(cfg, shape)
        step = make_prefill_step(model)
        serve_plan = _serve_plan(splan)
        p_sh = state_shardings(params_shape, serve_plan, peer_stacked=False,
                               **head_kw)
        b_sh = batch_shardings(batch, serve_plan, peer_leading=False)
        args = _arg_bytes(params_shape, p_sh) + _arg_bytes(batch, b_sh)
        params = shard_tree(params_shape, p_sh)
        dbatch = shard_tree(batch, b_sh)

        def run():
            step(tree_map(_gather, params),
                 tree_map(lambda x: _gather(x, 0), dbatch))
    else:  # decode / long_decode
        params_shape = model.init_shape()
        specs = input_specs(cfg, shape)
        step = make_serve_step(model)
        serve_plan = _serve_plan(splan)
        p_sh = state_shardings(params_shape, serve_plan, peer_stacked=False,
                               **head_kw)
        c_sh = cache_shardings(specs["cache"], serve_plan,
                               shape.global_batch)
        t_sh = batch_shardings({"t": specs["token"]}, serve_plan,
                               peer_leading=False)
        args = _arg_bytes(params_shape, p_sh) \
            + _arg_bytes(specs["cache"], c_sh) \
            + _arg_bytes({"t": specs["token"]}, t_sh)
        params = shard_tree(params_shape, p_sh)
        cache = shard_tree(specs["cache"], c_sh)
        token = shard_tree({"t": specs["token"]}, t_sh)["t"]
        b = shape.global_batch

        def run():
            step(tree_map(_gather, params),
                 tree_map(lambda x: _gather(x, _batch_dim(x, b)), cache),
                 _gather(token, 0))

    with OpAnalysis(track_memory=True) as analysis:
        run()
    report = roofline.analyze(
        analysis.analyze(), roofline.memory_dict(args, analysis.peak_bytes),
        arch=arch_id, shape=shape_id, mesh=mesh_name, chips=chips,
        model_flops=roofline.model_flops_estimate(cfg, shape, shape.kind))
    rec = report.to_dict()
    rec.update(status="ok", compile_s=round(time.time() - t0, 1),
               n_peers=splan.n_peers, grid_dims=list(grid.dims),
               local_steps=local_steps, one_shot=one_shot,
               overrides=overrides or {},
               peer_axes=list(splan.peer_axes))
    if verbose:
        ma = rec["memory_per_chip"]
        print(f"[{arch_id} x {shape_id} x {mesh_name}] OK "
              f"({rec['compile_s']}s)\n"
              f"  per-chip: {ma.get('total_bytes', 0)/2**30:.2f} GiB "
              f"({ma.get('hbm_fraction', 0)*100:.0f}% of H100 HBM) | "
              f"flops/chip {rec['hlo_flops_per_chip']:.3e} | "
              f"coll/chip {rec['collective_bytes_per_chip']/2**20:.1f} MiB\n"
              f"  terms (s): compute {rec['compute_s']:.4f} "
              f"memory {rec['memory_s']:.4f} "
              f"collective {rec['collective_s']:.4f} "
              f"-> {rec['dominant']}-bound | MFU {rec['mfu']*100:.1f}%")
    return rec


def _serve_plan(splan):
    """Serving has no peers: all DP axes become FSDP."""
    return make_shard_plan(splan.mesh, peer_axes=())


def default_n_micro(cfg, shape, splan) -> int:
    """Pick microbatch count so per-chip live activations stay ~<2 GiB
    under remat (stored boundary = mb*seq*d_model bf16 per layer)."""
    per_peer = shape.global_batch // splan.n_peers
    fsdp = splan.axis_size(splan.fsdp_axes)
    budget = 2 * 2 ** 30
    layers = cfg.num_layers
    for n_micro in (1, 2, 4, 8, 16, 32):
        mb = per_peer // n_micro
        if mb < max(fsdp, 1):
            break
        live = layers * mb * shape.seq_len * cfg.d_model * 2 // max(fsdp, 1)
        if live <= budget:
            return n_micro
    return max(per_peer // max(fsdp, 1), 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default=None, choices=["single", "multi",
                                                     "both"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--one-shot", action="store_true",
                    help="fuse MAR rounds into one all-reduce (perf variant)")
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--peer-axes", default=None,
                    help="comma list, e.g. 'pod' for 2 big peers")
    ap.add_argument("--momentum-dtype", default="float32")
    ap.add_argument("--out", default=None, help="write JSON records here")
    args = ap.parse_args(argv)

    if args.mesh == "both":
        meshes = [False, True]
    elif args.mesh:
        meshes = [args.mesh == "multi"]
    else:
        meshes = [args.multi_pod]
    peer_axes = tuple(args.peer_axes.split(",")) if args.peer_axes else None

    if args.all:
        cells = [(arch, shape_id) for arch in ARCH_IDS for shape_id in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all)")
        cells = [(args.arch, args.shape)]

    records, failures = [], 0
    for multi_pod in meshes:
        for arch, shape_id in cells:
            try:
                rec = dryrun_cell(arch, shape_id, multi_pod,
                                  peer_axes=peer_axes,
                                  one_shot=args.one_shot,
                                  local_steps=args.local_steps,
                                  n_micro=args.n_micro,
                                  momentum_dtype=args.momentum_dtype)
            except Exception as e:  # a failing cell is a bug in the system
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape_id,
                       "mesh": "multi" if multi_pod else "single",
                       "status": "FAILED", "error": f"{type(e).__name__}: {e}"}
                failures += 1
            records.append(rec)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {len(records)} records -> {args.out}")
    ok = sum(1 for r in records if r.get("status") == "ok")
    sk = sum(1 for r in records if r.get("status") == "skipped")
    print(f"dry-run: {ok} ok, {sk} skipped, {failures} FAILED")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
