"""The multi-rank device backend on an 8-process gloo world (CPU).

One spawn per module (a module-scoped fixture runs this file as a
script in a subprocess with its own timeout; the script spawns 8 ranks
that meet through a ``FileStore`` under ``tmp_path``, so no TCP port is
taken and a dead rank fails the fixture instead of hanging the suite).
Each rank writes what it saw to a JSON file; the tests read them.

* The sharded step (``tests/test_distribution.py:54-93``): the smoke
  granite-8b FL step on a (4 data, 2 model) mesh, the state laid out by
  the sharding rules as DTensors (peers over "data", TP over "model"),
  against the unsharded step from the same theta^0 and batch: the loss
  within 1e-3, theta and m within 1e-5.
* The collective pattern (``:96-123``, which asserts nothing about the
  groups' sizes): MAR on the grid (2, 4) across 8 ranks, one peer a
  rank, issues all_reduces on groups of 2 (round 0) and 4 (round 1),
  never 8; ``one_shot`` issues one all_reduce of 8. The values match
  ``mar_aggregate_device`` on the whole stacked tensor within 1e-6, with
  a churn mask that drops one peer and one whole group of round 0. With
  ``comm_dtype=bfloat16`` the sums cross as bf16: on groups of two
  ranks that is one rounding, as the single-card sum takes, so the
  (2, 2, 2) grid matches within 1e-6; on groups of four, the
  collective rounds each partial sum to bf16 where the single-card sum
  rounds once (seen: 5.2e-3 apart), so the (2, 4) grid is held to two
  bf16 roundings of the largest input (2 * 2**-8 * max|x|), a bound set
  from the dtype.
* Two peers a rank (8 peers on the (4, 2) mesh, peers over "data"
  only, grid (2, 2, 2)): rounds 0 and 1 cross ranks in groups of 2,
  round 2 lies inside each rank and issues no collective.
"""
import json
import os
import subprocess
import sys
from datetime import timedelta

import pytest

WORLD = 8
HERE = os.path.dirname(os.path.abspath(__file__))


def _rank_main(rank: int, store_path: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store_path}",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=60))
    try:
        out = {"rank": rank}
        out.update(_sharded_step(rank))
        out.update(_collective_pattern(rank))
        out.update(_two_peers_a_rank(rank))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _sharded_step(rank: int) -> dict:
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core.fl_device import init_fl_state, make_fl_train_step
    from repro_torch.core.moshpit import mesh_grid_plan
    from repro_torch.models.model import Model
    from repro_torch.runtime.op_analysis import OpAnalysis
    from repro_torch.runtime.sharding import (make_shard_plan, shard_tree,
                                              state_shardings)
    from repro_torch.tree import tree_leaves

    cfg = get_smoke_config("granite-8b")
    model = Model(cfg)
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    plan = make_shard_plan(mesh, ("data",))
    grid = mesh_grid_plan([4])
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 1, 1, 2, 32)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, -1)}
    step = make_fl_train_step(model, grid, lr=0.01)
    ref, ref_metrics = step(init_fl_state(model, 4, seed=0, device="cpu"),
                            batch)
    plain = init_fl_state(model, 4, seed=0, device="cpu")
    pm = {"params": plain["params"], "momentum": plain["momentum"]}
    sh = state_shardings(pm, plan, head_dim=cfg.head_dim,
                         num_heads=cfg.num_heads,
                         num_kv_heads=cfg.num_kv_heads)
    state = shard_tree(pm, sh)
    state["step"] = plain["step"]
    state, metrics = step(state, batch)

    def err(key):
        return max(float((x.full_tensor().float() - y.float()).abs().max())
                   for x, y in zip(tree_leaves(state[key]),
                                   tree_leaves(ref[key])))

    theta_err, m_err = err("params"), err("momentum")
    # a second step, analysed (FlopCounterMode may pick other kernels, so
    # the gated step above runs without it)
    with OpAnalysis() as a:
        step(state, batch)
    return {"loss": float(metrics["loss"]),
            "ref_loss": float(ref_metrics["loss"]),
            "theta_err": theta_err, "m_err": m_err,
            "tp_sharded": sum(1 for s in tree_leaves(sh["params"])
                              if "model" in s.spec),
            "peer_sharded": all(s.spec[0] == "data"
                                for s in tree_leaves(sh["params"])),
            "step_collectives": a.collectives}


def _mar_case(grid_dims, dtype, mask, one_shot, mesh, peers_per_rank=1):
    """One MAR aggregation on DTensor leaves against the single-card
    backend on the whole stacked tensors; (max error, max |x|, the
    collectives, CommDebugMode's all-reduce count)."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.core import mar_allreduce as mar
    from repro_torch.core.moshpit import GridPlan
    from repro_torch.runtime.op_analysis import OpAnalysis

    n = int(torch.tensor(grid_dims).prod())
    gen = torch.Generator().manual_seed(7)
    full = {"a": torch.randn(n, 64, generator=gen),
            "b": {"c": torch.randn(n, 3, 5, generator=gen)}}
    plan = GridPlan(n, tuple(grid_dims))
    want = mar.mar_aggregate_device(
        {"a": full["a"].clone(), "b": {"c": full["b"]["c"].clone()}}, plan,
        mask, one_shot=one_shot, comm_dtype=dtype)
    placements = [Shard(0)] + [Replicate()] * (mesh.ndim - 1)
    state = {"a": distribute_tensor(full["a"], mesh, placements,
                                    src_data_rank=None),
             "b": {"c": distribute_tensor(full["b"]["c"], mesh, placements,
                                          src_data_rank=None)}}
    assert state["a"].to_local().shape[0] == peers_per_rank
    with OpAnalysis() as a:
        mar.mar_aggregate_device(state, plan, mask, one_shot=one_shot,
                                 comm_dtype=dtype)
    got = [state["a"].full_tensor(), state["b"]["c"].full_tensor()]
    err = max(float((g - w).abs().max())
              for g, w in zip(got, [want["a"], want["b"]["c"]]))
    scale = max(float(full["a"].abs().max()),
                float(full["b"]["c"].abs().max()))
    return err, scale, a.collectives, a.comm_counts()["all-reduce"]


def _collective_pattern(rank: int) -> dict:
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
    churn = torch.ones(8)
    churn[3] = 0.0              # one peer of round 1's group (0..3)
    churn[4] = churn[0] = 0.0   # round 0's whole group {0, 4}
    out = {}
    for name, dims, dtype, mask, one_shot in [
            ("full", (2, 4), None, None, False),
            ("churn", (2, 4), None, churn, False),
            ("one_shot", (2, 4), None, churn, True),
            ("bf16", (2, 4), torch.bfloat16, churn, False),
            ("bf16_pairs", (2, 2, 2), torch.bfloat16, churn, False)]:
        err, scale, coll, counted = _mar_case(dims, dtype, mask, one_shot,
                                              mesh)
        out[name] = {"err": err, "scale": scale, "collectives": coll,
                     "comm_debug_all_reduce": counted}
    return {"pattern": out}


def _two_peers_a_rank(rank: int) -> dict:
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    mask = torch.ones(8)
    mask[5] = 0.0
    err, _, coll, _ = _mar_case((2, 2, 2), None, mask, False, mesh,
                                peers_per_rank=2)
    return {"two_peers": {"err": err, "collectives": coll}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the 8-rank world once; every rank's JSON, by rank."""
    tmp = tmp_path_factory.mktemp("mesh_mar")
    env = dict(os.environ,
               PYTHONPATH=os.path.join(HERE, "..", "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(tmp)],
        capture_output=True, text=True, env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = {}
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as f:
            out[r] = json.load(f)
    return out


def _all_reduce_sizes(coll):
    return sorted({size for op, _, size in coll if op == "all-reduce"})


def test_sharded_step_matches_unsharded(ranks):
    for r, out in ranks.items():
        assert abs(out["loss"] - out["ref_loss"]) < 1e-3, r
        assert out["theta_err"] < 1e-5 and out["m_err"] < 1e-5, \
            (r, out["theta_err"], out["m_err"])
        assert out["peer_sharded"] and out["tp_sharded"] > 0
    # the step gathers TP shards over "model" (2 ranks), runs MAR over
    # the grid (4,) of the 4 data ranks (mesh_grid_plan([4])) and
    # averages the loss over them
    coll = ranks[0]["step_collectives"]
    assert {size for op, _, size in coll if op == "all-gather"} == {2}
    assert _all_reduce_sizes(coll) == [4]


def test_mar_collectives_are_the_grid_groups(ranks):
    for r, out in ranks.items():
        p = out["pattern"]
        for case in ("full", "churn", "bf16"):
            coll = p[case]["collectives"]
            assert _all_reduce_sizes(coll) == [2, 4], (r, case, coll)
            assert all(op == "all-reduce" for op, _, _ in coll)
            # two leaves share a bucket: one collective a round
            assert len(coll) == 2 and p[case]["comm_debug_all_reduce"] == 2
        assert [c[2] for c in p["one_shot"]["collectives"]] == [8]
        assert [c[2] for c in p["bf16_pairs"]["collectives"]] == [2, 2, 2]
        # f32 sums: 64 + 15 columns of 4 bytes a round
        assert [c[1] for c in p["full"]["collectives"]] == [79 * 4] * 2
        assert [c[1] for c in p["bf16"]["collectives"]] == [79 * 2] * 2


def test_mar_values_match_single_card(ranks):
    for r, out in ranks.items():
        p = out["pattern"]
        for case in ("full", "churn", "one_shot", "bf16_pairs"):
            assert p[case]["err"] <= 1e-6, (r, case, p[case]["err"])
        assert p["bf16"]["err"] <= 2 * 2.0 ** -8 * p["bf16"]["scale"], r


def test_two_peers_a_rank(ranks):
    for r, out in ranks.items():
        t = out["two_peers"]
        assert t["err"] <= 1e-6, (r, t["err"])
        # rounds 0 and 1 cross ranks in pairs; round 2 is inside a rank
        assert [c[2] for c in t["collectives"]] == [2, 2], r


if __name__ == "__main__":
    import torch.multiprocessing as mp

    out_dir = sys.argv[1]
    mp.spawn(_rank_main, args=(os.path.join(out_dir, "store"), out_dir),
             nprocs=WORLD, join=True)
