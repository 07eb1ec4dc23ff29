"""Cluster bootstrap env parsing (``repro_torch.launch.cluster``): the
reference's five cases (``tests/test_cluster.py``), torchrun's env, and
the reference's detection on the same envs."""
import pytest

from repro.launch import cluster as ref_cluster

from repro_torch.launch.cluster import (ClusterInfo, _first_host,
                                        assert_mesh_feasible,
                                        detect_topology, initialize_cluster)

ENV_KEYS = ("REPRO_NUM_PROCESSES", "REPRO_PROCESS_ID", "REPRO_COORDINATOR",
            "SLURM_NTASKS", "SLURM_PROCID", "SLURM_STEP_NODELIST",
            "SLURM_NODELIST", "WORLD_SIZE", "RANK", "MASTER_ADDR",
            "MASTER_PORT")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_single_host_default(clean_env):
    info = detect_topology()
    assert info.num_processes == 1 and info.process_id == 0
    assert initialize_cluster().initialized is False  # no-op


def test_explicit_env(clean_env):
    clean_env.setenv("REPRO_NUM_PROCESSES", "128")
    clean_env.setenv("REPRO_PROCESS_ID", "17")
    clean_env.setenv("REPRO_COORDINATOR", "h0:8476")
    info = detect_topology()
    assert info.num_processes == 128
    assert info.process_id == 17
    assert info.coordinator == "h0:8476"
    assert not info.is_coordinator


def test_slurm_env(clean_env):
    clean_env.setenv("SLURM_NTASKS", "64")
    clean_env.setenv("SLURM_PROCID", "0")
    clean_env.setenv("SLURM_STEP_NODELIST", "tpu[003-066]")
    info = detect_topology()
    assert info.num_processes == 64
    assert info.coordinator == "tpu003:8476"
    assert info.is_coordinator


def test_first_host_forms():
    assert _first_host("node[003-008]") == "node003"
    assert _first_host("node7") == "node7"
    assert _first_host("a001,a002") == "a001"


def test_mesh_feasibility_guard():
    assert_mesh_feasible(128, 4, (2, 16, 16))        # 512 == 512
    with pytest.raises(RuntimeError):
        assert_mesh_feasible(64, 4, (2, 16, 16))     # 256 < 512


def test_torchrun_env(clean_env):
    clean_env.setenv("WORLD_SIZE", "8")
    clean_env.setenv("RANK", "3")
    clean_env.setenv("MASTER_ADDR", "h7")
    clean_env.setenv("MASTER_PORT", "29511")
    info = detect_topology()
    assert info == ClusterInfo("h7:29511", 8, 3, False)
    # SLURM, then the explicit env, take precedence over torchrun's
    clean_env.setenv("SLURM_NTASKS", "64")
    clean_env.setenv("SLURM_PROCID", "5")
    clean_env.setenv("SLURM_NODELIST", "n[010-073]")
    assert detect_topology() == ClusterInfo("n010:8476", 64, 5, False)
    clean_env.setenv("REPRO_NUM_PROCESSES", "2")
    assert detect_topology().num_processes == 2


@pytest.mark.parametrize("env", [
    {},
    {"REPRO_NUM_PROCESSES": "128", "REPRO_PROCESS_ID": "17",
     "REPRO_COORDINATOR": "h0:8476"},
    {"SLURM_NTASKS": "64", "SLURM_PROCID": "9",
     "SLURM_STEP_NODELIST": "tpu[003-066]"},
    {"SLURM_NTASKS": "1", "SLURM_PROCID": "0"},
    {"REPRO_NUM_PROCESSES": "4", "SLURM_NTASKS": "64"},
])
def test_detection_matches_reference(clean_env, env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    ref = ref_cluster.detect_topology()
    assert detect_topology() == ClusterInfo(
        ref.coordinator, ref.num_processes, ref.process_id, ref.initialized)
