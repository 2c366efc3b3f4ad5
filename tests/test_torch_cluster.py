"""The port's cluster bring-up against the reference's contract: the
``REPRO_*`` env contract and its flag twin, case by case on the same
dicts and argv as ``repro.runtime.cluster`` (which needs no device to
parse them); the backend rule; ``cluster_info``; and ``init_cluster``
over two gloo CPU ranks started by the env contract, then over a process
group another caller made (the same world is taken over, another is
refused)."""
import argparse
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.runtime import cluster as ref
from repro_torch import compat
from repro_torch.runtime import cluster

SRC = str(Path(__file__).resolve().parents[1] / "src")
TIMEOUT_S = 120

ENV_CASES = [
    {},
    {"REPRO_COORDINATOR": "h:1"},
    {"REPRO_COORDINATOR": "h:1", "REPRO_NUM_PROCESSES": "2"},
    {"REPRO_COORDINATOR": "h:1", "REPRO_NUM_PROCESSES": "2",
     "REPRO_PROCESS_ID": "1"},
    {"REPRO_NUM_PROCESSES": "1"},
    {"REPRO_NUM_PROCESSES": "3", "REPRO_PROCESS_ID": "2"},
    {"REPRO_COORDINATOR": "", "REPRO_NUM_PROCESSES": "1"},
    {"REPRO_PROCESS_ID": "5"},
    {"REPRO_NUM_PROCESSES": "two"},
]
FLAG_CASES = [
    ([], {}),
    (["--coordinator", "h:1"], {}),
    (["--coordinator", "h:1", "--num-processes", "2"], {}),
    (["--coordinator", "h:1", "--num-processes", "2", "--process-id", "0"],
     {}),
    (["--process-id", "1"],
     {"REPRO_COORDINATOR": "h:1", "REPRO_NUM_PROCESSES": "2"}),
    (["--num-processes", "4"],
     {"REPRO_COORDINATOR": "e:2", "REPRO_NUM_PROCESSES": "2",
      "REPRO_PROCESS_ID": "1"}),
    (["--coordinator", "f:3"],
     {"REPRO_COORDINATOR": "e:2", "REPRO_NUM_PROCESSES": "2",
      "REPRO_PROCESS_ID": "0"}),
    (["--num-processes", "2"], {}),
]


def _outcome(fn):
    try:
        cfg = fn()
    except ValueError as err:
        return ("error", str(err))
    return ("ok", cfg.coordinator, cfg.num_processes, cfg.process_id,
            cfg.multiprocess)


@pytest.mark.parametrize("env", ENV_CASES,
                         ids=[f"env{i}" for i in range(len(ENV_CASES))])
def test_env_contract_matches_reference(env):
    assert _outcome(lambda: cluster.ClusterConfig.from_env(env)) == \
        _outcome(lambda: ref.ClusterConfig.from_env(env))


@pytest.mark.parametrize("argv,env", FLAG_CASES,
                         ids=[f"flags{i}" for i in range(len(FLAG_CASES))])
def test_flags_merge_over_env_as_the_reference(argv, env):
    def run(mod):
        ap = argparse.ArgumentParser()
        mod.add_cluster_args(ap)
        return _outcome(lambda: mod.config_from_args(ap.parse_args(argv),
                                                     env))
    assert run(cluster) == run(ref)


def test_env_names_and_reexports():
    assert (cluster.ENV_COORDINATOR, cluster.ENV_NUM_PROCESSES,
            cluster.ENV_PROCESS_ID) == (ref.ENV_COORDINATOR,
                                        ref.ENV_NUM_PROCESSES,
                                        ref.ENV_PROCESS_ID)
    assert cluster.axis_crosses_processes is compat.axis_crosses_processes
    assert cluster.mesh_process_topology is compat.mesh_process_topology
    assert cluster.mesh_process_span is compat.mesh_process_span


def test_backend_rule():
    def ranks(*hosts, cuda=True, gpus=1):
        return [{"host": h, "cuda": cuda, "gpus": gpus} for h in hosts]
    # CPU ranks, and ranks sharing a card: gloo
    assert cluster.pick_backend(ranks("a", "a", cuda=False)) == "gloo"
    assert cluster.pick_backend(ranks("a", "a", "a", "a")) == "gloo"
    # one card a rank on every host: NCCL
    assert cluster.pick_backend(ranks("a", "a", "b", "b", gpus=2)) == "nccl"
    assert cluster.pick_backend(ranks("a", "b")) == "nccl"
    # one host short of cards, or one rank on the CPU: gloo everywhere
    assert cluster.pick_backend(ranks("a", "a", "b", gpus=1)) == "gloo"
    assert cluster.pick_backend(
        ranks("a", gpus=1) + ranks("b", cuda=False)) == "gloo"


def test_one_process_is_a_no_op_and_reports_itself():
    try:
        cfg = cluster.init_cluster(cluster.ClusterConfig(), device="cpu")
        assert cfg == cluster.ClusterConfig() and cluster.is_initialized()
        assert cluster.init_cluster(cluster.ClusterConfig(
            num_processes=2, process_id=1)) is cfg      # the first call wins
        info = cluster.cluster_info()
        assert set(info) >= {"process_index", "process_count",
                             "local_devices", "global_devices", "platform",
                             "initialized"}
        assert info["process_index"] == 0 and info["process_count"] == 1
        assert info["backend"] is None and info["device"] == "cpu"
        assert info["platform"] == "cpu" and info["initialized"]
    finally:
        cluster.shutdown_cluster()
    assert not cluster.is_initialized()


def test_cuda_bring_up_without_a_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this process has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cluster.init_cluster(cluster.ClusterConfig())
    assert not cluster.is_initialized()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(script, envs, timeout=TIMEOUT_S):
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              env=dict(os.environ, PYTHONPATH=SRC,
                                       OMP_NUM_THREADS="1", **env),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for env in envs]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * len(procs), "\n".join(
        f"--- rank {r}\n{log[-3000:]}" for r, log in enumerate(logs))
    return [json.loads(log.strip().splitlines()[-1]) for log in logs]


BY_ENV = textwrap.dedent("""
    import json, os
    import torch, torch.distributed as dist
    from repro_torch.runtime import cluster
    cfg = cluster.init_cluster(device="cpu")
    again = cluster.init_cluster(device="cpu")
    t = torch.tensor([float(cfg.process_id + 1)])
    dist.all_reduce(t)
    info = cluster.cluster_info()
    print(json.dumps({"cfg": [cfg.coordinator, cfg.num_processes,
                              cfg.process_id],
                      "same": again is cfg, "sum": float(t),
                      "info": info}), flush=True)
    dist.barrier()
    os._exit(0)
""")

ADOPT = textwrap.dedent("""
    import json, os, sys
    import torch.distributed as dist
    from repro_torch.runtime import cluster
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo", store=dist.FileStore(sys.argv[-1], 2),
                            rank=rank, world_size=2)
    cfg = cluster.init_cluster(cluster.ClusterConfig("h:1", 2, rank),
                               device="cpu")
    info = cluster.cluster_info()
    cluster.shutdown_cluster()          # not its group: left as it is
    alive = dist.is_initialized()
    try:
        cluster.init_cluster(cluster.ClusterConfig("h:1", 3, rank),
                             device="cpu")
        refused = None
    except RuntimeError as err:
        refused = str(err)
    dist.barrier()
    print(json.dumps({"backend": info["backend"], "alive": alive,
                      "refused": refused}), flush=True)
    os._exit(0)
""")


def test_init_cluster_brings_up_two_ranks_by_the_env_contract():
    coord = f"localhost:{_free_port()}"
    outs = _spawn(BY_ENV, [{"REPRO_COORDINATOR": coord,
                            "REPRO_NUM_PROCESSES": "2",
                            "REPRO_PROCESS_ID": str(r)} for r in range(2)])
    for r, out in enumerate(outs):
        assert out["cfg"] == [coord, 2, r] and out["same"]
        assert out["sum"] == 3.0
        info = out["info"]
        assert info["process_index"] == r and info["process_count"] == 2
        assert info["backend"] == "gloo" and info["device"] == "cpu"
        assert info["global_devices"] == 2 and info["initialized"]


def test_init_cluster_takes_over_the_same_world_and_refuses_another(
        tmp_path):
    script = ADOPT.replace("sys.argv[-1]", repr(str(tmp_path / "store")))
    outs = _spawn(script, [{"RANK": str(r)} for r in range(2)])
    for out in outs:
        assert out["backend"] == "gloo" and out["alive"]
        assert "will not reuse another world" in out["refused"]
