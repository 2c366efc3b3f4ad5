"""Multi-process cluster bring-up — ``torch.distributed`` from the
``REPRO_*`` contract (counterpart of ``repro/runtime/cluster.py``).

Everything below the launch layer is written against meshes of ranks and
their process groups; what stands between one process and the paper's
deployment shape (an FFT running across the processes producing the
data, or beside them) is process bring-up. This module owns exactly
that, with the reference's contract:

* **Discovery** — ``ClusterConfig.from_env()`` reads
  ``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID``;
  ``add_cluster_args``/``config_from_args`` expose the same knobs as CLI
  flags (flags win over env; completeness is checked on the merged
  values). Validation and messages are the reference's.
* **Initialisation** — ``init_cluster()`` is idempotent and a no-op for
  one process. For more than one, rank 0 serves a ``TCPStore`` at the
  coordinator (``host:port``, the address every process passes); each
  process publishes its host, its device type and its CUDA device count
  there, and every process then picks the same backend by one rule,
  before any process group exists:

  - **gloo** for CPU devices, and wherever ranks share a card;
  - **NCCL** only where every rank asks for CUDA and, on every host, the
    ranks number no more than the host's GPUs (NCCL refuses two ranks of
    one communicator on one GPU).

  ``torch.distributed.init_process_group(backend, store=..., rank=
  process_id, world_size=num_processes)`` follows; a rank on CUDA takes
  the card ``LOCAL_RANK`` names, else its index among its host's ranks
  modulo the host's cards (``torch.cuda.set_device``, which the
  meshes' default device follows). There is no fallback: a failed
  bring-up raises, and a CUDA device with no card raises before it.
* **A process group made by another caller** — the counterpart of the
  reference's "backend already initialised" probe: one with the same
  rank and world is taken over as it is (a ``torchrun`` script that
  called ``init_process_group`` itself); one with another rank or world
  is an error, never a silent reuse.
* **Topology queries** — ``axis_crosses_processes``,
  ``mesh_process_topology`` and ``mesh_process_span`` re-exported from
  ``compat`` (in the port a process is a rank, so the span is the mesh's
  global ranks).
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import socket
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import compat

ENV_COORDINATOR = "REPRO_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"
# how long a process waits for the others at bring-up
BRING_UP_TIMEOUT_S = 300.0

_STATE: Dict[str, object] = {"initialized": False, "config": None,
                             "backend": None, "device": None,
                             "store": None, "owned": False}


def _read_env(e) -> tuple:
    """The raw, UNVALIDATED ``REPRO_*`` read — the single definition of
    the env contract's defaults, shared by ``ClusterConfig.from_env``
    and ``config_from_args`` so the env- and flag-driven bring-up
    paths cannot drift. Returns (coordinator, num_processes,
    process_id)."""
    return (e.get(ENV_COORDINATOR) or None,
            int(e.get(ENV_NUM_PROCESSES, "1")),
            int(e.get(ENV_PROCESS_ID, "0")))


def _require_complete(coordinator, num_processes: int, *,
                      nprocs_given: bool, pid_given: bool) -> None:
    """A half-configured cluster must fail loudly at bring-up, not hang
    at the first collective — shared by the env and flag paths so
    neither can smuggle an incomplete config past validation."""
    if coordinator is not None and not nprocs_given:
        raise ValueError(
            f"a coordinator is set ({ENV_COORDINATOR} or --coordinator) "
            f"but the process count is not — set {ENV_NUM_PROCESSES} or "
            f"--num-processes (and a distinct rank per process)")
    if num_processes > 1 and not pid_given:
        # without an explicit rank every process defaults to 0 and
        # bring-up deadlocks waiting for the other ranks
        raise ValueError(
            f"num_processes={num_processes} but no rank is set — give "
            f"each process a distinct {ENV_PROCESS_ID} or --process-id "
            f"(0..{num_processes - 1})")


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """One process's view of the cluster.

    ``coordinator`` is ``host:port`` of process 0's store (every process
    passes the SAME address, including process 0 itself);
    ``num_processes``/``process_id`` complete the contract. The default
    instance describes a single-process run, for which ``init_cluster``
    does nothing — launch code can call it unconditionally."""
    coordinator: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0

    @property
    def multiprocess(self) -> bool:
        return self.num_processes > 1

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None
                 ) -> "ClusterConfig":
        """Read the ``REPRO_*`` environment contract. Unset variables
        yield the single-process default; a coordinator with no process
        count is an error."""
        e = os.environ if env is None else env
        coord, nprocs, pid = _read_env(e)
        _require_complete(coord, nprocs,
                          nprocs_given=ENV_NUM_PROCESSES in e,
                          pid_given=ENV_PROCESS_ID in e)
        return cls(coordinator=coord, num_processes=nprocs, process_id=pid)


def add_cluster_args(parser) -> None:
    """Attach the flag-driven discovery knobs to an argparse parser
    (the env contract's CLI twin; flags win over env when both set)."""
    parser.add_argument("--coordinator", default=None,
                        help="host:port of process 0's store "
                             "(default: $REPRO_COORDINATOR)")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="total processes in the cluster "
                             "(default: $REPRO_NUM_PROCESSES)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="this process's rank "
                             "(default: $REPRO_PROCESS_ID)")


def config_from_args(args, env: Optional[Dict[str, str]] = None
                     ) -> ClusterConfig:
    """Merge ``add_cluster_args`` flags over the env contract. The
    completeness checks run on the MERGED values (flags may complete a
    partial env, and vice versa)."""
    e = os.environ if env is None else env
    ecoord, enprocs, epid = _read_env(e)
    coord = getattr(args, "coordinator", None)
    nprocs = getattr(args, "num_processes", None)
    pid = getattr(args, "process_id", None)
    merged = ClusterConfig(
        coordinator=coord if coord is not None else ecoord,
        num_processes=nprocs if nprocs is not None else enprocs,
        process_id=pid if pid is not None else epid)
    _require_complete(
        merged.coordinator, merged.num_processes,
        nprocs_given=nprocs is not None or ENV_NUM_PROCESSES in e,
        pid_given=pid is not None or ENV_PROCESS_ID in e)
    return merged


def pick_backend(ranks) -> str:
    """The backend rule over every rank's ``{"host", "cuda", "gpus"}``:
    NCCL only where every rank asks for CUDA and no host has more ranks
    than cards; gloo otherwise."""
    per_host: Dict[str, list] = {}
    for r in ranks:
        per_host.setdefault(r["host"], []).append(r)
    if all(r["cuda"] for r in ranks) and all(
            len(rs) <= min(r["gpus"] for r in rs)
            for rs in per_host.values()):
        return "nccl"
    return "gloo"


def _split(coordinator: str):
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator {coordinator!r} is not host:port")
    return host, int(port)


def _adopt(cfg: ClusterConfig, device: torch.device) -> None:
    """Take over a default process group another caller made, if it is
    this config's world."""
    rank, world = dist.get_rank(), dist.get_world_size()
    if (rank, world) != (cfg.process_id, cfg.num_processes):
        raise RuntimeError(
            f"torch.distributed is already initialised as rank {rank} of "
            f"{world}, but this process's cluster config says rank "
            f"{cfg.process_id} of {cfg.num_processes}: init_cluster() "
            f"will not reuse another world — bring the cluster up once, "
            f"through init_cluster or with the same rank and world")
    _STATE.update(backend=dist.get_backend(), device=device, owned=False)


def init_cluster(config: Optional[ClusterConfig] = None, *,
                 device=None) -> ClusterConfig:
    """Bring up ``torch.distributed`` from ``config`` (default:
    ``ClusterConfig.from_env()``) for ranks on ``device`` (default
    ``cuda``; ``"cpu"`` only when asked). Idempotent: the first call wins
    and later calls return its config. Single-process configs initialise
    nothing, so every entry point can call this unconditionally."""
    if _STATE["initialized"]:
        return _STATE["config"]          # type: ignore[return-value]
    cfg = ClusterConfig.from_env() if config is None else config
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_cluster: a CUDA device was asked for and "
                           "this process sees none; pass device='cpu' to "
                           "run the ranks on the CPU")
    if dist.is_available() and dist.is_initialized():
        _adopt(cfg, device)
    elif cfg.multiprocess:
        if cfg.coordinator is None:
            raise ValueError(
                "multi-process ClusterConfig needs a coordinator "
                "address (host:port of process 0)")
        host, port = _split(cfg.coordinator)
        timeout = datetime.timedelta(seconds=BRING_UP_TIMEOUT_S)
        store = dist.TCPStore(host, port, cfg.num_processes,
                              cfg.process_id == 0, timeout=timeout)
        gpus = torch.cuda.device_count() if device.type == "cuda" else 0
        store.set(f"repro/rank/{cfg.process_id}", json.dumps(
            {"host": socket.gethostname(), "cuda": device.type == "cuda",
             "gpus": gpus}))
        ranks = [json.loads(store.get(f"repro/rank/{r}"))
                 for r in range(cfg.num_processes)]
        backend = pick_backend(ranks)
        if device.type == "cuda":
            me = ranks[cfg.process_id]["host"]
            local = [r for r in range(cfg.num_processes)
                     if ranks[r]["host"] == me].index(cfg.process_id)
            card = int(os.environ.get("LOCAL_RANK", local % gpus))
            torch.cuda.set_device(card)
            device = torch.device("cuda", card)
        dist.init_process_group(backend,
                                store=dist.PrefixStore("repro/pg", store),
                                rank=cfg.process_id,
                                world_size=cfg.num_processes,
                                timeout=timeout)
        _STATE.update(backend=backend, device=device, store=store,
                      owned=True)
    else:
        _STATE.update(backend=None, device=device, owned=False)
    _STATE["initialized"] = True
    _STATE["config"] = cfg
    return cfg


def is_initialized() -> bool:
    return bool(_STATE["initialized"])


def shutdown_cluster() -> None:
    """Tear down the process group this module made (tests/launcher
    epilogue); safe to call when never initialized."""
    if _STATE["owned"]:
        dist.destroy_process_group()
    _STATE.update(initialized=False, config=None, backend=None,
                  device=None, store=None, owned=False)


def cluster_info() -> Dict[str, object]:
    """This process's runtime view — what to log first when a bring-up
    misbehaves. Rank stands for the reference's process index and the
    world size for its process count (one process a rank, one device a
    process)."""
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    device = _STATE["device"]
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
        "platform": device.type if device is not None else None,
        "initialized": is_initialized(),
        "backend": _STATE["backend"],
        "device": str(device) if device is not None else None,
        "host": socket.gethostname(),
    }


# ---------------------------------------------------------------------------
# Mesh topology queries — which axes cross hosts
# ---------------------------------------------------------------------------
# The primitives live in repro_torch.compat (below every layer, so the
# FFT schedule engine can use them without importing runtime); this is
# their documented runtime-facing home.
axis_crosses_processes = compat.axis_crosses_processes
mesh_process_topology = compat.mesh_process_topology
mesh_process_span = compat.mesh_process_span
