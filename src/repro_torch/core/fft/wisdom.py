"""FFTW-wisdom-style persistent autotune store (counterpart of
``repro/core/fft/wisdom.py``).

Every measured decision of the planner (the ``backend="measure"`` knob
winners: backend × overlap × wire; the ``decomp="measure"`` winners) is
worth one process lifetime in the plan caches. Wisdom makes it outlive
the process, as ``fftw_export_wisdom`` does: ``plan.py`` reads it
through before a sweep (a hit times zero candidates and runs no sweep
collective) and writes each newly agreed winner behind it, so every
rank writes the same wisdom.

File format (JSON, atomic-replace writes)::

    {"format": "repro-fft-wisdom", "schema": 1,
     "software": {"torch": "2.11.0", "cuda": "12.8",
                  "device": "NVIDIA H100 80GB HBM3", "sweep_rev": 3},
     "entries": {"<canonical key>": {"kind": "tune" | "decomp",
                                     "value": ...}}}

A key holds the sweep kind, its inputs (shape, direction, decomposition
or the caller's knobs, axis names, real, batch rank, the wire flags) and
the mesh's topology fingerprint (``topology_fingerprint``). The schema
and the software fingerprint live at the file level: another schema,
torch, CUDA, device or ``SWEEP_REV`` invalidates the whole file, counted
as ``stale``. A file the JAX package wrote names ``jax`` in its software
fingerprint, so the port reads it as stale wisdom and measures anew; it
never raises. A corrupt or unreadable file is a cold start, never a
crash. One store is thread-safe; ranks writing the same agreed winner to
a shared path are safe too (atomic replaces of the same content).

Env contract (read by ``plan.py``): ``REPRO_WISDOM_FILE`` names the
store, ``REPRO_WISDOM_MODE`` is ``off|read|readwrite`` (default
``readwrite``); drivers expose the pair as ``--wisdom`` /
``--wisdom-mode``.
"""
from __future__ import annotations

import json
import os
import socket
import tempfile
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

FORMAT = "repro-fft-wisdom"
SCHEMA = 1

# Bump whenever the meaning of a recorded winner changes: the sweep
# candidate spaces (plan._schedule_variants, plan._SWEEP_DECOMPS), the
# knob-dict fields, the key anatomy, or the timing method. Old wisdom
# then reads as stale (cold start).
SWEEP_REV = 3

MODES = ("off", "read", "readwrite")


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def software_fingerprint() -> Dict[str, Any]:
    """The file-level validity scope: measured winners do not survive
    another torch, CUDA or card (other kernels, other collectives), or a
    sweep-space revision."""
    device = torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cpu")
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "device": _device_name(device), "sweep_rev": SWEEP_REV}


def topology_fingerprint(mesh) -> dict:
    """What a measured winner depends on in the mesh's placement: the
    axis extents, each rank's mesh coordinate and host, the world size,
    the device type and name, and which axes cross hosts. Hosts are
    numbered in the order the ranks name them, so a restart on other
    nodes of the same layout warm-starts, while moving ranks between
    nodes (which changes which exchanges cross hosts) misses."""
    from repro_torch.compat import axis_crosses_processes
    shape = tuple(mesh.shape[n] for n in mesh.axis_names)
    hosts = mesh.hosts or (socket.gethostname(),) * mesh.size
    index: Dict[str, int] = {}
    ranks = []
    for r, host in enumerate(hosts):
        coord = [int(c) for c in np.unravel_index(r, shape)]
        ranks.append([coord, index.setdefault(host, len(index))])
    world = dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 1
    return {
        "mesh_shape": [[str(n), int(mesh.shape[n])] for n in mesh.axis_names],
        "rank_coordinate_host": ranks,
        "world_size": int(world),
        "device_type": mesh.device.type,
        "device_name": _device_name(mesh.device),
        "axis_crosses_hosts": sorted(
            (str(n), bool(axis_crosses_processes(mesh, n)))
            for n in mesh.axis_names),
    }


def wisdom_key(kind: str, mesh, **fields) -> str:
    """Canonical entry key: the sweep kind, the caller's sweep inputs and
    the mesh's topology fingerprint, serialised deterministically (sorted
    keys, tuples as lists), so identical inputs on an identical topology
    give the byte-identical key on every rank."""

    def norm(v):
        if isinstance(v, (tuple, list)):
            return [norm(x) for x in v]
        if isinstance(v, dict):
            return {str(k): norm(x) for k, x in sorted(v.items())}
        return v

    payload = {"kind": kind, "topology": topology_fingerprint(mesh)}
    payload.update({k: norm(v) for k, v in fields.items()})
    return json.dumps(norm(payload), sort_keys=True,
                      separators=(",", ":"))


class WisdomStore:
    """One on-disk wisdom file: lazy validated load, thread-safe
    lookups, atomic write-behind persists. ``mode``:

    * ``"read"``      — lookups only; never writes the file.
    * ``"readwrite"`` — lookups + persist every newly agreed winner.

    (``"off"`` is handled by the caller never constructing a store.)
    """

    def __init__(self, path, mode: str = "readwrite"):
        if mode not in MODES:
            raise ValueError(f"wisdom mode must be one of {MODES}, "
                             f"got {mode!r}")
        self.path = Path(path)
        self.mode = mode
        self._lock = threading.RLock()
        self._entries: Optional[Dict[str, dict]] = None
        self._stats = {"hits": 0, "misses": 0, "stale": 0, "writes": 0,
                       "load_errors": 0, "write_errors": 0}

    # -- load ----------------------------------------------------------------
    def _load_locked(self) -> None:
        """Read + validate the file once (idempotent; caller holds the
        lock). Any failure mode — missing, unreadable, corrupt JSON,
        wrong format/schema, different software fingerprint — degrades
        to an empty entry map: unreadable wisdom is a cold start,
        never a crash."""
        if self._entries is not None:
            return
        self._entries = {}
        if not self.path.exists():
            return
        try:
            payload = json.loads(self.path.read_text())
            if (not isinstance(payload, dict)
                    or payload.get("format") != FORMAT):
                raise ValueError(f"not a {FORMAT} file")
        except Exception:  # noqa: BLE001 — corrupt/unreadable: cold start
            self._stats["load_errors"] += 1
            return
        entries = payload.get("entries")
        entries = entries if isinstance(entries, dict) else {}
        if (payload.get("schema") != SCHEMA
                or payload.get("software") != software_fingerprint()):
            # versioned invalidation: every entry measured under the
            # old schema/software/sweep-space is stale, wholesale
            self._stats["stale"] += max(1, len(entries))
            return
        self._entries = entries

    # -- read-through ---------------------------------------------------------
    def lookup(self, kind: str, key: str):
        """The recorded winner for ``key``, or ``None`` (miss). A key
        present with the wrong ``kind`` counts as stale, not a hit."""
        with self._lock:
            self._load_locked()
            entry = self._entries.get(key)
            if not isinstance(entry, dict) or "value" not in entry:
                self._stats["misses"] += 1
                return None
            if entry.get("kind") != kind:
                self._stats["stale"] += 1
                self._stats["misses"] += 1
                return None
            self._stats["hits"] += 1
            value = entry["value"]
        return json.loads(json.dumps(value))    # defensive copy

    def count_stale(self, n: int = 1) -> None:
        """Caller-side invalidation accounting: a looked-up value that
        failed the caller's validation (e.g. a knob dict naming a
        backend that no longer exists) is stale wisdom, and the hit
        that returned it must be re-booked as such."""
        with self._lock:
            self._stats["stale"] += n
            self._stats["hits"] = max(0, self._stats["hits"] - n)
            self._stats["misses"] += n

    # -- write-behind ---------------------------------------------------------
    def record(self, kind: str, key: str, value) -> None:
        """Persist one agreed winner (no-op unless ``readwrite``).
        The in-memory map updates first, then the whole store is
        rewritten atomically (temp file + ``os.replace`` in the target
        directory, so concurrent identical writers can only produce a
        complete file). Write failures are counted, not raised — a
        read-only deployment still serves, just without new wisdom."""
        if self.mode != "readwrite":
            return
        with self._lock:
            self._load_locked()
            self._entries[key] = {"kind": kind,
                                  "value": json.loads(json.dumps(value))}
            self._flush_locked()

    def _flush_locked(self) -> None:
        payload = {"format": FORMAT, "schema": SCHEMA,
                   "software": software_fingerprint(),
                   "entries": self._entries}
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(
                prefix=self.path.name + ".", suffix=".tmp",
                dir=str(self.path.parent))
            try:
                with os.fdopen(fd, "w") as fh:
                    fh.write(json.dumps(payload, indent=1,
                                        sort_keys=True) + "\n")
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            self._stats["writes"] += 1
        except Exception:  # noqa: BLE001 — persistence is best-effort
            self._stats["write_errors"] += 1

    # -- introspection --------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)

    def size(self) -> int:
        with self._lock:
            self._load_locked()
            return len(self._entries)

    def reload(self) -> None:
        """Drop the in-memory map so the next lookup re-reads the file
        (e.g. after another process appended wisdom to a shared
        path)."""
        with self._lock:
            self._entries = None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"WisdomStore(path={str(self.path)!r}, "
                f"mode={self.mode!r})")


def store_from_env() -> Optional[WisdomStore]:
    """The env contract: ``REPRO_WISDOM_FILE`` names the file,
    ``REPRO_WISDOM_MODE`` (default ``readwrite``) gates it. Returns
    ``None`` when unset or explicitly ``off`` — the planner then runs
    exactly as before this module existed."""
    path = os.environ.get("REPRO_WISDOM_FILE", "").strip()
    mode = os.environ.get("REPRO_WISDOM_MODE", "readwrite").strip()
    if not path or mode == "off":
        return None
    return WisdomStore(path, mode=mode)
