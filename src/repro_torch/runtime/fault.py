"""Fault tolerance: restart driver, straggler monitor, failure detector,
and deterministic fault injection (counterpart of
``repro/runtime/fault.py``; names, defaults, event dicts and report keys
are the reference's).

On thousands of nodes the failure model is "some step eventually
dies"; two contracts matter:

* **Resume equivalence** — checkpoint at step k + deterministic inputs
  (a pure function of the step) ⇒ a restarted run reproduces the exact
  trajectory it would have taken. ``run_with_restarts`` enforces and
  tests that contract by (optionally) injecting failures.
* **Bounded detection** — a consumer rank that stops heartbeating is
  declared dead within ``max_misses`` lease periods, so the elastic
  controller (``runtime/elastic.py``) can rescale the mesh instead of
  hanging a collective on a ghost. ``FailureDetector`` implements the
  lease protocol.

``StragglerMonitor`` is the per-process stand-in for fleet-level
straggler mitigation: a robust step-time estimate (EMA + deviation)
flags steps beyond k·σ, and per-rank observations feed a percentile
report the ``FailureDetector`` consumes to evict persistently slow
ranks. ``reset()`` must be called on restart or rescale — the old EMA
describes a trajectory that no longer exists, and the first
post-restore step would otherwise be judged against stale state.

Chaos testing drives everything through ``FaultSchedule``: a pure
function of (step, rank) → active faults, identical on every process,
so multi-process rescale scenarios replay deterministically.

``run_with_restarts`` saves and restores through the port's
``ckpt/checkpoint.py``, whose ``restore`` places each leaf with a
per-leaf callable (``place=``) where the reference takes a tree of
shardings; its placement keyword is therefore ``state_place`` (a tree of
callables, numpy array → the placed leaf) where the reference's is
``state_shardings``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np

from repro_torch.ckpt import checkpoint as ckpt

# Injected-fault modes (FaultSchedule / InjectedFailure.mode):
KILL_AT_STEP = "kill"             # raise InjectedFailure at the step
HEARTBEAT_DROP = "heartbeat-drop"  # rank silently stops heartbeating
SLOW_RANK = "slow-rank"           # rank's step times inflate
FAULT_MODES = (KILL_AT_STEP, HEARTBEAT_DROP, SLOW_RANK)


@dataclass
class StragglerMonitor:
    alpha: float = 0.1
    threshold: float = 3.0
    ema: Optional[float] = None
    dev: float = 0.0
    slow_steps: List[Dict[str, float]] = field(default_factory=list)
    window: int = 256
    resets: int = 0
    rank_times: Dict[int, List[float]] = field(default_factory=dict)

    def observe(self, step: int, seconds: float,
                rank: Optional[int] = None) -> bool:
        if rank is not None:
            times = self.rank_times.setdefault(int(rank), [])
            times.append(float(seconds))
            del times[:-self.window]
        if self.ema is None:
            self.ema = seconds
            return False
        is_slow = seconds > self.ema + self.threshold * max(self.dev,
                                                            0.05 * self.ema)
        if is_slow:
            self.slow_steps.append({"step": step, "seconds": seconds,
                                    "expected": self.ema})
        self.dev = (1 - self.alpha) * self.dev \
            + self.alpha * abs(seconds - self.ema)
        self.ema = (1 - self.alpha) * self.ema + self.alpha * seconds
        return is_slow

    def reset(self) -> None:
        """Forget the trajectory estimate. Call on restart or rescale:
        the next ``observe`` re-seeds the EMA instead of judging the
        (always slow) restore step against pre-failure state. The
        slow-step log survives — it is history, not estimate."""
        self.ema = None
        self.dev = 0.0
        self.rank_times.clear()
        self.resets += 1

    def rank_report(self, *, percentile: float = 90.0,
                    slow_factor: float = 2.0) -> Dict[str, Any]:
        """Percentile-based per-rank view: a rank whose p-``percentile``
        step time exceeds ``slow_factor`` × the median rank's is slow.
        ``FailureDetector.consume_straggler_report`` turns persistent
        membership in ``slow_ranks`` into eviction."""
        per_rank = {r: float(np.percentile(t, percentile))
                    for r, t in sorted(self.rank_times.items()) if t}
        if not per_rank:
            return {"percentile": percentile, "ranks": {},
                    "baseline_s": None, "slow_ranks": []}
        baseline = float(np.median(list(per_rank.values())))
        slow = [r for r, v in per_rank.items()
                if baseline > 0 and v > slow_factor * baseline]
        return {"percentile": percentile, "ranks": per_rank,
                "baseline_s": baseline, "slow_ranks": slow}

    def report(self) -> Dict[str, Any]:
        return {"mean_step_s": self.ema, "dev_s": self.dev,
                "slow_steps": self.slow_steps, "resets": self.resets}


class InjectedFailure(RuntimeError):
    """A deterministically injected fault. ``mode`` is one of
    ``FAULT_MODES``; ``step``/``rank`` locate the injection so chaos
    tests can assert exactly which scheduled fault fired."""

    def __init__(self, message: str = "injected failure", *,
                 mode: str = KILL_AT_STEP,
                 step: Optional[int] = None,
                 rank: Optional[int] = None):
        super().__init__(message)
        self.mode = mode
        self.step = step
        self.rank = rank


@dataclass(frozen=True)
class InjectedFault:
    """One scheduled fault: ``mode`` becomes active at ``step`` on
    ``rank`` and stays active for ``duration`` steps (``None`` =
    forever). ``slow_factor`` only applies to ``SLOW_RANK``."""
    mode: str
    step: int
    rank: int = 0
    duration: Optional[int] = None
    slow_factor: float = 10.0

    def active(self, step: int) -> bool:
        if step < self.step:
            return False
        return self.duration is None or step < self.step + self.duration


class FaultSchedule:
    """A deterministic chaos schedule: the set of active faults is a
    pure function of (step, rank), with no clocks or randomness, so
    every process of a cluster replays the identical scenario — the
    precondition for asserting rescale behavior across ranks."""

    def __init__(self, faults: Iterable[InjectedFault] = ()):
        self.faults = tuple(faults)
        for f in self.faults:
            if f.mode not in FAULT_MODES:
                raise ValueError(f"fault mode must be one of "
                                 f"{FAULT_MODES}, got {f.mode!r}")

    def active(self, step: int) -> List[InjectedFault]:
        return [f for f in self.faults if f.active(step)]

    def check_kill(self, step: int, rank: int = 0) -> None:
        """Raise for a KILL_AT_STEP fault landing exactly on ``step``
        (kills are edges, not levels — a restart replays the step
        without re-dying)."""
        for f in self.faults:
            if (f.mode == KILL_AT_STEP and f.step == step
                    and f.rank == rank):
                raise InjectedFailure(
                    f"injected kill at step {step} rank {rank}",
                    mode=KILL_AT_STEP, step=step, rank=rank)

    def drops_heartbeat(self, step: int, rank: int) -> bool:
        return any(f.mode == HEARTBEAT_DROP and f.rank == rank
                   and f.active(step) for f in self.faults)

    def slow_factor(self, step: int, rank: int) -> float:
        factor = 1.0
        for f in self.faults:
            if f.mode == SLOW_RANK and f.rank == rank and f.active(step):
                factor = max(factor, f.slow_factor)
        return factor


class FailureDetector:
    """Heartbeat/lease failure detector for consumer ranks.

    Each registered rank holds a lease that its heartbeats renew; a
    rank whose last heartbeat is ``max_misses`` lease periods old is
    declared dead on the next ``poll()``. Deadness is permanent until
    the rank re-``register``\\ s (rejoin), so a late heartbeat from a
    declared-dead rank is ignored — the controller may already have
    rebuilt the mesh without it.

    ``clock`` is injectable: wall-seconds in production
    (``time.monotonic``), a fake clock in unit tests, or a *step
    counter* in multi-process runs — steps advance identically on
    every rank, making detection deterministic cluster-wide where
    wall clocks would race.
    """

    def __init__(self, *, lease: float = 1.0, max_misses: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        if lease <= 0:
            raise ValueError(f"lease must be positive, got {lease}")
        if max_misses < 1:
            raise ValueError(f"max_misses must be >= 1, got {max_misses}")
        self.lease = float(lease)
        self.max_misses = int(max_misses)
        self.clock = clock
        self._last: Dict[int, float] = {}       # rank -> last heartbeat
        self._dead: Dict[int, str] = {}         # rank -> reason
        self._suspect_streak: Dict[int, int] = {}
        self.events: List[Dict[str, Any]] = []

    # -- membership ----------------------------------------------------------
    def register(self, rank: int, now: Optional[float] = None) -> None:
        """Grant (or re-grant, on rejoin) a fresh lease."""
        rank = int(rank)
        self._last[rank] = self.clock() if now is None else now
        self._suspect_streak.pop(rank, None)
        if rank in self._dead:
            del self._dead[rank]
            self.events.append({"event": "rejoin", "rank": rank})

    def deregister(self, rank: int) -> None:
        """Graceful leave: no death event, just gone."""
        self._last.pop(int(rank), None)
        self._suspect_streak.pop(int(rank), None)

    def heartbeat(self, rank: int, now: Optional[float] = None) -> None:
        rank = int(rank)
        if rank in self._dead:
            return                      # lease already revoked; rejoin first
        if rank not in self._last:
            raise KeyError(f"rank {rank} is not registered")
        self._last[rank] = self.clock() if now is None else now

    # -- verdicts ------------------------------------------------------------
    def missed(self, rank: int, now: Optional[float] = None) -> int:
        now = self.clock() if now is None else now
        return int((now - self._last[int(rank)]) / self.lease)

    def poll(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Evaluate every lease. Newly expired ranks transition to
        dead exactly once (an event is recorded); the returned
        ``new_dead`` list is what a controller acts on."""
        now = self.clock() if now is None else now
        new_dead: List[int] = []
        missed: Dict[int, int] = {}
        for rank in sorted(self._last):
            if rank in self._dead:
                continue
            n = self.missed(rank, now)
            missed[rank] = n
            if n >= self.max_misses:
                self._declare(rank, f"missed {n} heartbeats")
                new_dead.append(rank)
        return {"now": now, "new_dead": new_dead,
                "dead": self.dead_ranks(),
                "alive": self.alive_ranks(), "missed": missed}

    def declare_dead(self, rank: int, reason: str = "operator") -> None:
        """Out-of-band verdict (operator action, or a peer's agreed
        verdict broadcast by the elastic controller)."""
        rank = int(rank)
        if rank not in self._dead:
            self._declare(rank, reason)

    def _declare(self, rank: int, reason: str) -> None:
        self._dead[rank] = reason
        self._suspect_streak.pop(rank, None)
        self.events.append({"event": "dead", "rank": rank,
                            "reason": reason})

    def consume_straggler_report(self, report: Dict[str, Any], *,
                                 evict_after: int = 3) -> List[int]:
        """Feed a ``StragglerMonitor.rank_report``: a rank slow in
        ``evict_after`` *consecutive* reports is evicted (declared
        dead) — one slow percentile is noise, a persistent one is a
        failing node. Returns the newly evicted ranks."""
        slow = {int(r) for r in report.get("slow_ranks", ())}
        evicted: List[int] = []
        for rank in list(self._last):
            if rank in self._dead:
                continue
            if rank in slow:
                streak = self._suspect_streak.get(rank, 0) + 1
                self._suspect_streak[rank] = streak
                if streak >= evict_after:
                    self._declare(rank, f"straggler in {streak} "
                                        f"consecutive reports")
                    evicted.append(rank)
            else:
                self._suspect_streak.pop(rank, None)
        return evicted

    # -- introspection -------------------------------------------------------
    def alive_ranks(self) -> List[int]:
        return sorted(r for r in self._last if r not in self._dead)

    def dead_ranks(self) -> List[int]:
        return sorted(self._dead)

    def suspect_ranks(self) -> List[int]:
        return sorted(r for r, n in self._suspect_streak.items() if n > 0)

    def report(self) -> Dict[str, Any]:
        return {"lease": self.lease, "max_misses": self.max_misses,
                "alive": self.alive_ranks(), "dead": dict(self._dead),
                "suspect": self.suspect_ranks(),
                "events": list(self.events)}


def run_with_restarts(*, make_state: Callable[[], Any],
                      train_step: Callable[[Any, Any], Any],
                      batch_fn: Callable[[int], Any],
                      total_steps: int,
                      ckpt_dir, ckpt_every: int = 10,
                      state_place=None, state_gather=None, mesh=None,
                      fail_at: Optional[List[int]] = None,
                      max_restarts: int = 10,
                      on_metrics: Optional[Callable] = None):
    """Step driver with checkpoint/restart semantics.

    ``fail_at``: steps at which to inject a failure (testing). Each
    failure triggers restore-from-latest and replay, exactly as a real
    preemption/node-loss restart would. ``state_place`` is
    ``ckpt.restore``'s ``place`` (a tree of per-leaf callables; None
    restores numpy leaves). Across ranks ``state_gather`` and ``mesh``
    go to ``ckpt.save`` (``gather=``, ``mesh=``): every rank gathers,
    the mesh's first rank writes, and every rank restores its blocks
    from the one directory.
    """
    fail_at = set(fail_at or [])
    restarts = 0
    monitor = StragglerMonitor()

    state = None
    while True:
        try:
            start = ckpt.latest_step(ckpt_dir)
            if state is None:
                state = make_state()
                if start is not None:
                    state = ckpt.restore(ckpt_dir, start, state,
                                         place=state_place)
            step = start if start is not None else 0
            while step < total_steps:
                if step in fail_at:
                    fail_at.discard(step)
                    state = None               # simulate losing the node
                    raise InjectedFailure(f"injected at step {step}",
                                          mode=KILL_AT_STEP, step=step)
                t0 = time.perf_counter()
                state, metrics = train_step(state, batch_fn(step))
                monitor.observe(step, time.perf_counter() - t0)
                step += 1
                if on_metrics is not None:
                    on_metrics(step, metrics)
                if step % ckpt_every == 0 or step == total_steps:
                    ckpt.save(ckpt_dir, step, state, gather=state_gather,
                              mesh=mesh)
            return state, {"restarts": restarts,
                           "straggler": monitor.report()}
        except InjectedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            # the pre-failure EMA would judge the restore step against a
            # trajectory that no longer exists
            monitor.reset()
