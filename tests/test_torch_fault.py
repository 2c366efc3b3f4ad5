"""The port's fault tolerance (``runtime/fault.py``) against the
reference's (``repro/runtime/fault.py``).

Every unit case of the reference's ``tests/test_elastic.py:60-241``
(the lease protocol, the fault schedule, the straggler monitor and its
report-driven eviction) runs as one scenario through both packages on
the same inputs: the scenario records what each call returned, and the
detectors' events and reports, and the two records must be equal; the
reference's own assertions are then held on the port's record.
``run_with_restarts`` is held to the reference's counter state (one
restart, one straggler reset, the same final state), and resumes an
NS2D 32² solver (its state restored through ``ckpt`` into this rank's
blocks) bit-identically to the same run without a failure.
"""
import pytest
import torch

from repro.runtime import fault as ref_fault
from repro_torch.runtime import fault as port_fault


class FakeClock:
    """Settable clock for deterministic lease tests."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _raises(fn, exc):
    try:
        fn()
    except exc as err:
        return type(err).__name__
    return None


# each scenario: the fault module in, a record of what it did out


def lease_protocol(F):
    clk = FakeClock()
    det = F.FailureDetector(lease=1.0, max_misses=3, clock=clk)
    det.register(0)
    det.register(1)
    clk.t = 2.5
    det.heartbeat(0)                      # rank 0 renews; rank 1 silent
    v1 = det.poll()
    clk.t = 3.2                           # rank 1's lease is 3 periods old
    v2 = det.poll()
    return {"first": v1, "second": v2, "again": det.poll()["new_dead"],
            "dead": det.dead_ranks(), "alive": det.alive_ranks(),
            "report": det.report()}


def dead_heartbeat_ignored(F):
    clk = FakeClock()
    det = F.FailureDetector(lease=1.0, max_misses=2, clock=clk)
    det.register(3)
    clk.t = 5.0
    first = det.poll()["new_dead"]
    det.heartbeat(3)                      # late heartbeat from a ghost
    ghost = det.dead_ranks()
    det.register(3)                       # explicit rejoin
    rejoined = det.dead_ranks()
    det.heartbeat(3)
    return {"first": first, "ghost": ghost, "rejoined": rejoined,
            "after": det.poll()["new_dead"], "events": det.events}


def detector_guards(F):
    det = F.FailureDetector(lease=1.0, max_misses=1, clock=FakeClock())
    return {"unregistered": _raises(lambda: det.heartbeat(7), KeyError),
            "lease": _raises(lambda: F.FailureDetector(lease=0.0),
                             ValueError),
            "misses": _raises(lambda: F.FailureDetector(max_misses=0),
                              ValueError)}


def deregister_graceful(F):
    clk = FakeClock()
    det = F.FailureDetector(lease=1.0, max_misses=1, clock=clk)
    det.register(0)
    det.deregister(0)
    clk.t = 100.0
    return {"poll": det.poll(), "events": det.events}


def declare_dead_out_of_band(F):
    det = F.FailureDetector(clock=FakeClock())
    det.register(0)
    det.declare_dead(0, "operator drain")
    det.declare_dead(0, "again")          # idempotent, one event
    return {"dead": det.dead_ranks(), "events": det.events}


def eviction_needs_streak(F):
    det = F.FailureDetector(clock=FakeClock())
    det.register(0)
    det.register(1)
    slow = {"slow_ranks": [1]}
    got = [det.consume_straggler_report(slow), det.suspect_ranks(),
           det.consume_straggler_report({"slow_ranks": []}),
           det.suspect_ranks()]
    got += [det.consume_straggler_report(slow) for _ in range(4)]
    return {"got": got, "dead": det.dead_ranks(), "report": det.report()}


def schedule_rejects_unknown_mode(F):
    return {"raised": _raises(lambda: F.FaultSchedule(
                [F.InjectedFault(mode="meteor", step=0)]), ValueError),
            "modes": list(F.FAULT_MODES),
            "named": [F.KILL_AT_STEP, F.HEARTBEAT_DROP, F.SLOW_RANK]}


def kill_is_an_edge(F):
    sched = F.FaultSchedule([F.InjectedFault(mode=F.KILL_AT_STEP, step=5,
                                             rank=2)])
    sched.check_kill(4, rank=2)           # before: nothing
    sched.check_kill(5, rank=0)           # wrong rank: nothing
    try:
        sched.check_kill(5, rank=2)
        fired = None
    except F.InjectedFailure as err:
        fired = [err.mode, err.step, err.rank, str(err)]
    sched.check_kill(6, rank=2)           # a restart replays step 5
    return {"fired": fired}


def drop_window_and_slow_factor(F):
    sched = F.FaultSchedule([
        F.InjectedFault(mode=F.HEARTBEAT_DROP, step=3, rank=1, duration=2),
        F.InjectedFault(mode=F.SLOW_RANK, step=0, rank=0, slow_factor=4.0),
        F.InjectedFault(mode=F.SLOW_RANK, step=0, rank=0, slow_factor=2.0)])
    return {"drops": [sched.drops_heartbeat(s, r) for s in range(6)
                      for r in range(2)],
            "slow": [sched.slow_factor(s, r) for s in range(3)
                     for r in range(2)],
            "active": sorted(f.mode for f in sched.active(3))}


def straggler_reset(F):
    mon = F.StragglerMonitor(alpha=0.3, threshold=3.0)
    verdicts = [mon.observe(s, 0.1) for s in range(20)]
    verdicts.append(mon.observe(20, 5.0))     # the stale-EMA verdict
    mon.reset()
    reset = (mon.ema, mon.dev)
    verdicts += [mon.observe(21, 5.0), mon.observe(22, 5.2)]
    return {"verdicts": verdicts, "reset": reset, "report": mon.report()}


def rank_report_percentiles(F):
    mon = F.StragglerMonitor()
    for s in range(10):
        for r in range(4):
            mon.observe(s, 0.1 * (10.0 if r == 3 else 1.0), rank=r)
    return {"report": mon.rank_report(percentile=90.0, slow_factor=2.0),
            "empty": F.StragglerMonitor().rank_report()}


def rank_window_trims(F):
    mon = F.StragglerMonitor(window=8)
    for s in range(50):
        mon.observe(s, float(s), rank=0)
    kept = list(mon.rank_times[0])
    mon.reset()
    return {"kept": kept, "after_reset": mon.rank_times}


def report_feeds_eviction(F):
    mon = F.StragglerMonitor()
    det = F.FailureDetector(clock=FakeClock())
    for r in range(3):
        det.register(r)
    evicted = []
    for s in range(4):
        for r in range(3):
            mon.observe(s, 0.05 * (20.0 if r == 2 else 1.0), rank=r)
        evicted += det.consume_straggler_report(mon.rank_report())
    return {"evicted": evicted, "dead": det.dead_ranks(),
            "events": det.events}


SCENARIOS = [lease_protocol, dead_heartbeat_ignored, detector_guards,
             deregister_graceful, declare_dead_out_of_band,
             eviction_needs_streak, schedule_rejects_unknown_mode,
             kill_is_an_edge, drop_window_and_slow_factor, straggler_reset,
             rank_report_percentiles, rank_window_trims,
             report_feeds_eviction]


def _close(a, b):
    """Records equal, floats within a float64 ulp or two (numpy's
    percentile and median run the same arithmetic in both)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return a == pytest.approx(b, rel=1e-12, abs=0.0)
    return a == b


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_the_reference(scenario):
    port, ref = scenario(port_fault), scenario(ref_fault)
    assert _close(port, ref), (port, ref)


# the reference's assertions, on the port's records


def test_detector_lease_protocol():
    got = lease_protocol(port_fault)
    assert got["first"]["new_dead"] == []
    assert got["first"]["missed"] == {0: 0, 1: 2}
    assert got["second"]["new_dead"] == [1]
    assert got["dead"] == [1] and got["alive"] == [0]
    assert {"event": "dead", "rank": 1,
            "reason": "missed 3 heartbeats"} in got["report"]["events"]
    assert got["again"] == []             # the transition fires once


def test_detector_dead_heartbeat_ignored_until_rejoin():
    got = dead_heartbeat_ignored(port_fault)
    assert got["first"] == [3] and got["ghost"] == [3]
    assert got["rejoined"] == [] and got["after"] == []
    assert {"event": "rejoin", "rank": 3} in got["events"]


def test_detector_guards_and_graceful_leave():
    assert detector_guards(port_fault) == {
        "unregistered": "KeyError", "lease": "ValueError",
        "misses": "ValueError"}
    got = deregister_graceful(port_fault)
    assert got["poll"]["new_dead"] == [] and got["events"] == []
    got = declare_dead_out_of_band(port_fault)
    assert got["dead"] == [0]
    assert sum(e["event"] == "dead" for e in got["events"]) == 1


def test_detector_straggler_eviction_needs_consecutive_streak():
    got = eviction_needs_streak(port_fault)["got"]
    # one slow report is noise; a clean one breaks the streak; the third
    # consecutive evicts; the dead never re-evict
    assert got == [[], [1], [], [], [], [], [1], []]


def test_fault_schedule_modes_kills_and_windows():
    got = schedule_rejects_unknown_mode(port_fault)
    assert got["raised"] == "ValueError"
    assert set(got["modes"]) == set(got["named"])
    fired = kill_is_an_edge(port_fault)["fired"]
    assert fired[:3] == [port_fault.KILL_AT_STEP, 5, 2]
    got = drop_window_and_slow_factor(port_fault)
    drops = dict(zip([(s, r) for s in range(6) for r in range(2)],
                     got["drops"]))
    assert not drops[(2, 1)] and drops[(3, 1)] and drops[(4, 1)]
    assert not drops[(5, 1)] and not drops[(3, 0)]
    assert got["slow"][0] == 4.0 and got["slow"][1] == 1.0
    assert got["active"] == sorted([port_fault.HEARTBEAT_DROP,
                                    port_fault.SLOW_RANK, port_fault.SLOW_RANK])


def test_straggler_monitor_reset_report_and_window():
    got = straggler_reset(port_fault)
    assert got["verdicts"][20] is True and got["verdicts"][21:] == [False,
                                                                    False]
    assert got["reset"] == (None, 0.0)
    assert got["report"]["resets"] == 1
    assert any(e["step"] == 20 for e in got["report"]["slow_steps"])
    rep = rank_report_percentiles(port_fault)
    assert rep["report"]["slow_ranks"] == [3]
    assert rep["report"]["baseline_s"] == pytest.approx(0.1)
    assert rep["report"]["ranks"][3] == pytest.approx(1.0)
    assert rep["empty"]["slow_ranks"] == [] and \
        rep["empty"]["baseline_s"] is None
    got = rank_window_trims(port_fault)
    assert got["kept"] == [float(s) for s in range(42, 50)]
    assert got["after_reset"] == {}
    got = report_feeds_eviction(port_fault)
    assert got["evicted"] == [2] and got["dead"] == [2]
    assert any("straggler" in e.get("reason", "") for e in got["events"])


# ---------------------------------------------------------------------------
# run_with_restarts
# ---------------------------------------------------------------------------

def test_run_with_restarts_resets_straggler(tmp_path):
    """The reference's counter state (``test_elastic.py:241``): one
    restart, and the except branch's reset re-seeds the EMA once; the
    final state is the one eight steps give."""
    import jax.numpy as jnp
    ref_state, ref_rep = ref_fault.run_with_restarts(
        make_state=lambda: {"x": jnp.zeros(())},
        train_step=lambda state, batch: ({"x": state["x"] + batch}, {}),
        batch_fn=lambda step: jnp.asarray(1.0),
        total_steps=8, ckpt_dir=str(tmp_path / "ref"), ckpt_every=2,
        fail_at=[5])
    state, rep = port_fault.run_with_restarts(
        make_state=lambda: {"x": torch.zeros(())},
        train_step=lambda state, batch: ({"x": state["x"] + batch}, {}),
        batch_fn=lambda step: torch.tensor(1.0),
        total_steps=8, ckpt_dir=str(tmp_path / "port"), ckpt_every=2,
        state_place={"x": torch.from_numpy}, fail_at=[5])
    assert rep["restarts"] == ref_rep["restarts"] == 1
    assert rep["straggler"]["resets"] == ref_rep["straggler"]["resets"] == 1
    assert float(state["x"]) == float(ref_state["x"]) == 8.0
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref").iterdir())


def test_run_with_restarts_gives_up_past_max_restarts(tmp_path):
    with pytest.raises(port_fault.InjectedFailure):
        port_fault.run_with_restarts(
            make_state=lambda: {"x": torch.zeros(())},
            train_step=lambda s, b: ({"x": s["x"] + b}, {}),
            batch_fn=lambda step: torch.tensor(1.0), total_steps=6,
            ckpt_dir=str(tmp_path), ckpt_every=2, fail_at=[1, 3],
            max_restarts=1)


def test_ns2d_resume_after_injected_failure_is_bit_identical(tmp_path):
    """Resume equivalence with a solver as the state: an NS2D 32² run
    (the kernels' plain versions on the CPU) that loses its state at step
    5 restores step 4 from ``ckpt`` into this rank's blocks and replays;
    it ends bit-identical to the same run without a failure."""
    from repro_torch.compat import make_mesh
    from repro_torch.core.solver import NS2DSolver
    from repro_torch.tree_util import tree_map

    mesh = make_mesh((1,), ("data",), device="cpu")

    def solver():
        s = NS2DSolver((32, 32), mesh, nu=5e-3, dt=5e-3)
        s.init_random(seed=4)
        return s

    def run(ckpt_dir, fail_at):
        s = solver()
        energies = []

        def step(state, _batch):
            s.state = state
            s.step(1)
            return s.state, {"energy": s.energy()}
        place = tree_map(lambda _: s.basis.place_spectral, s.state)
        state, rep = port_fault.run_with_restarts(
            make_state=lambda: solver().state, train_step=step,
            batch_fn=lambda i: None, total_steps=8, ckpt_dir=ckpt_dir,
            ckpt_every=2, state_place=place, fail_at=fail_at,
            on_metrics=lambda i, m: energies.append((i, m["energy"])))
        return state, rep, energies

    failed, rep, energies = run(tmp_path / "failed", [5])
    straight, rep0, energies0 = run(tmp_path / "straight", None)
    assert (rep["restarts"], rep0["restarts"]) == (1, 0)
    assert rep["straggler"]["resets"] == 1
    for a, b in zip(failed, straight):
        assert torch.equal(a, b)
    # the replay of step 5 gives the energy the straight run had there
    assert dict(energies) == dict(energies0)
    assert [i for i, _ in energies] == [1, 2, 3, 4, 5, 5, 6, 7, 8]
