"""Port vs JAX package: the runtime managers (heartbeats, stragglers,
failure injection, remesh).

``repro_torch.runtime.managers`` is a copy of the JAX package's pure-Python
module; each case of ``tests/test_runtime.py`` runs here on both modules
with the same inputs, and every observable output must be equal.
"""
import pytest

from repro.runtime import managers as jm
from repro_torch.runtime import managers as tm

BOTH = pytest.mark.parametrize("m", [tm, jm], ids=["port", "jax"])


def _trace(m, fn):
    """Run ``fn`` against module ``m``; the list of what it observed."""
    out = []
    fn(m, out.append)
    return out


def _same(fn):
    got = _trace(tm, fn)
    assert got == _trace(jm, fn)
    return got


def test_heartbeat_death_and_recovery():
    def run(m, see):
        clock = m.SimClock()
        mon = m.HeartbeatMonitor(clock, timeout=10.0)
        for w in ("a", "b", "c"):
            mon.register(w)
        clock.advance(5.0)
        mon.beat("a")
        clock.advance(7.0)
        see((mon.alive(), mon.dead(), mon.beat("a"), mon.beat("zz")))

    assert _same(run) == [(["a"], ["b", "c"], True, False)]


def test_beat_racing_deregister_does_not_resurrect():
    def run(m, see):
        mon = m.HeartbeatMonitor(m.SimClock(), timeout=10.0)
        mon.register("a")
        mon.deregister("a")
        see((mon.beat("a"), mon.alive(), mon.dead()))
        mon.register("a")
        see((mon.beat("a"), mon.alive()))

    assert _same(run) == [(False, [], []), (True, ["a"])]


def test_alive_dead_timeout_equality_boundary():
    def run(m, see):
        clock = m.SimClock()
        mon = m.HeartbeatMonitor(clock, timeout=10.0)
        mon.register("a")
        clock.advance(10.0)
        see((mon.alive(), mon.dead()))
        clock.advance(1e-9)
        see((mon.alive(), mon.dead()))

    assert _same(run) == [(["a"], []), ([], ["a"])]


def test_clock_refuses_to_go_backwards():
    for m in (tm, jm):
        clock = m.SimClock(3.0)
        assert clock.advance(0.5) == 3.5
        with pytest.raises(ValueError, match="backwards"):
            clock.advance(-1.0)


def test_straggler_policy_split_and_quorum():
    def run(m, see):
        pol = m.StragglerPolicy(deadline=3.0, quorum_fraction=0.5)
        see(pol.split({"w0": 1.0, "w1": 2.5, "w2": 9.0, "w3": 3.0},
                      round_start=0.0))
        see([pol.quorum_met(r, n) for r, n in ((3, 4), (1, 4), (1, 1),
                                               (2, 4), (0, 0))])

    assert _same(run)[0] == (["w0", "w1", "w3"], ["w2"])


@pytest.mark.parametrize("schedule,steps", [
    ({3: ["b"], 5: [("recover", "b")]}, (1, 3, 5)),
    ({1: [("recover", "newbie")]}, (1,)),
    ({1: ["ghost"]}, (1,)),
    ({1: [("flap", "b", 2.0), ("center_crash", 1)], 2: [("recover", "b")]},
     (1, 2)),
])
def test_failure_injector_apply(schedule, steps):
    """Kill and recover, a join by ``recover``, the kill of an unknown
    worker, and a flap that degrades to a crash against a bare monitor."""
    def run(m, see):
        mon = m.HeartbeatMonitor(m.SimClock(), timeout=10.0)
        for w in ("a", "b"):
            mon.register(w)
        inj = m.FailureInjector(schedule)
        for step in steps:
            see((inj.apply(step, mon), mon.alive()))

    assert _same(run)


@BOTH
def test_failure_injector_normalize_vocabulary(m):
    norm = m.FailureInjector.normalize
    assert norm("a") == ("crash", "a")
    assert norm(("recover", "a")) == ("recover", "a")
    assert norm(["flap", "a", 2.0]) == ("flap", "a", 2.0)
    assert norm(("center_midround", 2)) == ("center_midround", 2)
    for bad in (("explode", "a"), ()):
        with pytest.raises(ValueError, match="unknown chaos event"):
            norm(bad)
    assert tm.EVENT_KINDS == jm.EVENT_KINDS


def test_plan_remesh_preserves_tp():
    def run(m, see):
        for avail, tp, max_dp in ((512, 16, None), (495, 16, None),
                                  (495, 16, 8)):
            plan = m.plan_remesh(avail, tp=tp, max_dp=max_dp)
            see((plan.dp, plan.tp, plan.devices, plan.dropped_workers))

    assert _same(run)[:2] == [(32, 16, 512, 0), (30, 16, 480, 15)]
    for m in (tm, jm):
        with pytest.raises(RuntimeError):
            m.plan_remesh(7, tp=16)
        with pytest.raises(ValueError):
            m.plan_remesh(7, tp=0)
