"""Fleet runtime managers: failure, straggler, elasticity — simulated clock.

The port's copy of the JAX package's ``runtime/managers.py``, with its
semantics unchanged (pure Python; no torch, no JAX).  Everything is
driven by an injectable ``SimClock`` so behaviour is deterministic and
testable without wall-clock sleeps; ``runtime.supervisor`` wires them
into the secure protocol drivers, and a deployment would replace
SimClock with real heartbeats.

Design notes for 1000+ nodes:

* **Heartbeats, not pings.** Workers push heartbeats; the monitor only scans
  its table (O(workers) per check, no network fan-out from the coordinator).
* **Straggler policy = deadline + quorum**, the same rule the paper's
  coordinator applies to institutions: a round proceeds when >= quorum
  workers have reported, stragglers' contributions are dropped for the round
  (grad-accumulation semantics make a dropped microbatch a smaller, still
  unbiased batch).
* **Elasticity by re-meshing from checkpoint**: when membership changes, we
  pick the largest (dp, tp) grid that fits the survivors while preserving
  the TP degree (param shardings stay valid), and the train loop restores from
  the latest checkpoint.  `plan_remesh` is pure and unit-tested.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = [
    "SimClock",
    "HeartbeatMonitor",
    "StragglerPolicy",
    "FailureInjector",
    "EVENT_KINDS",
    "plan_remesh",
    "RemeshPlan",
]


class SimClock:
    """Deterministic monotonically-advancing clock."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("time does not go backwards")
        self.t += dt
        return self.t


@dataclasses.dataclass
class HeartbeatMonitor:
    """Declares a worker dead after ``timeout`` without a heartbeat."""

    clock: SimClock
    timeout: float = 60.0
    _last: dict = dataclasses.field(default_factory=dict)

    def register(self, worker: str):
        self._last[worker] = self.clock.now()

    def beat(self, worker: str) -> bool:
        """Record a heartbeat; returns False for an unknown worker.

        A heartbeat racing a ``deregister`` (the packet was in flight when
        the coordinator dropped the worker) is normal fleet behaviour, not
        an error: the stale beat is dropped and the worker stays
        deregistered until it explicitly re-``register``s.
        """
        if worker not in self._last:
            return False
        self._last[worker] = self.clock.now()
        return True

    def deregister(self, worker: str):
        self._last.pop(worker, None)

    def alive(self) -> list[str]:
        # Boundary: a worker whose last beat is *exactly* ``timeout`` old is
        # still alive (<=); ``dead`` is its strict complement (>), so the two
        # lists always partition the registered set.
        now = self.clock.now()
        return sorted(
            w for w, t in self._last.items() if now - t <= self.timeout
        )

    def dead(self) -> list[str]:
        now = self.clock.now()
        return sorted(
            w for w, t in self._last.items() if now - t > self.timeout
        )


@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    """Deadline + quorum rule for one collective round."""

    deadline: float = 30.0  # seconds from round start
    quorum_fraction: float = 0.75  # fraction of live workers required

    def split(
        self, arrivals: dict[str, float], round_start: float
    ) -> tuple[list[str], list[str]]:
        """-> (responders, stragglers) by arrival time vs deadline."""
        resp = sorted(
            w for w, t in arrivals.items()
            if t - round_start <= self.deadline
        )
        lag = sorted(set(arrivals) - set(resp))
        return resp, lag

    def quorum_met(self, num_responders: int, num_live: int) -> bool:
        need = max(1, math.ceil(self.quorum_fraction * num_live))
        return num_responders >= need


# Chaos-event vocabulary understood by FailureInjector.normalize (and by
# runtime.supervisor.RoundSupervisor, which interprets the center/latency
# events against the secure-protocol drivers):
#
#   "name"                            legacy shorthand for ("crash", name)
#   ("crash", name)                   institution/worker fail-stop
#   ("recover", name)                 crashed/flapped party rejoins
#   ("flap", name, duration)          transient outage: stops heartbeating
#                                     and misses deadlines for ``duration``
#                                     sim-seconds, then self-heals
#   ("straggle", name, latency, duration)
#                                     straggler burst: responds after
#                                     ``latency`` sim-seconds (keeps
#                                     heartbeating) for ``duration``
#   ("center_crash", index)           computation center fail-stop
#   ("center_recover", index)         crashed center rejoins
#   ("center_midround", index)        center dies BETWEEN protect and reveal
#                                     of the next round (one-shot)
#   ("provision_center", [index])     operator-driven replacement center
EVENT_KINDS = (
    "crash", "recover", "flap", "straggle",
    "center_crash", "center_recover", "center_midround", "provision_center",
)


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule for chaos tests.

    ``schedule`` maps step -> iterable of chaos events (see ``EVENT_KINDS``
    above).  The legacy forms — a bare worker name meaning "kill", and
    ``("recover", name)`` — are still accepted everywhere.
    """

    schedule: dict = dataclasses.field(default_factory=dict)

    def events_at(self, step: int) -> list:
        return list(self.schedule.get(step, ()))

    @staticmethod
    def normalize(ev) -> tuple:
        """Canonicalize one schedule entry to a ``(kind, *args)`` tuple."""
        if isinstance(ev, str):
            return ("crash", ev)
        ev = tuple(ev)
        if not ev or ev[0] not in EVENT_KINDS:
            raise ValueError(f"unknown chaos event {ev!r}")
        return ev

    def apply(self, step: int, monitor: HeartbeatMonitor) -> list[str]:
        """Kill/recover per schedule against a bare heartbeat monitor;
        returns the names affected.

        This is the LM-loop entry point and only interprets worker-liveness
        events: ``crash``/``flap`` deregister (a flap degrades to a crash
        until its ``recover``), ``recover`` (re-)registers — including a
        worker never seen before, which is how a replacement node joins the
        fleet.  Center and latency events are no-ops here; the
        ``RoundSupervisor`` gives them meaning against protocol drivers.
        """
        hit = []
        for ev in self.events_at(step):
            kind, *args = self.normalize(ev)
            if kind == "recover":
                monitor.register(args[0])
                hit.append(args[0])
            elif kind in ("crash", "flap"):
                monitor.deregister(args[0])
                hit.append(args[0])
        return hit


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    dp: int
    tp: int
    dropped_workers: int

    @property
    def devices(self) -> int:
        return self.dp * self.tp


def plan_remesh(
    available_devices: int, tp: int, *, max_dp: int | None = None
) -> RemeshPlan:
    """Largest (dp, tp) grid fitting the survivors, preserving TP degree.

    TP degree is preserved because parameter shardings (and the collectives
    compiled against them) assume it; only the data-parallel extent shrinks.
    Raises when not even one TP group survives.
    """
    if tp <= 0:
        raise ValueError("tp must be positive")
    dp = available_devices // tp
    if dp < 1:
        raise RuntimeError(
            f"{available_devices} devices cannot host one tp={tp} group"
        )
    if max_dp is not None:
        dp = min(dp, max_dp)
    return RemeshPlan(dp=dp, tp=tp,
                      dropped_workers=available_devices - dp * tp)
