"""Fault-tolerant round supervision for the secure protocol drivers.

The paper's setting is a long-running multi-institution consortium, where
institutions going offline, lagging past a deadline, or a Computation
Center crashing mid-study are the NORMAL case.  The drivers themselves
fail loud and clean — ``cohort()``/``live_centers()`` raise and leave
state untouched — and this module supplies the policy layer that turns
those hard failures into waits, retries, degradation and re-provisioning:
a ``RoundSupervisor`` drives ``StudyCoordinator``, ``SecureFitDriver``
(the stepwise ``secure_fit``) and ``SelectionCoordinator`` rounds through
the existing ``SimClock``/``HeartbeatMonitor``/``StragglerPolicy``
machinery under a declarative ``FaultPolicy``.

Fault model
===========

==============================  ==============================  ==========================================  =========================================
failure class                   detection                       policy                                      guarantee
==============================  ==============================  ==========================================  =========================================
institution straggler burst     round deadline (simulated       excluded from the round (Eqs. 4-6 sum       Newton step on the responding cohort is
                                latency vs deadline)            over responders); below quorum the round    a valid ascent step; the converged fixed
                                                                waits with exponential backoff              point is unchanged by transient exclusion
institution transient flap      missed heartbeats -> monitor    treated as straggler until declared dead,   rounds resume with the returned party;
                                declares dead after timeout     then excluded; retry/backoff below quorum   its folds/summaries re-enter untouched
institution crash (fail-stop)   explicit failure notice         excluded immediately; a ``recover`` event   study completes on the surviving cohort
                                (heartbeat deregister)          re-admits it (or a new member joins)        (>= min_responders/quorum)
center crash (between rounds)   liveness scan before the round  reveal from surviving >= t points;          revealed aggregate bit-identical (any
                                                                re-provision a replacement at a fresh       t-subset reconstructs the same field
                                                                evaluation point after repeated failures    element); replacement learns nothing
                                                                                                            about past rounds (fresh polynomials)
center death protect->reveal    post-protect liveness re-check  >= t survivors: reveal from survivors;      survivor reveal is bit-identical;
                                (mid-round hooks)               below t: abort the round, back off, retry   aborted round leaves fit state untouched
                                                                re-shares with fresh polynomials            and reveals nothing (< t shares are
                                                                                                            information-theoretically void)
coordinator crash               process death (external)        ``state_dict`` checkpoint -> fresh driver   bit-identical replay: same rng stream,
                                                                ``load_state_dict`` resume                  same trace floats, same final beta
unsurvivable (< t centers       retry budget exhausted          the FINAL attempt always calls the driver,  fail loud with the driver's exact
forever, quorum never met)                                      so its exact ``RuntimeError`` propagates    ``RuntimeError``; driver state unmutated
==============================  ==============================  ==========================================  =========================================

The chaos invariant (pinned by ``tests/test_torch_supervisor.py`` across
all three drivers, as ``tests/test_supervisor.py`` pins it for the JAX
package): **any survivable ``FailureInjector`` schedule converges
to the fault-free oracle's beta within fixed-point quantization.**  Two
protocol facts make this hold exactly rather than approximately: the
revealed aggregate is independent of the sharing randomness (so aborted
attempts that consumed rng splits cannot perturb the revealed values),
and reconstruction from ANY >= t evaluation points is the same field
element (so degraded reveals and re-provisioned point sets are
bit-identical to full-strength rounds over the same cohort).  For the
iterative drivers a transiently-shrunk cohort doesn't move the Newton
fixed point, so institution faults that heal before convergence are also
oracle-exact.  The one-pass selection sweep is the qualified case:
center faults are bit-identical as above, but an institution missing
during a λ chunk is *by design* absent from that chunk's CV sums
(responders-only semantics, folds untouched for its return), so
selection oracle-parity is asserted for schedules whose institution
faults heal between chunks.

This module is the port of the JAX package's ``runtime/supervisor.py``.
It imports neither torch nor JAX and is driver-agnostic: the three
drivers are adapted by duck type (``step_chunk`` -> selection,
``centers`` -> coordinator, ``centers_online`` -> secure-fit driver), so
``runtime`` keeps zero imports from ``core``/``selection``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from ..obs import metrics as _metrics
from ..obs.trace import span as _span, traced as _traced
from .managers import (
    FailureInjector,
    HeartbeatMonitor,
    SimClock,
    StragglerPolicy,
)

__all__ = ["FaultPolicy", "RoundSupervisor", "SupervisedRound"]


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Declarative knobs for one study's fault handling.

    A round gets ``1 + max_retries`` attempts.  Before each attempt the
    supervisor advances heartbeats and checks quorum/threshold
    preflight; a failed or infeasible attempt backs off
    ``backoff_base * backoff_factor**attempt`` simulated seconds (the
    wait during which flapped parties heal and heartbeats expire).  The
    LAST attempt always calls into the driver so a genuinely
    unsurvivable schedule surfaces the driver's own ``RuntimeError``.
    """

    max_retries: int = 4
    backoff_base: float = 1.0
    backoff_factor: float = 2.0
    # simulated duration of one successful round (clock advance on success)
    round_seconds: float = 1.0
    heartbeat_timeout: float = 5.0
    straggler: StragglerPolicy = StragglerPolicy(
        deadline=2.0, quorum_fraction=0.5
    )
    # replace dead centers with fresh ones after this many failed attempts
    # in a round (0 disables re-provisioning)
    reprovision_after: int = 1

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_base < 0 or self.backoff_factor < 1.0:
            raise ValueError("backoff must be non-negative, non-shrinking")


@dataclasses.dataclass
class SupervisedRound:
    """Audit record for one supervised round (success or propagated fail)."""

    round_no: int
    attempts: int
    retries: int
    aborted_attempts: int
    backoff_seconds: float
    degraded: bool
    events: list
    suspected_dead: list
    report: object | None


# -- driver adapters ----------------------------------------------------------
#
# One tiny facade per driver so the supervisor loop speaks a single
# interface: institution liveness by NAME, center liveness by evaluation
# POINT, one `attempt()` that either returns a report or raises the
# driver's RuntimeError, and `finished()`/`finalize()`.


class _CoordinatorAdapter:
    """``core.protocol.StudyCoordinator``."""

    def __init__(self, coord):
        self.c = coord

    def _inst(self, name):
        for inst in self.c.institutions:
            if inst.name == name:
                return inst
        raise KeyError(f"unknown institution {name!r}")

    def institution_names(self):
        return [i.name for i in self.c.institutions]

    def set_online(self, name, up):
        self._inst(name).online = bool(up)

    def get_latency(self, name):
        return self._inst(name).latency

    def set_latency(self, name, latency):
        self._inst(name).latency = float(latency)

    def default_deadline(self, deadline):
        if self.c.deadline is None:
            self.c.deadline = deadline

    def num_live(self):
        return sum(1 for i in self.c.institutions if i.online)

    def num_responding(self):
        dl = self.c.deadline
        return sum(
            1 for i in self.c.institutions
            if i.online and (dl is None or i.latency <= dl)
        )

    def needs_centers(self):
        return self.c.protect != "none"

    def threshold(self):
        return self.c.agg.scheme.threshold

    def num_points(self):
        return len(self.c.centers)

    def live_center_count(self):
        return sum(1 for c in self.c.centers if c.online)

    def set_center_online(self, index, up):
        for c in self.c.centers:
            if c.index == index:
                c.online = bool(up)
                return
        raise KeyError(f"no center at evaluation point {index}")

    def dead_center_indices(self):
        return [c.index for c in self.c.centers if not c.online]

    def provision_center(self, index=None):
        return self.c.provision_center(index)

    def arm_midround(self, index):
        self.c._midround_hooks.append(
            lambda: self.set_center_online(index, False)
        )

    def rounds_done(self):
        return self.c.iteration

    def attempt(self):
        return self.c.step()

    def finished(self):
        return bool(self.c.converged)

    def finalize(self):
        return self.c.beta.detach().cpu().numpy()


class _SecureFitAdapter(_CoordinatorAdapter):
    """``core.newton.SecureFitDriver`` (same vocabulary, list storage)."""

    def institution_names(self):
        return list(self.c.names)

    def set_online(self, name, up):
        self.c.set_online(name, up)

    def get_latency(self, name):
        return self.c.get_latency(name)

    def set_latency(self, name, latency):
        self.c.set_latency(name, latency)

    def num_live(self):
        return sum(1 for up in self.c.online if up)

    def num_responding(self):
        dl = self.c.deadline
        return sum(
            1 for up, lat in zip(self.c.online, self.c.latency)
            if up and (dl is None or lat <= dl)
        )

    def num_points(self):
        return len(self.c.centers_online)

    def live_center_count(self):
        return sum(1 for up in self.c.centers_online if up)

    def set_center_online(self, index, up):
        self.c.set_center_online(index, up)

    def dead_center_indices(self):
        return [
            i + 1 for i, up in enumerate(self.c.centers_online) if not up
        ]

    def provision_center(self, index=None):
        # the in-process driver has no center objects to replace: a
        # "replacement" is simply the evaluation point coming back up
        # (next round's shares are cut fresh against it)
        dead = self.dead_center_indices()
        if index is None:
            if not dead:
                raise RuntimeError("no dead center to replace")
            index = dead[0]
        self.c.set_center_online(index, True)
        return index

    def arm_midround(self, index):
        self.c._midround_hooks.append(
            lambda: self.c.set_center_online(index, False)
        )

    def rounds_done(self):
        return self.c.iteration

    def attempt(self):
        return self.c.step()

    def finished(self):
        return bool(self.c.converged)

    def finalize(self):
        return self.c.result()


class _SelectionAdapter(_CoordinatorAdapter):
    """``selection.SelectionCoordinator`` — one "round" = one λ chunk."""

    def __init__(self, sel):
        super().__init__(sel.study)
        self.s = sel

    def arm_midround(self, index):
        self.s.study._midround_hooks.append(
            lambda: self.set_center_online(index, False)
        )

    def rounds_done(self):
        return self.s.next_chunk

    def attempt(self):
        self.s.step_chunk()
        return None

    def finished(self):
        return self.s.finished()

    def finalize(self):
        # builds the PathReport (idempotent when already finished) and
        # surfaces the refit beta on the wrapped study
        return self.s.run_path()


def _adapt(driver):
    if hasattr(driver, "step_chunk"):
        return _SelectionAdapter(driver)
    if hasattr(driver, "centers_online"):
        return _SecureFitAdapter(driver)
    if hasattr(driver, "centers"):
        return _CoordinatorAdapter(driver)
    raise TypeError(
        f"don't know how to supervise {type(driver).__name__}; expected a "
        "StudyCoordinator, SecureFitDriver or SelectionCoordinator"
    )


class RoundSupervisor:
    """Drive a secure protocol driver round by round under a FaultPolicy.

    The supervisor owns the simulated control plane: a ``SimClock``, a
    ``HeartbeatMonitor`` fed by the parties that are currently beating,
    and a deterministic ``FailureInjector`` schedule keyed by ROUND
    number (events fire as the round opens).  Each round:

    1. apply the round's chaos events (crash/flap/straggle/center_*);
    2. up to ``1 + max_retries`` attempts: fire due self-heal timers,
       advance heartbeats, sync institution liveness from the monitor,
       preflight quorum/threshold, and call the driver; an infeasible
       preflight or a driver ``RuntimeError`` backs off exponentially
       (optionally re-provisioning dead centers) and retries — the
       final attempt always calls the driver so unsurvivable schedules
       propagate its exact error;
    3. on success, stamp the retry/backoff/degraded telemetry into the
       driver's ``RoundReport`` and advance the clock by
       ``round_seconds``.

    Determinism: everything is keyed off the SimClock and the schedule —
    no wall-clock, no randomness — so a given (driver seed, schedule,
    policy) triple always produces the same betas, the same retry
    counts, and the same backoff times.

    Scan-resident drivers (``rounds="scan"``): one supervised round is
    one SCAN BLOCK of ``rounds_per_sync`` Newton rounds — the driver's
    ``step()`` runs the whole block with one trace read-back, so chaos
    events land at block boundaries (a ``center_midround`` hook fires
    as the block starts) and ``max_rounds`` caps blocks, not Newton
    rounds.  A failed block mutates no driver state, so the retry
    re-enters at the SAME block; round r draws its sharing polynomials
    from ``SecureCollective.round_key(seed, r)`` by absolute round
    index, which makes the retried block — and any post-crash
    ``state_dict`` resume — bit-identical to an uninterrupted run.
    """

    def __init__(
        self,
        driver,
        policy: FaultPolicy | None = None,
        injector: FailureInjector | None = None,
        clock: SimClock | None = None,
    ):
        self.policy = policy or FaultPolicy()
        self.driver = _adapt(driver)
        self.clock = clock or SimClock()
        self.injector = injector or FailureInjector()
        self.monitor = HeartbeatMonitor(
            self.clock, timeout=self.policy.heartbeat_timeout
        )
        # give deadline-less drivers the policy's straggler deadline so
        # latency events actually have protocol meaning
        self.driver.default_deadline(self.policy.straggler.deadline)
        self._beating: set[str] = set()
        self._base_latency: dict[str, float] = {}
        self._timers: list[tuple[float, int, Callable[[], None]]] = []
        self._tseq = 0
        # resume support: a reloaded driver continues at its own round
        # count, so schedule keys keep their absolute meaning
        self.round_no = int(self.driver.rounds_done())
        self.rounds: list[SupervisedRound] = []
        self.total_retries = 0
        self.total_backoff = 0.0
        self._admit_new_parties()

    # -- control plane -------------------------------------------------------
    def _admit_new_parties(self):
        """Register parties the supervisor hasn't seen (incl. mid-study
        joins via ``add_institution``) and remember their base latency."""
        for name in self.driver.institution_names():
            if name not in self._base_latency:
                self._base_latency[name] = self.driver.get_latency(name)
                self.monitor.register(name)
                self._beating.add(name)

    def _schedule_timer(self, due: float, fn: Callable[[], None]):
        self._tseq += 1
        self._timers.append((due, self._tseq, fn))
        self._timers.sort()

    def _fire_due_timers(self):
        now = self.clock.now()
        due = [t for t in self._timers if t[0] <= now]
        self._timers = [t for t in self._timers if t[0] > now]
        for _, _, fn in due:
            fn()

    def _heartbeat_sync(self):
        """Beat for live parties; sync driver liveness from the monitor."""
        self._admit_new_parties()
        names = self.driver.institution_names()
        for name in sorted(self._beating):
            self.monitor.beat(name)
        alive = set(self.monitor.alive())
        for name in names:
            self.driver.set_online(name, name in alive)

    def _revive(self, name):
        """Self-heal after a flap: resume beating at base latency."""
        self._beating.add(name)
        self.monitor.register(name)
        self.driver.set_latency(name, self._base_latency.get(name, 0.0))

    def _apply_event(self, ev):
        kind, *args = FailureInjector.normalize(ev)
        if kind == "crash":
            name = ev if isinstance(ev, str) else args[0]
            self._beating.discard(name)
            self.monitor.deregister(name)  # explicit failure notice
            self.driver.set_online(name, False)
            self.driver.set_latency(name, float("inf"))
        elif kind == "recover":
            name = args[0]
            self._revive(name)
            self.driver.set_online(name, True)
        elif kind == "flap":
            name, duration = args[0], float(args[1])
            # transient outage: stops beating (declared dead only after
            # the heartbeat timeout) and misses every deadline meanwhile
            self._beating.discard(name)
            self.driver.set_latency(name, float("inf"))
            self._schedule_timer(
                self.clock.now() + duration,
                lambda n=name: self._revive(n),
            )
        elif kind == "straggle":
            name, latency, duration = args[0], float(args[1]), float(args[2])
            # keeps beating — alive but late; excluded by the deadline rule
            self.driver.set_latency(name, latency)
            self._schedule_timer(
                self.clock.now() + duration,
                lambda n=name: self.driver.set_latency(
                    n, self._base_latency.get(n, 0.0)
                ),
            )
        elif kind == "center_crash":
            self.driver.set_center_online(int(args[0]), False)
        elif kind == "center_recover":
            self.driver.set_center_online(int(args[0]), True)
        elif kind == "center_midround":
            self.driver.arm_midround(int(args[0]))
        elif kind == "provision_center":
            self.driver.provision_center(
                int(args[0]) if args else None
            )

    # -- the supervised round ------------------------------------------------
    def _preflight_ok(self) -> bool:
        live = self.driver.num_live()
        if live == 0:
            return False
        if not self.policy.straggler.quorum_met(
            self.driver.num_responding(), live
        ):
            return False
        if (self.driver.needs_centers()
                and self.driver.live_center_count()
                < self.driver.threshold()):
            return False
        return True

    def _reprovision_dead_centers(self):
        for _ in self.driver.dead_center_indices():
            self.driver.provision_center()

    @_traced("round")
    def step(self) -> SupervisedRound:
        """One supervised round: events -> attempts -> telemetry.

        Raises the driver's own ``RuntimeError`` when the retry budget
        is exhausted on an unsurvivable state (driver state unmutated).
        """
        pol = self.policy
        self.round_no += 1
        events = self.injector.events_at(self.round_no)
        for ev in events:
            self._apply_event(ev)

        retries = 0
        aborted = 0
        backoff = 0.0
        report = None
        attempts = 0
        for attempt in range(pol.max_retries + 1):
            self._fire_due_timers()
            self._heartbeat_sync()
            final = attempt == pol.max_retries
            if final or self._preflight_ok():
                attempts += 1
                try:
                    report = self.driver.attempt()
                    break
                except RuntimeError:
                    aborted += 1
                    if final:
                        raise
            # infeasible or failed: re-provision (if due) and back off
            if (pol.reprovision_after
                    and attempt + 1 >= pol.reprovision_after):
                self._reprovision_dead_centers()
            wait = pol.backoff_base * pol.backoff_factor ** attempt
            with _span("retry", "RoundSupervisor.backoff",
                       round_no=self.round_no, attempt=attempt,
                       backoff_s=wait):
                self.clock.advance(wait)
            retries += 1
            backoff += wait

        degraded = bool(
            retries
            or aborted
            or (report is not None and getattr(report, "stragglers", None))
            or self.driver.dead_center_indices()
        )
        if report is not None and hasattr(report, "retries"):
            report.retries = retries
            report.backoff_seconds = backoff
            report.aborted_attempts = aborted
            report.degraded = degraded
        self.total_retries += retries
        self.total_backoff += backoff
        if retries:
            _metrics.inc("repro_retries_total", retries)
        if aborted:
            _metrics.inc("repro_aborted_attempts_total", aborted)
        record = SupervisedRound(
            round_no=self.round_no,
            attempts=attempts,
            retries=retries,
            aborted_attempts=aborted,
            backoff_seconds=backoff,
            degraded=degraded,
            events=[FailureInjector.normalize(e) for e in events],
            suspected_dead=self.monitor.dead(),
            report=report,
        )
        self.rounds.append(record)
        self.clock.advance(pol.round_seconds)
        return record

    def run(self, max_rounds: int = 100):
        """Supervise rounds until the driver finishes (or the cap).

        Returns the driver's final artifact: the converged beta for a
        ``StudyCoordinator``, a ``FitResult`` for a ``SecureFitDriver``,
        the ``PathReport`` for a ``SelectionCoordinator``.
        """
        while not self.driver.finished() and self.round_no < max_rounds:
            self.step()
        return self.driver.finalize()
