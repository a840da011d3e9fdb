"""Runtime privacy audit: reconcile the ledger against the certified census.

The port's counterpart of the JAX package's ``obs/audit.py``.  The gate
(:mod:`repro_torch.analysis`) certifies, per driver spec, one run of the
round in which every protect and declassification is a call of a named
boundary.  The runtime ledger (:mod:`repro_torch.obs.ledger`) counts every
call of those boundaries.  This module closes the loop:

1. **Census** — the certified run's boundary calls, keyed ``(site,
   shape)`` (``GateTrace.round_census``, the JAX package's
   ``graph_census``); a scan block's executed slots fold into one round's
   census, as JAX counts a scan body once.
2. **Recorded counts** — the spec's round run again, ungated, under
   :func:`repro_torch.obs.ledger.capture`.
3. **Reconcile** — for every key the recorded count must EQUAL the
   census times the rounds run.  Anything extra the process did (e.g. a
   host-level reveal of one institution's buffer — see
   :func:`extra_reveal_fixture`) fires the ledger hook and surfaces as a
   count mismatch: a finding.

The port runs eagerly, so the ledger counts executions, where the JAX
package's counts trace-time calls; a round executed R times records R
times its census.  What the audit certifies is: *every declassification
this process performed is a call of a gate-certified round, in the
expected multiplicity.*

Loaded behind the CLI (``python -m repro_torch.obs audit``), tests and
``chip_smoke.py`` only — never by the obs core modules the drivers
import.
"""
from __future__ import annotations

import dataclasses
from collections import Counter

import torch

from . import ledger

__all__ = ["audit_spec", "extra_reveal_fixture", "recorded_census",
           "reconcile", "run_audit", "site_totals", "AuditResult",
           "SpecAudit"]


def recorded_census(cap: ledger.Capture) -> dict:
    """Fold captured ledger counts to the census key (site, shape)."""
    out: Counter = Counter()
    for (site, _what, shape, _thr), n in cap.counts.items():
        out[(site, tuple(shape))] += n
    return dict(out)


def site_totals(*censuses) -> dict:
    """Counts keyed ``(site, shape)``, summed over shapes (and over every
    census given) to ``site -> n``."""
    out: Counter = Counter()
    for census in censuses:
        for (site, _shape), n in census.items():
            out[site] += n
    return dict(out)


@dataclasses.dataclass
class SpecAudit:
    """One spec's reconciliation result."""

    name: str
    census: dict  # (site, shape) -> n in one certified round
    rounds: int  # rounds each run executes
    recorded: dict  # (site, shape) -> n from the runtime ledger
    ranks: int = 1  # ranks that reconciled (a world spec: every rank)

    @property
    def expected(self) -> dict:
        return {k: n * self.rounds for k, n in self.census.items()}

    @property
    def ok(self) -> bool:
        return self.expected == self.recorded

    def findings(self) -> list[str]:
        out = []
        expected = self.expected
        for key in sorted(set(expected) | set(self.recorded)):
            e = expected.get(key, 0)
            r = self.recorded.get(key, 0)
            if e != r:
                site, shape = key
                out.append(
                    f"{self.name}: {site}{list(shape)} executed {r}x, "
                    f"certified census {self.census.get(key, 0)} x "
                    f"{self.rounds} round(s) = {e} — "
                    + ("UNCERTIFIED declassification" if r > e
                       else "certified site never executed"))
        return out


def reconcile(name: str, census: dict, rounds: int, cap: ledger.Capture
              ) -> SpecAudit:
    """A captured run of ``rounds`` rounds against one round's census."""
    return SpecAudit(name, dict(census), rounds, recorded_census(cap))


def audit_spec(spec, device=None) -> SpecAudit:
    """Reconcile one DriverSpec: the census of its certified run against
    an ungated run under the ledger.  A world spec must run on every rank,
    under ``use_mesh`` of its mesh."""
    from ..analysis.drivers import certify

    _, trace = certify(spec, device)
    census, rounds, _ = trace.round_census()
    with ledger.capture() as cap:
        spec.runner(device)
    return reconcile(spec.name, census, rounds, cap)


def extra_reveal_fixture(spec, device=None) -> SpecAudit:
    """A deliberately leaky run the audit MUST flag (self-test).

    Runs the spec's certified round, then performs the classic
    coordinator attack: a host-level :func:`_reveal_flat` of a protected
    buffer that never went through Algorithm 2's aggregation.  The
    ledger hook fires, the recorded count exceeds the certified census,
    and the audit reports an UNCERTIFIED declassification.
    """
    from .._device import resolve_device
    from ..analysis.drivers import _aggregator, _generator, certify
    from ..core.collective import _reveal_flat

    dev = resolve_device(device)
    _, trace = certify(spec, dev)
    census, rounds, _ = trace.round_census()
    with ledger.capture() as cap:
        spec.runner(dev)
        # ---- the attack: peek at one submission's share stack ----------
        agg = _aggregator()
        prot = agg.protect(_generator(dev, 1),
                           {"gradient": torch.arange(4.0, device=dev)})
        t = agg.scheme.threshold
        _reveal_flat(prot.buf[:t], agg.scheme, agg.codec.frac_bits,
                     tuple(range(1, t + 1)))
    return reconcile(spec.name + "+extra_reveal", census, rounds, cap)


@dataclasses.dataclass
class AuditResult:
    """The whole audit: per-spec reconciliations + the leak self-test."""

    specs: list
    fixture: SpecAudit | None = None

    @property
    def ok(self) -> bool:
        clean = all(s.ok for s in self.specs)
        # the self-test must FAIL reconciliation, or the audit is blind
        armed = self.fixture is None or not self.fixture.ok
        return clean and armed

    def total_by_site(self) -> dict:
        return site_totals(*(s.recorded for s in self.specs))

    def lines(self) -> list[str]:
        out = []
        for s in self.specs:
            summary = " ".join(
                f"{site}={n}" for site, n in
                sorted(site_totals(s.recorded).items())
            ) or "no boundaries"
            ranks = f", {s.ranks} ranks" if s.ranks > 1 else ""
            out.append(f"{'OK' if s.ok else 'MISMATCH'}    {s.name}  "
                       f"[{summary}; {s.rounds} round(s){ranks}]")
            out.extend(f"  [finding] {f}" for f in s.findings())
        if self.fixture is not None:
            if self.fixture.ok:
                out.append(
                    "BLIND   extra-reveal self-test was NOT flagged — "
                    "the runtime audit cannot see host-level reveals")
            else:
                out.append(f"FLAGGED {self.fixture.name} "
                           "(the deliberate leak was caught)")
                out.extend(f"  [finding] {f}"
                           for f in self.fixture.findings())
        out.append(f"audit: {'PASS' if self.ok else 'FAIL'} "
                   f"({sum(s.ok for s in self.specs)} of {len(self.specs)} "
                   "drivers reconciled)")
        return out

    def to_dict(self) -> dict:
        def keyed(d):
            return {f"{site}{list(shape)}": n for (site, shape), n in
                    d.items()}

        def spec_dict(s):
            return {"name": s.name, "ok": s.ok, "rounds": s.rounds,
                    "ranks": s.ranks,
                    "census": keyed(s.census),
                    "expected": keyed(s.expected),
                    "recorded": keyed(s.recorded),
                    "findings": s.findings()}

        return {
            "ok": self.ok,
            "specs": [spec_dict(s) for s in self.specs],
            "fixture": (spec_dict(self.fixture)
                        if self.fixture is not None else None),
            "total_by_site": self.total_by_site(),
        }


def _world_audit(name: str, per_rank: list) -> SpecAudit:
    """One SpecAudit for a world spec: rank 0's, unless a rank failed to
    reconcile (then the first such rank's, named by its rank)."""
    audits = [r["audit"] for r in per_rank]
    bad = [(i, a) for i, a in enumerate(audits) if not a.ok]
    if bad:
        i, a = bad[0]
        a.name = f"{name}@rank{i}"
        return a
    audits[0].ranks = len(audits)
    return audits[0]


def run_audit(drivers: list[str] | None = None, with_fixture: bool = True,
              device=None) -> AuditResult:
    """Audit every (matching) driver spec on ``device`` (default: the
    card; world specs on spawned gloo ranks) and arm the leak self-test."""
    from .._device import resolve_device
    from ..analysis.drivers import all_driver_specs, run_world

    dev = resolve_device(device)
    specs = all_driver_specs()
    if drivers:
        specs = [s for s in specs if any(p in s.name for p in drivers)]
    world = [s for s in specs if s.world]
    by_name = {name: _world_audit(name, per_rank) for name, per_rank in
               (run_world(world, dev).items() if world else ())}
    for s in specs:
        if not s.world:
            by_name[s.name] = audit_spec(s, dev)
    fixture = None
    local = [s for s in specs if not s.world]
    if with_fixture and local:
        fixture = extra_reveal_fixture(local[0], dev)
    return AuditResult([by_name[s.name] for s in specs], fixture)
