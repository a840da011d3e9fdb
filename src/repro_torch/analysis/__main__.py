"""The standing gate: ``python -m repro_torch.analysis``.

Runs, in order:

1. the taint interpreter and the per-run lints (host reads, mesh axes)
   over every certified driver spec (``drivers.all_driver_specs``); the
   psum specs on spawned gloo worlds of their meshes, every rank;
2. the source-level and config-level lints (host-sync AST pass,
   fixed-point headroom proof, the kernels' launch-knob budget, obs
   purity pass, collective boundary-ownership pass);
3. the leak fixtures (``fixtures.leak_fixture_specs``) — deliberately
   broken drivers the gate MUST flag; a fixture passing clean means the
   gate itself regressed.

Exit status 0 iff every driver/lint report is clean AND every fixture is
caught.  ``--device`` picks where the rounds run (default: the card);
``--verbose`` shows info findings and the declassification audit trail;
``--json`` emits machine-readable reports; ``--drivers`` filters specs by
substring (fixtures still run unless ``--no-fixtures``).
"""
from __future__ import annotations

import argparse
import json
import sys


def analyze_spec(spec, device=None, *, expect_leak: bool = False):
    """Certify one single-process spec and lint its run."""
    from .drivers import certify

    # leak fixtures get the taint pass alone: the finding it makes is the
    # one the negative control pins
    return certify(spec, device, lint=not expect_leak)[0]


def merge_ranks(name: str, per_rank: list):
    """One report for a world spec: every rank's findings (its taint pass
    and its run's lints) and declassifications."""
    from .report import AnalysisReport

    report = AnalysisReport(target=name)
    for r in per_rank:
        report.extend(r["report"].findings)
        for d in r["report"].declassifications:
            if d not in report.declassifications:
                report.declassifications.append(d)
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="privacy-flow taint interpreter + protocol lints",
    )
    parser.add_argument("--device", default=None,
                        help="where the certified rounds run (default: "
                             "cuda; pass cpu for a CPU run)")
    parser.add_argument("--drivers", default="",
                        help="only run driver specs containing SUBSTR")
    parser.add_argument("--verbose", action="store_true",
                        help="show info findings + declassification trail")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit reports as JSON")
    parser.add_argument("--no-fixtures", action="store_true",
                        help="skip the leak-fixture negative controls")
    args = parser.parse_args(argv)

    from .._device import resolve_device
    from .drivers import all_driver_specs, run_world
    from .fixtures import leak_fixture_specs
    from .lints import (SummaryBounds, lint_collective_sites, lint_headroom,
                        lint_host_sync, lint_kernel_knobs, lint_obs_purity)

    device = resolve_device(args.device)
    specs = [s for s in all_driver_specs() if args.drivers in s.name]
    by_name = {}
    world = [s for s in specs if s.world]
    if world:
        for name, per_rank in run_world(world, device, audit=False).items():
            by_name[name] = merge_ranks(name, per_rank)
    for spec in specs:
        if not spec.world:
            by_name[spec.name] = analyze_spec(spec, device)
    reports = [by_name[s.name] for s in specs]
    failed = not all(r.ok for r in reports)

    if not args.drivers:
        lint_reports = [
            lint_host_sync(),
            # deployment-shaped bounds: lane-aligned d, benchmark-scale
            # rows, a full cohort — the envelope every shipped config sits
            # inside
            lint_headroom(SummaryBounds(d=128, n_max=100_000, num_parts=16)),
            lint_kernel_knobs(),
            lint_obs_purity(),
            lint_collective_sites(),
        ]
        reports += lint_reports
        failed |= not all(r.ok for r in lint_reports)

    caught = []
    if not args.no_fixtures:
        for spec in leak_fixture_specs():
            rep = analyze_spec(spec, device, expect_leak=True)
            caught.append((rep, not rep.ok))
            failed |= rep.ok

    if args.as_json:
        print(json.dumps({
            "reports": [r.to_dict() for r in reports],
            "fixtures": [{"caught": was_caught, **r.to_dict()}
                         for r, was_caught in caught],
            "ok": not failed,
        }, indent=2))
        return 1 if failed else 0

    for rep in reports:
        print(rep.format(verbose=args.verbose))
    for rep, was_caught in caught:
        if was_caught:
            errs = rep.errors()
            print(f"CAUGHT  {rep.target} ({len(errs)} error finding(s))")
            for f in errs if args.verbose else errs[:1]:
                print(f"  {f.format()}")
        else:
            print(f"MISSED  {rep.target} — the leak fixture passed the "
                  "gate: the gate has regressed")
    print(f"\ngate: {'FAIL' if failed else 'PASS'} "
          f"({len(specs)} drivers, {len(caught)} fixtures, on {device})")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
