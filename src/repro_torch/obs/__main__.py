"""Observability CLI: ``python -m repro_torch.obs <subcommand>``.

Subcommands
-----------

``audit``
    Reconcile the runtime privacy ledger against the gate's certified
    census for every driver spec (the psum specs on spawned gloo ranks),
    then arm the extra-reveal self-test (a deliberate host-level leak that
    MUST be flagged).  Exit 0 iff every spec reconciles AND the self-test
    fires.  ``--device`` picks where the rounds run (default: the card).

``summary``
    Render a recorded span JSONL file (``--trace``) as the per-kind
    summary table without re-running anything.
"""
from __future__ import annotations

import argparse
import json
import sys


def _cmd_audit(args) -> int:
    from . import audit, ledger, metrics

    result = audit.run_audit(drivers=args.drivers or None,
                             with_fixture=not args.no_fixture,
                             device=args.device)
    if args.json:
        print(json.dumps(result.to_dict(), indent=2))
    else:
        print("\n".join(result.lines()))
    if args.textfile:
        extra = metrics.ledger_counter_series(result.total_by_site())
        metrics.export_textfile(args.textfile, extra_counters=extra)
        print(f"prometheus textfile written: {args.textfile}",
              file=sys.stderr)
    ledger.disable()
    return 0 if result.ok else 1


def _cmd_summary(args) -> int:
    from .trace import SpanTracer

    tracer = SpanTracer(capacity=1 << 20)
    with open(args.trace) as fh:
        for line in fh:
            line = line.strip()
            if line:
                tracer.record(json.loads(line))
    print("\n".join(tracer.summary_lines()))
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="protocol observability: privacy audit + trace tools",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    audit_p = sub.add_parser(
        "audit", help="reconcile runtime declassifications vs the gate's "
                      "certified census")
    audit_p.add_argument("--drivers", nargs="*", default=None,
                         help="substring filter on driver spec names")
    audit_p.add_argument("--json", action="store_true",
                         help="machine-readable output")
    audit_p.add_argument("--no-fixture", action="store_true",
                         help="skip the extra-reveal self-test")
    audit_p.add_argument("--textfile", default=None,
                         help="write Prometheus textfile metrics here")
    audit_p.add_argument("--device", default=None,
                         help="where the rounds run (default: cuda; pass "
                              "cpu for a CPU run)")
    audit_p.set_defaults(fn=_cmd_audit)

    sum_p = sub.add_parser(
        "summary", help="summarize a recorded span JSONL file")
    sum_p.add_argument("--trace", required=True,
                       help="span JSONL written by trace.export_jsonl")
    sum_p.set_defaults(fn=_cmd_summary)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
