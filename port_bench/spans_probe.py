"""Split a cell's traced part by the program's own spans, and time the
program's tracer against a window without it.

    python3 port_bench/spans_probe.py --workload <cell> --seed <n> \
        [--seconds 40] [--overhead-runs 3]

Sets the cell up as ``run.py`` does, then (with ``--overhead-runs``)
runs windows of ``--seconds`` in turns with the program's tracer off and
on (``enable(profiler=False)``), ABBA, one JSON line each, then traces
the mix's ``traced_jobs`` under ``torch.profiler`` with the program's
spans as ranges (``pbench/spans.py``) and prints one JSON line: device,
idle and host ms a round by span kind (``by_span``, ``outside`` for the
time outside every span), the card's idle ms a round under any program
span (``host_gap_ms``), the device ms a round of the work launched under
a ``solve`` span (``solve_span_ms``), host reads a round and the fold
draw's host ms a path.  Needs the card the cell asks for.
"""
import argparse
import json
import os
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
WINDOW_LABEL = "port_bench.spans_probe"


def overhead_windows(setup, seconds: float, runs: int):
    """``runs`` windows each with the tracer off and on, ABBA."""
    from repro_torch.obs import trace

    for i in range(runs):
        for mode in (("off", "on") if i % 2 == 0 else ("on", "off")):
            tracer = trace.enable() if mode == "on" else None
            try:
                answers, _, s = setup.run_jobs(seconds=seconds)
            finally:
                trace.disable()
            print(json.dumps({"overhead": mode, "jobs": len(answers),
                              "window_s": s, "s_per_job": s / len(answers),
                              "spans": len(tracer.spans) if tracer else 0,
                              "dropped": tracer.dropped if tracer else 0}),
                  flush=True)


def traced_part(setup, count: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from pbench import harness, spans
    from repro_torch.obs import trace

    acts = [ProfilerActivity.CPU]
    on_card = setup.device.type == "cuda"
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    trace.enable(profiler=True)
    try:
        with profile(activities=acts) as prof:
            with record_function(WINDOW_LABEL):
                _, records, _ = setup.run_jobs(count=count)
                harness.sync(setup.device)
    finally:
        tracer = trace.disable()
    out = spans.from_profile(prof, tracer, WINDOW_LABEL)
    rounds = sum(r["rounds"] for r in records)
    folds = [s.duration for s in tracer.spans if s.kind == "folds"]
    return {
        "jobs": len(records), "rounds": rounds, "dropped": tracer.dropped,
        "idle_share": 100.0 * out["idle_us"] / out["window_us"],
        "launched_share": out["launched_share"],
        "host_gap_ms": (out["idle_under_spans_us"] or 0.0) / 1e3 / rounds,
        "solve_span_ms": (out["solve_us"] or 0.0) / 1e3 / rounds,
        "host_reads_per_round": spans.host_reads_per_round(),
        "folds_ms": 1e3 * sum(folds) / len(records),
        "by_span_ms_a_round": {
            kind: {k[:-2] + "_ms": v * 1e3 / rounds for k, v in row.items()}
            for kind, row in sorted(out["by_span"].items())},
        "card": torch.cuda.get_device_name(setup.device) if on_card
        else setup.device.type,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--overhead-runs", type=int, default=0)
    args = ap.parse_args(argv)
    # as run.py: the checkout's sources, its kernel caches inside it
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build"
                                             / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

    from pbench import harness
    from pbench.spec import Spec

    cell = Spec(ROOT).cell(args.workload)
    try:
        device = harness.card(cell.chips)
    except harness.NoCard as err:
        print(f"spans_probe: {err}", file=sys.stderr)
        return 3
    setup = harness.Setup(cell, args.seed, device)
    overhead_windows(setup, args.seconds, args.overhead_runs)
    print(json.dumps({"workload": cell.name, "seed": args.seed,
                      **traced_part(setup, cell.traffic["traced_jobs"])}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
