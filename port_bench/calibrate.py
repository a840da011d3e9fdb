"""Readings that set a cell's limits: the program's numbers over many
seeds and the control's over a few, in one process, at the cell's size.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1-12 \
        --control-seeds 101-103 --seconds 3 [--fault NAME] [--out FILE]

For each program seed: the cell's inputs from that seed, its warm-up, a
short window of the cell's jobs, and the comparison a run makes.  For
each control seed: the entry's control (the reference one precision
below what the configuration states) put in the program's place, for
its warm-up and as many window jobs as ``control_jobs`` gives.  The
lower reading of a number is the largest over the program's seeds, the
upper the smallest over the control's; a limit lies between them
(``port_bench/limits/<cell>.json``).  With ``--fault`` the program's seeds
run with that fault planted (``pbench/faults.py``): their readings are a
training cell's further upper readings.  The benchmark's own runs never
run the control or a fault.
"""
import argparse
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def seed_list(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def readings(cell, seed, device, seconds, program_cls) -> dict:
    """The comparison's numbers of one seed (every job's, folded)."""
    from pbench import harness

    setup = harness.Setup(cell, seed, device, program_cls)
    count = cell.entry.control_jobs(cell.traffic)
    if program_cls is harness.Program:
        answers, records, _ = setup.run_jobs(seconds=seconds)
    elif count:
        answers, records, _ = setup.run_jobs(count=count)
    else:  # the control's readings are its warm-up's
        answers, records = [], []
    setup.free()
    correct, checks, failed = harness.check(cell, setup.inputs, answers,
                                            seed, setup.warm)
    return {"seed": seed, "jobs": len(answers), "correct": correct,
            "records": sorted({json.dumps({k: v for k, v in r.items()
                                           if k != "seconds"})
                               for r in records}),
            "numbers": {k: c["value"] for k, c in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seed_list, required=True)
    ap.add_argument("--control-seeds", type=seed_list, default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch
    from pbench import faults, harness
    from pbench.spec import Spec

    cell = Spec(ROOT).cell(args.workload)
    device = harness.card(cell.chips)
    runs = {"program": [], "control": []}
    for seed in args.seeds:
        with faults.planted(args.fault):
            runs["program"].append(readings(cell, seed, device,
                                            args.seconds, harness.Program))
        print(json.dumps(runs["program"][-1]), flush=True)
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        runs["control"].append(readings(cell, seed, device, args.seconds,
                                        harness.Control))
        print(json.dumps(runs["control"][-1]), flush=True)
        torch.cuda.empty_cache()
    names = sorted(runs["program"][0]["numbers"]) if runs["program"] else []
    summary = {"workload": cell.name, "fault": args.fault,
               "device": torch.cuda.get_device_name(device),
               "lower": {k: max(r["numbers"][k] for r in runs["program"])
                         for k in names},
               "upper": {k: min(r["numbers"][k] for r in runs["control"])
                         for k in names} if runs["control"] else {},
               "runs": runs}
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: summary[k] for k in ("workload", "fault", "device",
                                              "lower", "upper")}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
