"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (an entry of ``BENCHMARK.json``'s ``workloads``) names its
configuration and traffic mix; ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a profiled
part after the window.  The last line of standard output is the result's
JSON object; the numbers compared with the reference, each beside its
limit, are the last lines of standard error.  Without the cards the cell
asks for, or with JAX or the JAX package loaded, it exits non-zero and
prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]
# every kernel cache at a fixed path inside the checkout; the program's
# own nvcc build goes to <checkout>/build (repro_torch/kernels/_build.py)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from pbench import harness
    from pbench.spec import Spec

    marks = [("imports", time.perf_counter())]
    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    try:
        device = harness.card(cell.chips)
        marks.append(("cuda_init", time.perf_counter()))
        result = harness.run(cell, spec, args.seed, args.seconds,
                             bool(args.trace), device, T_START, marks=marks)
    except (harness.NoCard, harness.Forbidden) as err:
        print(f"port_bench: {err}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
