"""Find a cell's configuration, traffic mix, limits and metric readers by
the names ``BENCHMARK.json`` gives them.

A cell is one entry of ``workloads``.  Its files are looked up by name,
so a later cell, of a kind of job the benchmark already runs or of a new
one, needs only new files and new entries:

* the configuration: the ``file`` its ``configs`` entry names;
* the traffic mix: ``port_bench/traffic/<traffic>.json``;
* the kind of job: the module ``port_bench/entries/<entry>.py`` that the
  mix's ``entry`` names, which holds all that depends on it (see
  :func:`load_entry`); a mix whose entry has no module is refused;
* the limits of the comparison that decides ``correct``:
  ``port_bench/limits/<cell>.json``;
* each metric: a reader ``port_bench/metrics/<metric>.py`` whose
  ``read(ctx)`` returns a number, or None where it finds nothing to read;
  a metric split by the end-to-end metric it moves (``solve_ms.fit``,
  ``solve_ms.path``) may share one reader, ``<metric without its last
  part>.py`` (``solve_ms.py``), where it has no file of its own.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload with everything its run needs, loaded from files."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple  # the BENCHMARK.json entries this cell reports
    per_layer: tuple
    entry: object  # the module of the mix's entry


def load_json(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _load(path, prefix: str):
    """The module of the source file ``path``."""
    name = prefix + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_entry(bench_dir, name: str):
    """The module ``<bench_dir>/entries/<name>.py`` of a kind of job.

    It holds everything that depends on the kind: ``make_inputs(config,
    seed, device)`` (the inputs, drawn on the card from the seed),
    ``jobs(mix, seed, stream)`` (the endless job generator), ``Program``
    and ``Control`` (built from ``(config, mix, device)``; called on
    ``(inputs, job)`` for the job's answer, with ``load_kernels()``,
    ``counters()`` and ``free()``), ``job_record(answer, seconds)``,
    ``control_jobs(mix)`` (the window jobs a control runs for its
    readings), ``modelled(mix)`` (raises where the reference does not
    model the mix), ``check(cell, inputs, warm, answers, seed)``
    (``(correct, checks, failed)`` of the warm-up's and the window's
    (job, answer) pairs), ``NUMBERS`` (the numbers it compares) and
    ``CATEGORIES`` (its kernels' device-time categories)."""
    path = pathlib.Path(bench_dir) / "entries" / f"{name}.py"
    if not name.isidentifier() or not path.is_file():
        raise ValueError(f"the mix's entry {name!r} has no module {path}")
    return _load(path, "pbench_entry_")


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """A metric with ``workloads`` is reported in those cells; one without
    is reported wherever the end-to-end metric it moves is (or, for an
    end-to-end metric, everywhere)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


class Spec:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root=ROOT, bench=None):
        self.root = pathlib.Path(root)
        self.bench = bench if bench is not None else load_json(
            self.root / "BENCHMARK.json")
        self.bench_dir = self.root / "port_bench"

    def cell_names(self) -> list[str]:
        return [w["name"] for w in self.bench["workloads"]]

    def cell(self, name: str) -> Cell:
        by_name = {w["name"]: w for w in self.bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(by_name)})")
        w = by_name[name]
        cfg = {c["name"]: c for c in self.bench["configs"]}[w["config"]]
        e2e = tuple(m for m in self.bench["end_to_end"]
                    if _reports(m, name, set()))
        names = {m["name"] for m in e2e}
        per_layer = tuple(m for m in self.bench["per_layer"]
                          if _reports(m, name, names))
        traffic = load_json(self.bench_dir / "traffic"
                            / f"{w['traffic']}.json")
        return Cell(
            name=name, chips=int(w["chips"]),
            config=load_json(self.root / cfg["file"]), traffic=traffic,
            limits=load_json(self.bench_dir / "limits" / f"{name}.json"),
            end_to_end=e2e, per_layer=per_layer,
            entry=load_entry(self.bench_dir, traffic["entry"]),
        )

    def reader_path(self, metric_name: str) -> pathlib.Path:
        """``metrics/<metric_name>.py``, or the shared reader of a split
        metric, ``metrics/<metric_name less its last part>.py``."""
        own = self.bench_dir / "metrics" / f"{metric_name}.py"
        stem, dot, _ = metric_name.rpartition(".")
        shared = self.bench_dir / "metrics" / f"{stem}.py"
        return shared if dot and not own.exists() and shared.exists() \
            else own

    def reader(self, metric_name: str):
        """The ``read(ctx)`` of the metric's reader file."""
        path = self.reader_path(metric_name)
        if not path.is_file():
            raise FileNotFoundError(f"no reader {path}")
        return _load(path, "pbench_metric_").read
