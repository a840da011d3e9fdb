"""Find a cell's configuration, traffic mix, limits and metric readers by
the names ``BENCHMARK.json`` gives them.

A cell is one entry of ``workloads``.  Its files are looked up by name,
so a later cell needs only new files and new entries:

* the configuration: the ``file`` its ``configs`` entry names;
* the traffic mix: ``port_bench/traffic/<traffic>.json``;
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


def load_json(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


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
        return Cell(
            name=name, chips=int(w["chips"]),
            config=load_json(self.root / cfg["file"]),
            traffic=load_json(self.bench_dir / "traffic"
                              / f"{w['traffic']}.json"),
            limits=load_json(self.bench_dir / "limits" / f"{name}.json"),
            end_to_end=e2e, per_layer=per_layer,
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
        mod_name = "pbench_metric_" + "".join(
            c if c.isalnum() else "_" for c in path.stem)
        if not path.is_file():
            raise FileNotFoundError(f"no reader {path}")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
