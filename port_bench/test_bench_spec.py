"""The benchmark's files against the rules for them: every cell,
configuration, traffic mix, limit and metric found by name from data
files, and a new cell added by files alone."""
import dataclasses
import json
import re
import shutil

import pytest
import torch

import bench_testutil as tu
from pbench import harness
from pbench.spec import Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((tu.ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_paths(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["port_bench"]
    assert bench["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells (14 runs each) fits in 43,200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 \
        + 1200 <= 43200
    assert len((tu.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_valid(bench, kind):
    names = [e["name"] for e in bench[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_entries_have_only_the_allowed_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/")
        assert json.loads((tu.ROOT / c["file"]).read_text())["name"] \
            == c["name"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert UNIT.match(m["unit"]) and "\n" not in m["layer"]


@pytest.mark.parametrize("cell", tu.spec().cell_names())
def test_every_cell_finds_its_files_by_name(cell):
    c = tu.spec().cell(cell)
    assert c.entry.__file__ == str(tu.BENCH / "entries"
                                   / f"{c.traffic['entry']}.py")
    assert set(c.limits) == set(c.entry.NUMBERS)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(tu.spec().reader(m["name"]))
    # each per-layer metric moves an end-to-end metric this cell reports
    assert all(m["moves"] in names for m in c.per_layer)


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert tu.spec().reader_path(m["name"]).exists()


def test_a_split_metric_shares_its_reader_unless_it_has_its_own():
    spec = tu.spec()
    metrics = tu.BENCH / "metrics"
    assert spec.reader_path("solve_ms.fit") == metrics / "solve_ms.py"
    assert spec.reader_path("solve_ms.path") == metrics / "solve_ms.py"
    assert spec.reader_path("round_mfu.fit") == metrics / "round_mfu.fit.py"
    assert spec.reader_path("fit_s.p95") == metrics / "fit_s.p95.py"
    assert spec.reader_path("fit_s") == metrics / "fit_s.py"
    assert spec.reader("solve_ms.fit") is not None
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric.fit")


def test_a_cell_is_added_by_files_alone(tmp_path, monkeypatch):
    """A new configuration, traffic mix and per-layer metric: only new
    files under port_bench/ and new entries in BENCHMARK.json."""
    # the test process may hold the JAX package's tests' imports
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    root = tmp_path / "checkout"
    shutil.copytree(tu.BENCH, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tu.ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((tu.BENCH / "configs" / "higgs_s8.json").read_text())
    cfg.update(name="tiny_s4", rows=800, features=5, institutions=4)
    (root / "port_bench" / "configs" / "tiny_s4.json").write_text(
        json.dumps(cfg))
    mix = json.loads((tu.BENCH / "traffic" / "fit.json").read_text())
    mix["lambdas"] = {"logspace": [1, -1, 3]}
    (root / "port_bench" / "traffic" / "fit3.json").write_text(
        json.dumps(mix))
    (root / "port_bench" / "limits" / "tiny_s4.fit3.json").write_text(
        (tu.BENCH / "limits" / "higgs_s8.fit.json").read_text())
    (root / "port_bench" / "metrics" / "slowest_fit_s.py").write_text(
        "def read(ctx):\n    return max(j['seconds'] for j in ctx.jobs)\n")
    bench["configs"].append({"name": "tiny_s4", "source": "a test",
                             "file": "port_bench/configs/tiny_s4.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_s4.fit3", "config": "tiny_s4",
                               "traffic": "fit3", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][1]["workloads"].append("tiny_s4.fit3")
    bench["per_layer"].append({"name": "slowest_fit_s", "unit": "s",
                               "better": "lower", "source": "host_clock",
                               "layer": "fit driver", "moves": "fit_s",
                               "workloads": ["tiny_s4.fit3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(root)
    cell = spec.cell("tiny_s4.fit3")
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "fit_s"]
    assert [m["name"] for m in cell.per_layer] == ["slowest_fit_s"]
    res = harness.run(cell, spec, 7, 0.2, True, torch.device("cpu"), 0.0)
    assert res["correct"] and res["metrics"]["slowest_fit_s"]["value"] > 0
    res = harness.run(cell, spec, 7, 0.2, False, torch.device("cpu"), 0.0)
    assert set(res["metrics"]) == {"setup_s", "fit_s"}


def _mix_with_args(tmp_path, args):
    """A checkout whose new fit mix passes ``args`` to its entry, and the
    cell of it: files and entries alone."""
    root = tmp_path / "checkout"
    shutil.copytree(tu.BENCH, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tu.ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((tu.BENCH / "traffic" / "fit.json").read_text())
    mix["args"] = args
    (root / "port_bench" / "traffic" / "fit_x.json").write_text(
        json.dumps(mix))
    (root / "port_bench" / "limits" / "higgs_s8.fit_x.json").write_text(
        (tu.BENCH / "limits" / "higgs_s8.fit.json").read_text())
    bench["workloads"].append({"name": "higgs_s8.fit_x", "config": "higgs_s8",
                               "traffic": "fit_x", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][1]["workloads"].append("higgs_s8.fit_x")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(root)
    cell = spec.cell("higgs_s8.fit_x")
    return spec, dataclasses.replace(cell, config=dict(cell.config,
                                                       **tu.TINY))


def test_a_mix_passes_its_entry_arguments_through(tmp_path, monkeypatch):
    """A scan-rounds fit is a traffic file alone: its ``args`` reach
    ``secure_fit`` as they stand, and its answers are judged."""
    import repro_torch

    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    seen = []
    fit = repro_torch.secure_fit

    def spy(*a, **k):
        seen.append({n: k[n] for n in ("rounds", "rounds_per_sync",
                                       "max_iter", "protect", "tol")})
        return fit(*a, **k)

    monkeypatch.setattr(repro_torch, "secure_fit", spy)
    spec, cell = _mix_with_args(
        tmp_path, {"rounds": "scan", "rounds_per_sync": 4, "max_iter": 50})
    res = harness.run(cell, spec, 11, 0.2, False, torch.device("cpu"), 0.0)
    assert res["correct"], res["checks"]
    assert seen and all(s == {"rounds": "scan", "rounds_per_sync": 4,
                              "max_iter": 50, "protect": "both",
                              "tol": 1e-10} for s in seen)


def test_an_argument_the_reference_does_not_model_is_refused(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    spec, cell = _mix_with_args(tmp_path, {"rounds": "step", "l1": 0.1})
    with pytest.raises(ValueError, match="l1"):
        harness.run(cell, spec, 11, 0.2, False, torch.device("cpu"), 0.0)


def test_the_collective_reads_nothing_without_its_span():
    """No op under a collective span: ``collective_us`` is None and
    ``collective_ms`` is left out, never 0."""
    from pbench import readers, trace

    def no_span():
        return torch.ones(4).sum()

    _, summary = trace.capture(no_span, torch.device("cpu"))
    assert summary["collective_us"] is None
    cell = tu.spec().cell("pascal_alpha_s8.fit")
    ctx = readers.Context(cell.config, cell.traffic, True, 1.0, 1.0,
                          [{"seconds": 1.0, "rounds": 7}],
                          dict(summary, jobs=[{"seconds": 1.0,
                                               "rounds": 7}]))
    assert tu.spec().reader("collective_ms.fit")(ctx) is None
    ctx.trace["collective_us"] = 1000.0
    assert tu.spec().reader("collective_ms.fit")(ctx) == pytest.approx(
        1000.0 / 1e3 / 7)
