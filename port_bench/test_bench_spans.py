"""``pbench/spans.py`` on hand-made intervals, the readers of the program's
spans and host-read counter, and the spans probe on a tiny CPU cell."""
import pytest
import torch

import bench_testutil as tu
from pbench import harness, readers, spans

CPU = torch.device("cpu")


def _piece(t0, t1, kind, id, parent=None):
    return spans.Piece(float(t0), float(t1), kind, id, parent)


# job [0, 100) > newton [10, 60) > solve [20, 30); newton [70, 90)
NESTED = [_piece(0, 100, "job", 1), _piece(10, 60, "newton", 2, 1),
          _piece(20, 30, "solve", 3, 2), _piece(70, 90, "newton", 4, 1)]


def _kinds(split):
    return {(o.kind if o else None): us for o, us in split.items()}


def test_a_gap_goes_to_the_innermost_span():
    line = spans.Timeline(NESTED)
    assert _kinds(line.split([(22, 28)])) == {"solve": 6.0}
    assert _kinds(line.split([(62, 68)])) == {"job": 6.0}
    assert line.owner_at(25).kind == "solve"
    assert line.under(line.owner_at(25), "job")
    assert not line.under(line.owner_at(75), "solve")


def test_a_gap_outside_every_span_goes_outside():
    line = spans.Timeline(NESTED)
    assert _kinds(line.split([(110, 130)])) == {None: 20.0}
    assert line.owner_at(150) is None and line.owner_at(-5) is None
    assert spans.by_span(line, [(110, 130)], [], (0, 130))[
        spans.OUTSIDE]["idle_s"] == pytest.approx(20e-6)


def test_a_gap_across_a_span_edge_is_split():
    line = spans.Timeline(NESTED)
    assert _kinds(line.split([(25, 45)])) == {"solve": 5.0, "newton": 15.0}
    assert _kinds(line.split([(95, 105)])) == {"job": 5.0, None: 5.0}
    assert _kinds(line.split([(-10, 15)])) == {None: 10.0, "job": 10.0,
                                               "newton": 5.0}


def test_by_span_columns_sum_to_the_window():
    gaps = [(5, 25), (95, 110)]
    ops = [(21, 4.0), (12, 2.0), (105, 1.0)]
    line = spans.Timeline(NESTED)
    rows = spans.by_span(line, gaps, ops, (0, 110))
    total = {k: sum(r[k] for r in rows.values())
             for k in ("device_s", "idle_s", "host_s")}
    assert total == pytest.approx({"device_s": 7e-6, "idle_s": 35e-6,
                                   "host_s": 110e-6})
    # host time is self time: job 100 less newton's 50 and 20
    assert rows["job"]["host_s"] == pytest.approx(30e-6)
    assert rows["solve"]["device_s"] == pytest.approx(4e-6)
    assert spans.solve_device_us(line, ops) == pytest.approx(4.0)
    assert spans.solve_device_us(line, [(12, 2.0)]) is None
    assert spans.idle_under_spans_us(line, gaps) == pytest.approx(25.0)
    assert spans.idle_under_spans_us(spans.Timeline([]), gaps) is None
    assert spans.gaps_of([(3, 5), (4, 8), (9, 10)], 0, 12) == [
        (0, 3), (8, 9), (10, 12)]


@pytest.fixture
def traced_tracer():
    """The program's last tracer, with two fold draws of 2 ms."""
    from repro_torch.obs import trace

    tracer = trace.enable()
    trace.disable()
    for i in range(2):
        tracer.record({"kind": "folds", "name": "assign_folds",
                       "t0": 1.0 + i, "dur": 0.002, "id": i + 1})
    return tracer


def _ctx(on_card=True, traced=True):
    cell = tu.spec().cell("pascal_alpha_s8.path")
    jobs = [{"seconds": 1.0, "rounds": 28, "sweep_rounds": 26,
             "refit_rounds": 2}]
    summary = {"jobs": jobs} if traced else None
    return readers.Context(cell.config, cell.traffic, on_card, 1.0, 1.0,
                           jobs, summary)


@pytest.mark.parametrize("name", ["host_reads_per_round.fit",
                                  "host_reads_per_round.path",
                                  "folds_ms.path"])
def test_a_reader_reads_nothing_without_its_data(traced_tracer, name):
    from repro_torch.obs import metrics

    metrics.inc(metrics.HOST_READS, driver="bench_spans_test")
    metrics.inc("repro_rounds_total", driver="bench_spans_test")
    read = tu.spec().reader(name)
    assert read(_ctx()) is not None
    assert read(_ctx(traced=False)) is None
    assert read(_ctx(on_card=False)) is None
    traced_tracer.dropped = 1
    assert read(_ctx()) is None


def test_folds_ms_is_the_fold_spans_a_path(traced_tracer):
    assert tu.spec().reader("folds_ms.path")(_ctx()) == pytest.approx(
        4.0, rel=1e-6, abs=0.01)


def test_host_reads_per_round_is_the_counters_ratio():
    from repro_torch.obs import metrics

    metrics.inc(metrics.HOST_READS, 3, driver="bench_spans_test")
    metrics.inc("repro_rounds_total", 2, driver="bench_spans_test")
    snap = metrics.snapshot()["counters"]
    reads = sum(v for (n, _), v in snap.items() if n == metrics.HOST_READS)
    rounds = sum(v for (n, _), v in snap.items()
                 if n == "repro_rounds_total")
    assert spans.host_reads_per_round() == pytest.approx(reads / rounds)


def test_the_probe_splits_a_tiny_fit_by_span():
    import spans_probe

    setup = harness.Setup(tu.tiny_cell("pascal_alpha_s8.fit"), 5, CPU)
    out = spans_probe.traced_part(setup, 1)
    rows = out["by_span_ms_a_round"]
    assert out["dropped"] == 0 and out["jobs"] == 1 and out["rounds"] > 0
    assert {"job", "newton", "summaries", "secure_round", "solve",
            "host_read", spans.OUTSIDE} <= set(rows)
    # no card: the whole window is idle, and each column sums to it
    host = sum(r["host_ms"] for r in rows.values())
    idle = sum(r["idle_ms"] for r in rows.values())
    assert idle == pytest.approx(host, rel=1e-6)
    assert out["idle_share"] == pytest.approx(100.0)
    assert out["solve_span_ms"] == 0.0
