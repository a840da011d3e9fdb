"""The port's span tracer and host-read counter (``repro_torch.obs``).

Spans carry an id, their parent on the thread and their job; they are
stamped on the clock ``torch.profiler`` stamps its events on, so a span
and its ``record_function`` range cover the same interval and the
program's Chrome export overlays the profiler's.  ``repro_host_reads_total``
counts every marked read a fit or a path makes, tracing on or off.
"""
import json
import math
import statistics
import time

import numpy as np
import pytest
import torch

from repro_torch.core.collective import SecureCollective
from repro_torch.core.newton import secure_fit
from repro_torch.obs import metrics, trace
from repro_torch.selection.path import secure_cv_path

SIZES = (60, 70, 80)
LAMBDAS = (3.0, 0.3)


@pytest.fixture(scope="module")
def parts():
    rng = np.random.default_rng(7)
    n, d = sum(SIZES), 4
    X = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, d - 1))], 1)
    beta = rng.uniform(-1.0, 1.0, size=d)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    off = np.cumsum((0,) + SIZES)
    return [(torch.from_numpy(X[a:b]), torch.from_numpy(y[a:b]))
            for a, b in zip(off[:-1], off[1:])]


@pytest.fixture
def tracer():
    tr = trace.enable()
    try:
        yield tr
    finally:
        trace.disable()


def _fit(parts, **kw):
    return secure_fit(parts, protect="both", device="cpu",
                      aggregator=SecureCollective(backend="kernel"), **kw)


def _path(parts):
    return secure_cv_path(parts, LAMBDAS, num_folds=2, protect="both",
                          rounds_per_sync=4, device="cpu")


def _reads(driver):
    return metrics.get(metrics.HOST_READS, driver=driver) or 0.0


def test_spans_record_parent_and_job(tracer, parts, tmp_path):
    with trace.span("outer") as outer:
        with trace.span("inner") as inner:
            pass
    res = _fit(parts)
    spans = list(tracer.spans)
    assert inner.parent == outer.id and outer.parent is None
    assert inner.job is None and outer.job is None
    jobs = [s for s in spans if s.kind == "job"]
    assert [s.name for s in jobs] == ["secure_fit"]
    job = jobs[0]
    assert job.job == job.id and job.parent is None
    in_fit = [s for s in spans if s is not job and s.kind not in
              ("outer", "inner")]
    assert in_fit and all(s.job == job.id for s in in_fit)
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in in_fit:  # each parent encloses its child on the same thread
        up = by_id[s.parent]
        assert up.t0_ns <= s.t0_ns <= s.t1_ns <= up.t1_ns
        assert up.tid == s.tid
    kinds = {s.kind for s in in_fit}
    assert {"newton", "summaries", "secure_round", "solve",
            "host_read"} <= kinds
    assert sum(s.kind == "summaries" for s in in_fit) == res.iterations
    assert sum(s.kind == "host_read" for s in in_fit) == res.iterations + 1
    # the JSONL keeps the fields through a round trip
    path = tmp_path / "spans.jsonl"
    tracer.export_jsonl(path)
    again = trace.SpanTracer()
    for line in path.read_text().splitlines():
        again.record(json.loads(line))
    assert [(s.kind, s.id, s.parent, s.job) for s in again.spans] == \
        [(s.kind, s.id, s.parent, s.job) for s in spans]


def test_spans_share_the_profilers_clock(tmp_path):
    """A span and its record_function range cover the same interval, and
    the two Chrome exports overlay (each from its baseTimeNanoseconds).
    The median of seven spans, past a first one that warms the range's
    path up: what a busy host adds to one range's cost is not the clock."""
    from torch.profiler import ProfilerActivity, profile

    names = [f"obs_clock_probe{i}" for i in range(7)]
    tr = trace.enable(profiler=True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("probe", "obs_clock_warm"):
                pass
            for name in names:
                with trace.span("probe", name):
                    time.sleep(0.005)
    finally:
        trace.disable()
    mine = tmp_path / "spans.json"
    theirs = tmp_path / "profile.json"
    tr.export_chrome_trace(mine)
    prof.export_chrome_trace(str(theirs))

    def intervals_us(path):
        doc = json.loads(path.read_text())
        base = doc.get("baseTimeNanoseconds", 0) / 1e3
        ev = {e["name"]: e for e in doc["traceEvents"]
              if e.get("name") in names and e.get("ph") == "X"}
        return [(base + ev[n]["ts"], base + ev[n]["ts"] + ev[n]["dur"])
                for n in names]

    pairs = list(zip(intervals_us(mine), intervals_us(theirs)))
    assert all(a1 - a0 >= 5e3 for (a0, a1), _ in pairs)
    start = statistics.median(a0 - b0 for (a0, _), (b0, _) in pairs)
    end = statistics.median(a1 - b1 for (_, a1), (_, b1) in pairs)
    assert abs(start) < 50 and abs(end) < 50
    first = next(s for s in tr.spans if s.name == names[0])
    assert abs(first.t0_ns / 1e3 - pairs[0][0][0]) < 1
    assert abs(time.time() - first.t0) < 60


@pytest.mark.parametrize("rounds", ["step", "scan"])
def test_fit_host_reads(parts, rounds):
    """A step fit reads once a round and once for its beta; a scan fit
    once a slot, once a block and once for its beta."""
    driver = "secure_fit" if rounds == "step" else "secure_fit_scan"
    before = _reads(driver)
    res = _fit(parts, rounds=rounds, rounds_per_sync=4)
    assert res.converged
    if rounds == "step":
        want = res.iterations + 1
    else:
        blocks = math.ceil(res.iterations / 4)
        want = 4 * blocks + blocks + 1
    assert _reads(driver) - before == want


def test_path_host_reads(parts):
    """A path reads once a scan slot, once a block and once a chunk."""
    before = _reads("selection_path")
    rep = _path(parts)
    slots = sum(t["objectives"].shape[0] for t in rep.traces)
    assert slots % 4 == 0
    chunks = len(rep.traces)
    assert chunks == len(LAMBDAS) + 1
    assert _reads("selection_path") - before == slots + slots // 4 + chunks


def test_path_spans_folds_inside_the_job(tracer, parts):
    _path(parts)
    spans = list(tracer.spans)
    (job,) = [s for s in spans if s.kind == "job"]
    folds = [s for s in spans if s.kind == "folds"]
    # a draw an institution, a copy to the device a chunk
    assert len(folds) == len(SIZES) + len(LAMBDAS) + 1
    assert all(s.job == job.id for s in folds)
    assert tracer.dropped == 0


def test_tracing_off_records_nothing(parts):
    trace.disable()
    assert trace.get() is None
    assert trace.span("newton") is trace._NOOP
    last = trace.last()
    n = len(last.spans) if last is not None else 0
    before = _reads("secure_fit")
    res = _fit(parts)
    # the counter counts with tracing off; no tracer gained a span
    assert _reads("secure_fit") - before == res.iterations + 1
    assert trace.last() is last
    assert (len(last.spans) if last is not None else 0) == n


def test_ring_counts_what_it_drops():
    tr = trace.SpanTracer(capacity=4)
    for i in range(10):
        with tr.span("k", f"s{i}"):
            pass
    assert tr.dropped == 6
    assert [s.name for s in tr.spans] == ["s6", "s7", "s8", "s9"]
    tr.clear()
    assert tr.dropped == 0 and not tr.spans
