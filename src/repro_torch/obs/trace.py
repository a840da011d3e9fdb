"""Host-side span tracer: ring-buffered, ~zero-cost when disabled.

One module-level tracer records :class:`Span` intervals (protect /
aggregate / reveal / newton / round / retry / ...) from every secure
driver.  ``span(kind, ...)`` returns a shared no-op context manager when
tracing is off — the disabled cost is one module-global read and a
branch, which is how the instrumented drivers stay bit- and
perf-invisible (see ``benchmarks/obs_overhead.py``).

Exporters:

* :meth:`SpanTracer.export_jsonl` — one JSON object per line, the run
  ledger ``results/show.py`` renders;
* :meth:`SpanTracer.export_chrome_trace` — the Chrome trace-event JSON
  (``ph: "X"`` duration events, microsecond timestamps) that opens
  directly in ``chrome://tracing`` or https://ui.perfetto.dev;
* :meth:`SpanTracer.summary_lines` — the per-kind wall-time table the
  examples print.

Optional ``torch.profiler`` hook: ``enable(profiler=True)`` additionally
wraps every span in a ``torch.profiler.record_function`` range so spans
land inside a captured profiler trace, beside the CUDA kernels they
launched.  The import is lazy and failure-tolerant on purpose: this
module is stdlib-only and must import without torch.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque

__all__ = [
    "Span",
    "SpanTracer",
    "span",
    "traced",
    "enable",
    "disable",
    "get",
]


class Span:
    """One closed interval: [t0, t1] seconds (perf_counter domain)."""

    __slots__ = ("kind", "name", "t0", "t1", "tid", "attrs")

    def __init__(self, kind, name, t0, t1, tid, attrs):
        self.kind = kind
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.tid = tid
        self.attrs = attrs

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "name": self.name,
            "t0": self.t0,
            "dur": self.duration,
            "tid": self.tid,
            **({"attrs": self.attrs} if self.attrs else {}),
        }


class _NoopSpan:
    """Shared do-nothing context manager returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NOOP = _NoopSpan()


class _LiveSpan:
    __slots__ = ("_tracer", "kind", "name", "attrs", "_t0", "_ann")

    def __init__(self, tracer, kind, name, attrs):
        self._tracer = tracer
        self.kind = kind
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0
        self._ann = None

    def set(self, **attrs):
        """Attach attributes mid-span (e.g. results known only at exit)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        tr = self._tracer
        if tr.profiler:
            ann = tr._annotation(self.name)
            if ann is not None:
                self._ann = ann
                ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._tracer._emit(
            Span(self.kind, self.name, self._t0, t1,
                 threading.get_ident(), self.attrs)
        )
        return False


class SpanTracer:
    """Ring buffer of spans (oldest evicted past ``capacity``)."""

    def __init__(self, capacity: int = 65536, profiler: bool = False):
        self.spans: deque = deque(maxlen=capacity)
        self.profiler = profiler
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------
    def span(self, kind: str, name: str | None = None, **attrs):
        return _LiveSpan(self, kind, name or kind, attrs)

    def _emit(self, s: Span):
        with self._lock:
            self.spans.append(s)

    def record(self, d: dict):
        """Re-ingest one :meth:`Span.to_dict` object (JSONL round-trip)."""
        self._emit(Span(d["kind"], d["name"], d["t0"],
                        d["t0"] + d["dur"], d.get("tid", 0),
                        d.get("attrs", {})))

    def _annotation(self, name: str):
        """A torch.profiler.record_function, or None without torch."""
        try:  # lazy + tolerant: tracing must work in torch-free processes
            import torch.profiler
        except ImportError:
            self.profiler = False
            return None
        return torch.profiler.record_function(name)

    def clear(self):
        with self._lock:
            self.spans.clear()

    # -- exporters ---------------------------------------------------------
    def export_jsonl(self, path) -> int:
        """One span per line; returns the number of spans written."""
        with self._lock:
            spans = list(self.spans)
        with open(path, "w") as fh:
            for s in spans:
                fh.write(json.dumps(s.to_dict()) + "\n")
        return len(spans)

    def export_chrome_trace(self, path) -> int:
        """Chrome trace-event JSON (open in chrome://tracing / Perfetto)."""
        with self._lock:
            spans = list(self.spans)
        t_origin = min((s.t0 for s in spans), default=0.0)
        events = [
            {
                "name": s.name,
                "cat": s.kind,
                "ph": "X",
                "ts": (s.t0 - t_origin) * 1e6,
                "dur": s.duration * 1e6,
                "pid": 0,
                "tid": s.tid,
                "args": {k: _jsonable(v) for k, v in s.attrs.items()},
            }
            for s in spans
        ]
        with open(path, "w") as fh:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, fh)
        return len(events)

    # -- summaries ---------------------------------------------------------
    def summary(self) -> dict:
        """Per-kind {count, total_s, mean_s, max_s} aggregates."""
        with self._lock:
            spans = list(self.spans)
        out: dict = {}
        for s in spans:
            rec = out.setdefault(
                s.kind, {"count": 0, "total_s": 0.0, "max_s": 0.0}
            )
            rec["count"] += 1
            rec["total_s"] += s.duration
            rec["max_s"] = max(rec["max_s"], s.duration)
        for rec in out.values():
            rec["mean_s"] = rec["total_s"] / rec["count"]
        return out

    def summary_lines(self) -> list[str]:
        """The per-kind span table examples print after a run."""
        rows = sorted(self.summary().items(),
                      key=lambda kv: -kv[1]["total_s"])
        lines = [f"{'span kind':<20} {'count':>6} {'total ms':>10} "
                 f"{'mean ms':>9} {'max ms':>9}"]
        for kind, rec in rows:
            lines.append(
                f"{kind:<20} {rec['count']:>6d} "
                f"{rec['total_s'] * 1e3:>10.2f} "
                f"{rec['mean_s'] * 1e3:>9.3f} "
                f"{rec['max_s'] * 1e3:>9.3f}"
            )
        return lines


def _jsonable(v):
    return v if isinstance(v, (int, float, str, bool, type(None))) \
        else str(v)


# -- module-level tracer (what the drivers call) ----------------------------

_tracer: SpanTracer | None = None


def enable(capacity: int = 65536, profiler: bool = False) -> SpanTracer:
    """Install (or replace) the process tracer and return it."""
    global _tracer
    _tracer = SpanTracer(capacity=capacity, profiler=profiler)
    return _tracer


def disable() -> SpanTracer | None:
    """Stop tracing; returns the final tracer so callers can export it."""
    global _tracer
    t, _tracer = _tracer, None
    return t


def get() -> SpanTracer | None:
    return _tracer


def span(kind: str, name: str | None = None, **attrs):
    """The instrumentation entry point: a context manager.

    When tracing is disabled this is one global read + branch and a
    shared no-op object — nothing allocates per call beyond the kwargs.
    """
    t = _tracer
    if t is None:
        return _NOOP
    return t.span(kind, name, **attrs)


def traced(kind: str, name: str | None = None):
    """Decorator form of :func:`span` for whole-method instrumentation.

    The wrapper adds one function call + the disabled-span branch when
    tracing is off — the cheapest way to span a method without touching
    its body's indentation.
    """
    import functools

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t = _tracer
            if t is None:
                return fn(*args, **kwargs)
            with t.span(kind, label):
                return fn(*args, **kwargs)

        return wrapper

    return deco
