"""Host-side span tracer: ring-buffered, ~zero-cost when disabled.

One module-level tracer records :class:`Span` intervals from every secure
driver: the job (``secure_fit``, ``secure_cv_path``), the round's phases
(newton / summaries / protect / aggregate / reveal / secure_round /
solve), the host's reads of device values (host_read), the CV fold draw
(folds), and round / retry / selection.  ``span(kind, ...)`` returns a
shared no-op context manager when tracing is off: the disabled cost is
one module-global read and a branch, which is how the instrumented
drivers stay bit- and perf-invisible.

**What a span's duration is.** Host time, on the driving thread.  The
port's device calls return once their work is queued, so the span of a
round phase (summaries, protect, aggregate, reveal, solve) covers the
enqueue of its kernels, not their run; a host_read span covers the wait
for the device and the copy.  A phase's device time comes from a
``torch.profiler`` capture: the profiler links each kernel to the op that
launched it, and the ops under a span are the span's.

**Clock.** Span stamps are nanoseconds on the clock ``torch.profiler``
stamps its events on (kineto's: nanoseconds since the Unix epoch).  Each
tracer takes one anchor pair of ``time.perf_counter_ns`` and
``time.time_ns`` when it is made (:func:`enable`) and stamps spans with
the monotonic counter plus that offset, so a span maps onto a profiler
capture of the same process by one subtraction (the capture's
``trace_start_ns``) and durations keep the monotonic clock's resolution.

**Fields.** Every span has an ``id`` (unique within its tracer), its
``parent`` (the id of the span enclosing it on the same thread, None at
the top) and its ``job`` (the id of the enclosing span of kind ``job``,
its own id for a job span, None outside any job), so the spans of one
fit or path share an identifier.  ``tid`` is the thread's native id, the
one the profiler's events carry.  The ring evicts its oldest span past
``capacity`` and counts each eviction in :attr:`SpanTracer.dropped`.

Exporters:

* :meth:`SpanTracer.export_jsonl` — one JSON object per line (``kind``,
  ``name``, ``t0`` and ``dur`` in seconds, ``tid``, ``id``, ``parent``,
  ``job``, ``attrs``), which ``python -m repro_torch.obs summary`` reads;
* :meth:`SpanTracer.export_chrome_trace` — the Chrome trace-event JSON
  (``ph: "X"`` duration events) that opens in ``chrome://tracing`` or
  https://ui.perfetto.dev.  Timestamps are absolute microseconds on the
  profiler's clock (``baseTimeNanoseconds`` 0), not shifted to the first
  span, so the file overlays a ``torch.profiler`` export of the same run
  (whose ``ts`` count from its own ``baseTimeNanoseconds``);
* :meth:`SpanTracer.summary_lines` — the per-kind host-time table the
  examples print.

Optional ``torch.profiler`` hook: ``enable(profiler=True)`` additionally
wraps every span in a ``torch.profiler.record_function`` range so spans
land inside a captured profiler trace, beside the CUDA kernels they
launched.  A span's stamps sit just inside its range's start and just
after its end: ``t0`` is taken once the range is open, ``t1`` once it
has closed.  The import is lazy and failure-tolerant on purpose: this
module is stdlib-only and must import without torch.
"""
from __future__ import annotations

import itertools
import json
import os
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
    "last",
]


class Span:
    """One closed interval [t0_ns, t1_ns] on the profiler's clock."""

    __slots__ = ("kind", "name", "t0_ns", "t1_ns", "tid", "attrs", "id",
                 "parent", "job")

    def __init__(self, kind, name, t0_ns, t1_ns, tid, attrs, id=None,
                 parent=None, job=None):
        self.kind = kind
        self.name = name
        self.t0_ns = t0_ns
        self.t1_ns = t1_ns
        self.tid = tid
        self.attrs = attrs
        self.id = id
        self.parent = parent
        self.job = job

    @property
    def t0(self) -> float:
        """Start, seconds since the Unix epoch."""
        return self.t0_ns * 1e-9

    @property
    def duration(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "name": self.name,
            "t0": self.t0,
            "dur": self.duration,
            "tid": self.tid,
            "id": self.id,
            "parent": self.parent,
            "job": self.job,
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
    __slots__ = ("_tracer", "kind", "name", "attrs", "_t0", "_ann", "_th",
                 "id", "parent", "job")

    def __init__(self, tracer, kind, name, attrs):
        self._tracer = tracer
        self.kind = kind
        self.name = name
        self.attrs = attrs
        self._t0 = 0
        self._ann = None

    def set(self, **attrs):
        """Attach attributes mid-span (e.g. results known only at exit)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        tr = self._tracer
        self._th = tr._thread()
        stack = self._th.stack
        up = stack[-1] if stack else None
        self.id = next(tr._ids)
        self.parent = up.id if up is not None else None
        self.job = self.id if self.kind == "job" else (
            up.job if up is not None else None)
        stack.append(self)
        if tr.profiler:
            ann = tr._annotation(self.name)
            if ann is not None:
                self._ann = ann
                ann.__enter__()
        self._t0 = tr.now_ns()
        return self

    def __exit__(self, *exc):
        tr = self._tracer
        if self._ann is not None:
            self._ann.__exit__(*exc)
        t1 = tr.now_ns()
        self._th.stack.pop()
        tr._emit(Span(self.kind, self.name, self._t0, t1, self._th.tid,
                      self.attrs, self.id, self.parent, self.job))
        return False


class SpanTracer:
    """Ring buffer of spans (oldest evicted past ``capacity`` and counted
    in ``dropped``)."""

    def __init__(self, capacity: int = 65536, profiler: bool = False):
        self.spans: deque = deque(maxlen=capacity)
        self.dropped = 0
        self.profiler = profiler
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        # the anchor pair: perf_counter_ns + offset is the profiler's clock
        p0 = time.perf_counter_ns()
        epoch = time.time_ns()
        p1 = time.perf_counter_ns()
        self._offset_ns = epoch - (p0 + p1) // 2

    def now_ns(self) -> int:
        """Now on the profiler's clock (ns since the Unix epoch)."""
        return time.perf_counter_ns() + self._offset_ns

    # -- recording ---------------------------------------------------------
    def span(self, kind: str, name: str | None = None, **attrs):
        return _LiveSpan(self, kind, name or kind, attrs)

    def _thread(self):
        """This thread's ``stack`` (its open spans, innermost last) and
        ``tid`` (its native id, read once: the read is a system call,
        which costs microseconds on some hosts)."""
        th = self._local
        if not hasattr(th, "tid"):
            th.stack, th.tid = [], threading.get_native_id()
        return th

    def _emit(self, s: Span):
        with self._lock:
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
            self.spans.append(s)

    def record(self, d: dict):
        """Re-ingest one :meth:`Span.to_dict` object (JSONL round-trip)."""
        t0 = round(d["t0"] * 1e9)
        self._emit(Span(d["kind"], d["name"], t0,
                        t0 + round(d["dur"] * 1e9), d.get("tid", 0),
                        d.get("attrs", {}), d.get("id"), d.get("parent"),
                        d.get("job")))

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
            self.dropped = 0

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
        """Chrome trace-event JSON (open in chrome://tracing / Perfetto),
        in absolute microseconds on the profiler's clock."""
        with self._lock:
            spans = list(self.spans)
        pid = os.getpid()
        events = [
            {
                "name": s.name,
                "cat": s.kind,
                "ph": "X",
                "ts": s.t0_ns / 1e3,
                "dur": (s.t1_ns - s.t0_ns) / 1e3,
                "pid": pid,
                "tid": s.tid,
                "args": {"id": s.id, "parent": s.parent, "job": s.job,
                         **{k: _jsonable(v) for k, v in s.attrs.items()}},
            }
            for s in spans
        ]
        with open(path, "w") as fh:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "baseTimeNanoseconds": 0}, fh)
        return len(events)

    # -- summaries ---------------------------------------------------------
    def summary(self) -> dict:
        """Per-kind {count, total_s, mean_s, max_s} host-time aggregates."""
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
_last: SpanTracer | None = None


def enable(capacity: int = 65536, profiler: bool = False) -> SpanTracer:
    """Install (or replace) the process tracer and return it."""
    global _tracer
    _tracer = SpanTracer(capacity=capacity, profiler=profiler)
    return _tracer


def disable() -> SpanTracer | None:
    """Stop tracing; returns the final tracer so callers can export it."""
    global _tracer, _last
    t, _tracer = _tracer, None
    if t is not None:
        _last = t
    return t


def get() -> SpanTracer | None:
    return _tracer


def last() -> SpanTracer | None:
    """The tracer :func:`disable` last stopped (None before the first):
    its spans stay readable after a caller let the return value go."""
    return _last


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
