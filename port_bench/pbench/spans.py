"""The program's own spans beside the device trace: device, idle and host
time by span kind, and the readers' access to the program's span tracer
and host-read counter.

``repro_torch.obs.trace`` stamps its spans on the clock ``torch.profiler``
stamps its events on (nanoseconds since the Unix epoch), so a span maps
onto a capture by one subtraction, the capture's ``trace_start_ns``.
On the driving thread the spans nest; the time line cuts at every span
edge into pieces, each owned by the innermost span open over it (none
outside every span).  Then:

* an idle interval of the card is split by exact overlap among the
  pieces, each part going to its piece's owner;
* a kernel's device time goes to the innermost span open when the host
  made the call that launched it;
* a span's host time is its self time: its duration less its children's.

Every time here is microseconds on the profiler's clock, relative to the
capture's start, as ``FunctionEvent.time_range`` gives them.  Where the
program has no such tracer (an older program), it dropped spans, or it
recorded none on the driving thread, nothing is read.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import threading

OUTSIDE = "outside"


@dataclasses.dataclass(frozen=True)
class Piece:
    """One span as the reduction sees it: microseconds on the capture's
    clock, its kind, its id and its parent's id."""

    t0: float
    t1: float
    kind: str
    id: int
    parent: int | None = None


def program_tracer():
    """The tracer the program's last traced part ran under, or None where
    the program has none with ids and a drop count, or it dropped spans."""
    try:
        from repro_torch.obs import trace
    except ImportError:
        return None
    tracer = getattr(trace, "last", lambda: None)()
    if tracer is None or getattr(tracer, "dropped", None) != 0:
        return None
    return tracer


def host_reads_per_round():
    """The program's ``repro_host_reads_total`` over its
    ``repro_rounds_total``, every driver of the process together (a
    benchmark process runs one entry); None where it counts no reads."""
    try:
        from repro_torch.obs import metrics
    except ImportError:
        return None
    reads = getattr(metrics, "HOST_READS", None)
    counters = metrics.snapshot()["counters"]
    total = collections.Counter()
    for (name, _), value in counters.items():
        total[name] += value
    if reads is None or not total[reads] or not total["repro_rounds_total"]:
        return None
    return total[reads] / total["repro_rounds_total"]


def pieces(tracer, trace_start_ns: int, tid: int | None = None) -> list:
    """The tracer's spans of thread ``tid`` (default: the calling one) on
    the capture's clock."""
    tid = threading.get_native_id() if tid is None else tid
    return [Piece((s.t0_ns - trace_start_ns) / 1e3,
                  (s.t1_ns - trace_start_ns) / 1e3, s.kind, s.id, s.parent)
            for s in tracer.spans if s.tid == tid]


def partition(spans) -> list:
    """The time line cut at every span edge: ``(a, b, owner)`` pieces in
    order, ``owner`` the innermost span open over [a, b) (the latest
    started; the shortest among equal starts), None where none is."""
    edges = sorted({t for s in spans for t in (s.t0, s.t1)})
    starts = sorted(spans, key=lambda s: s.t0)
    out, live, i = [], [], 0
    for a, b in zip(edges, edges[1:]):
        while i < len(starts) and starts[i].t0 <= a:
            live.append(starts[i])
            i += 1
        live = [s for s in live if s.t1 > a]
        owner = max(live, key=lambda s: (s.t0, -s.t1), default=None)
        out.append((a, b, owner))
    return out


class Timeline:
    """The driving thread's spans, cut into :func:`partition`'s pieces."""

    def __init__(self, spans):
        self.parts = partition(spans)
        self.starts = [a for a, _, _ in self.parts]
        self.by_id = {s.id: s for s in spans}

    def owner_at(self, t: float):
        """The innermost span open at ``t`` (None outside every span)."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0 or t >= self.parts[i][1]:
            return None
        return self.parts[i][2]

    def split(self, intervals) -> dict:
        """Each interval's length split by exact overlap among the pieces:
        {owner: us}, the length outside every span under None."""
        out = collections.defaultdict(float)
        for a, b in intervals:
            covered = 0.0
            i = max(bisect.bisect_right(self.starts, a) - 1, 0)
            while i < len(self.parts) and self.parts[i][0] < b:
                pa, pb, owner = self.parts[i]
                lap = min(b, pb) - max(a, pa)
                if lap > 0 and owner is not None:
                    out[owner] += lap
                    covered += lap
                i += 1
            if b - a - covered > 0:
                out[None] += b - a - covered
        return dict(out)

    def under(self, span, kind: str) -> bool:
        """Whether ``span`` is of ``kind`` or lies inside one."""
        while span is not None:
            if span.kind == kind:
                return True
            span = self.by_id.get(span.parent)
        return False


def by_span(line: Timeline, gaps, ops, window) -> dict:
    """Device, idle and host seconds by span kind over the traced window.

    ``gaps``: the card's idle intervals in the window; ``ops``:
    ``(launch, device us)`` of each device operation, with the time of
    the host call that launched it; ``window``: ``(w0, w1)``.  Host time
    is self time, so each column sums to the window's total of its kind;
    what no span covers is ``outside``."""
    rows = collections.defaultdict(
        lambda: {"device_s": 0.0, "idle_s": 0.0, "host_s": 0.0})

    def key(owner):
        return OUTSIDE if owner is None else owner.kind

    for owner, us in line.split(gaps).items():
        rows[key(owner)]["idle_s"] += us * 1e-6
    for start, us in ops:
        rows[key(line.owner_at(start))]["device_s"] += us * 1e-6
    for owner, us in line.split([window]).items():
        rows[key(owner)]["host_s"] += us * 1e-6
    return dict(rows)


def solve_device_us(line: Timeline, ops) -> float | None:
    """Device us of the work launched under a ``solve`` span, whatever
    kernels implement it; None where no solve span launched device work."""
    us = sum(d for start, d in ops
             if line.under(line.owner_at(start), "solve"))
    return us if us > 0 else None


def idle_under_spans_us(line: Timeline, gaps) -> float | None:
    """The card's idle us under any program span; None without spans."""
    if not line.by_id:
        return None
    return sum(us for owner, us in line.split(gaps).items()
               if owner is not None)


def gaps_of(intervals, w0: float, w1: float) -> list:
    """The parts of [w0, w1] that no interval covers, in order."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    edges = [w0] + [x for m in merged for x in m] + [w1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def from_profile(prof, tracer, window_label: str) -> dict:
    """A finished ``torch.profiler`` capture, whose range ``window_label``
    bounds the traced part on the driving thread, reduced with the spans
    ``tracer`` recorded in it: ``window_us``, ``idle_us``, ``by_span``,
    ``idle_under_spans_us`` and ``solve_us`` (the last two None without
    spans or solve work), and ``launched_share``, the share of the
    window's device time whose launch call the capture holds.

    Device work goes to the span open when the host made the call that
    launched it (the CUDA runtime or driver call of the same correlation
    id): kernels a program launches itself, outside any PyTorch op, have
    no op to link to under ``record_function`` ranges."""
    from torch.autograd import DeviceType

    events = prof.events()
    window = next(e for e in events if e.name == window_label
                  and e.device_type == DeviceType.CPU)
    w0, w1 = window.time_range.start, window.time_range.end
    device, calls = [], {}
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # the device timeline's mirrors of host ranges are no work
            if not getattr(e, "is_user_annotation", False) and b > w0 \
                    and a < w1:
                device.append((max(a, w0), min(b, w1), e.id))
        elif e.name.startswith("cu"):  # a CUDA runtime or driver call
            calls[e.id] = a
    ops = [(calls[i], b - a) for a, b, i in device if i in calls]
    gaps = gaps_of([(a, b) for a, b, _ in device], w0, w1)
    line = Timeline(pieces(tracer,
                           prof.profiler.kineto_results.trace_start_ns()))
    total = sum(b - a for a, b, _ in device)
    return {
        "window_us": w1 - w0,
        "idle_us": sum(b - a for a, b in gaps),
        "launched_share": sum(d for _, d in ops) / total if total else None,
        "by_span": by_span(line, gaps, ops, (w0, w1)),
        "idle_under_spans_us": idle_under_spans_us(line, gaps),
        "solve_us": solve_device_us(line, ops),
    }
