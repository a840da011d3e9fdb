"""One ``torch.profiler`` capture of a part of the run and its reduction
to what the per-layer readers take: device time by kernel category, the
device time of the program's secure-round spans, the card's busy time in
the traced window, and the breakdown of the longest device operations
and idle gaps.

The program's spans (``repro_torch.obs.trace``, enabled with
``profiler=True``) become ``record_function`` ranges on the host.  The
profiler links each kernel to the innermost op or range that launched it;
the device work of the ops inside a ``SecureCollective.secure_round*``
span is the collective's: K1, the field sums, K2 and the packing around
them.  (The device timeline's own annotations of those ranges cover only
the kernels launched directly in them, not in ops nested inside, so they
are not used.)
"""
from __future__ import annotations

import collections

from .categories import CATEGORIES, category

WINDOW_LABEL = "port_bench.traced_window"
COLLECTIVE_SPAN = "SecureCollective.secure_round"
TOP = 10


def _host_activity(gaps, host_events):
    """Name each idle gap by the innermost host event under its midpoint
    (program spans and PyTorch ops nest on the driving thread)."""
    events = sorted(host_events, key=lambda e: (e[0], -e[1]))
    named = collections.defaultdict(float)
    stack, i = [], 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (a + b) / 2
        while i < len(events) and events[i][0] <= mid:
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        named[stack[-1][2] if stack else "host, outside any op"] += b - a
    return named


def _in_span(op) -> bool:
    """Whether a host op lies inside a collective span (the ops nest)."""
    while op is not None and not op.name.startswith(COLLECTIVE_SPAN):
        op = op.cpu_parent
    return op is not None


def capture(run, device, categories=CATEGORIES):
    """Run ``run()`` under the profiler; returns (its result, summary).

    The summary's times are microseconds on the profiler's clock:
    ``window_us`` the traced window, ``busy_us`` the union of device
    operations in it, ``by_category_us`` and ``collective_us`` device
    time (the latter None where no op under a collective span launched
    device work), and ``breakdown`` the result line's lists (seconds).
    ``categories`` is the kernel-name table ``by_category_us`` sorts
    by (``pbench/categories.py``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.obs import trace as program_trace

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    program_trace.enable(profiler=True)
    try:
        with profile(activities=acts) as prof:
            with record_function(WINDOW_LABEL):
                result = run()
                if device.type == "cuda":
                    torch.cuda.synchronize()
    finally:
        program_trace.disable()
    events = prof.events()
    window = next(e for e in events if e.name == WINDOW_LABEL
                  and e.device_type == DeviceType.CPU)
    w0, w1 = window.time_range.start, window.time_range.end
    thread = window.thread
    kernels, host, collective, in_span = [], [], 0.0, 0
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # the device timeline's mirrors of host ranges are no work
            if not getattr(e, "is_user_annotation", False) and b > w0 \
                    and a < w1:
                kernels.append((max(a, w0), min(b, w1), e.name))
        elif e.thread == thread and e.name != WINDOW_LABEL:
            if b > a:
                host.append((a, b, e.name))
            # the device work the profiler links to this op
            if e.kernels and _in_span(e):
                collective += sum(k.duration for k in e.kernels)
                in_span += 1
    by_name = collections.defaultdict(lambda: [0, 0.0])
    by_cat = collections.defaultdict(float)
    for a, b, name in kernels:
        by_name[name][0] += 1
        by_name[name][1] += b - a
        by_cat[category(name, categories)] += b - a
    merged = []
    for a, b, _ in sorted(kernels):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    edges = [w0] + [x for m in merged for x in m] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle = _host_activity(gaps, host)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    top_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    summary = {
        "window_us": w1 - w0,
        "busy_us": sum(b - a for a, b in merged),
        "by_category_us": dict(by_cat),
        # None where no device work lies under a collective span (the
        # span renamed, or the program's spans off): never 0 for want of
        # a span
        "collective_us": collective if in_span and collective > 0
        else None,
        "breakdown": {
            "device_ops": [[n[:160], us * 1e-6] for n, (_, us) in top_ops],
            "idle_gaps": [[n[:160], us * 1e-6] for n, us in top_gaps],
        },
    }
    return result, summary
