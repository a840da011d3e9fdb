"""Runtime privacy-audit ledger: typed counters on every declassification.

This ledger records what the running process actually *did* reveal.
Every execution of a declassification boundary (``_reveal_flat`` /
``declassify_sum``) and of the ``_protect_flat`` encode calls
:func:`record_site` with the site name, a short "what" tag, the static
buffer shape and the scheme threshold.  A test or an audit compares these
counts with the declassifications a driver is expected to make; a
mismatch (e.g. an extra reveal) is a finding.

The port runs eagerly, so each boundary's host wrapper records once per
call: one protect and one reveal per fused round, one protect per
institution and one reveal per round on the loop path.

This module is deliberately stdlib-only (no torch, no numpy): it is
imported by ``repro_torch.core.collective`` at module load, and the hook
must cost one boolean check when disabled.  Only static metadata
(Python ints/strings, ``.shape`` tuples) may be recorded; recording a
value would itself be a leak channel.
"""
from __future__ import annotations

import contextlib
import threading
from collections import Counter

__all__ = [
    "DECLASS_SITES",
    "record_site",
    "enabled",
    "enable",
    "disable",
    "reset",
    "counts",
    "by_site",
    "capture",
    "Capture",
]

# the sanctioned declassification boundaries, by name
DECLASS_SITES = ("_reveal_flat", "_distributed_reveal", "declassify_sum")

_lock = threading.Lock()
_enabled = False
# (site, what, shape, threshold) -> execution count
_counts: Counter = Counter()


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    with _lock:
        _counts.clear()


def record_site(site: str, what: str = "", shape=(), threshold: int = 0
                ) -> None:
    """One execution of a protect/declassify boundary.

    Zero-cost when the ledger is disabled (one attribute read + branch).
    ``shape`` may be a tracer's ``.shape`` — a tuple of Python ints.
    """
    if not _enabled:
        return
    key = (site, str(what), tuple(int(s) for s in shape), int(threshold))
    with _lock:
        _counts[key] += 1


def counts() -> dict:
    """Snapshot of the typed counters: (site, what, shape, threshold) -> n."""
    with _lock:
        return dict(_counts)


def by_site() -> dict:
    """Counts folded to site name -> n (the audit's reconciliation key)."""
    with _lock:
        out: Counter = Counter()
        for (site, _, _, _), n in _counts.items():
            out[site] += n
        return dict(out)


class Capture:
    """Result object of :func:`capture`: the counts recorded inside it."""

    def __init__(self):
        self.counts: dict = {}
        self.by_site: dict = {}


@contextlib.contextmanager
def capture():
    """Enable the ledger for a block and yield the counts recorded in it.

    Restores the previous enabled state on exit; the global counters keep
    accumulating (``capture`` diffs a snapshot, it does not reset).
    """
    global _enabled
    cap = Capture()
    with _lock:
        before = Counter(_counts)
    prev = _enabled
    enable()
    try:
        yield cap
    finally:
        _enabled = prev
        with _lock:
            diff = Counter(_counts)
            diff.subtract(before)
        cap.counts = {k: n for k, n in diff.items() if n > 0}
        folded: Counter = Counter()
        for (site, _, _, _), n in cap.counts.items():
            folded[site] += n
        cap.by_site = dict(folded)
