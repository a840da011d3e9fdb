"""Process metrics registry + Prometheus textfile export + the shared
collective byte conventions.

Two halves:

* **Registry** — labeled counters/gauges the drivers update once per
  round (``repro_rounds_total``, ``repro_round_bytes``,
  ``repro_objective`` / ``repro_grad_norm`` / ``repro_step_norm``) and
  that a privacy ledger can be folded into
  (``repro_declass_total{site=...}``).  :func:`render_prometheus` /
  :func:`export_textfile` emit the standard Prometheus text exposition
  format, ready for the node-exporter textfile collector.
* **Byte conventions** — the one definition of what a ring collective
  moves: an all-reduce moves 2x its result bytes (ring reduce-scatter +
  all-gather phases), a reduce-scatter moves its OPERAND bytes, an
  all-gather its result bytes — so a reduce-scatter + all-gather pair
  over one logical buffer sums to exactly the all-reduce figure.

Stdlib-only on purpose: imported by core driver modules at load time.
"""
from __future__ import annotations

import threading

__all__ = [
    "ALL_REDUCE_FACTOR",
    "REDUCE_SCATTER_FACTOR",
    "ALL_GATHER_FACTOR",
    "all_reduce_bytes",
    "reduce_scatter_bytes",
    "all_gather_bytes",
    "inc",
    "set_gauge",
    "get",
    "snapshot",
    "reset",
    "observe_round",
    "render_prometheus",
    "export_textfile",
]

# -- collective byte conventions (single source of truth) -------------------

ALL_REDUCE_FACTOR = 2.0      # x result bytes: RS phase + AG phase of a ring
REDUCE_SCATTER_FACTOR = 1.0  # x OPERAND bytes: ring moves the full input
ALL_GATHER_FACTOR = 1.0      # x result bytes: the full gathered buffer


def all_reduce_bytes(result_bytes: float) -> float:
    return ALL_REDUCE_FACTOR * result_bytes


def reduce_scatter_bytes(operand_bytes: float) -> float:
    return REDUCE_SCATTER_FACTOR * operand_bytes


def all_gather_bytes(result_bytes: float) -> float:
    return ALL_GATHER_FACTOR * result_bytes


# -- registry ---------------------------------------------------------------

_lock = threading.Lock()
# (name, ((label, value), ...)) -> float
_counters: dict = {}
_gauges: dict = {}


def _key(name: str, labels: dict):
    return name, tuple(sorted(labels.items()))


def inc(name: str, value: float = 1.0, **labels) -> None:
    k = _key(name, labels)
    with _lock:
        _counters[k] = _counters.get(k, 0.0) + value


def set_gauge(name: str, value: float, **labels) -> None:
    with _lock:
        _gauges[_key(name, labels)] = float(value)


def get(name: str, **labels):
    """Current value of a counter or gauge (None if never touched)."""
    k = _key(name, labels)
    with _lock:
        if k in _counters:
            return _counters[k]
        return _gauges.get(k)


def snapshot() -> dict:
    with _lock:
        return {"counters": dict(_counters), "gauges": dict(_gauges)}


def reset() -> None:
    with _lock:
        _counters.clear()
        _gauges.clear()


def observe_round(driver: str, nbytes: int, objective: float | None = None,
                  grad_norm: float | None = None,
                  step_norm: float | None = None, rounds: int = 1) -> None:
    """Per-round driver bookkeeping: one call at each round readback.

    Values come off the SAME marked host-sync the driver already does —
    this function only files already-host-side floats; it never touches
    device values (the obs purity lint would flag a materializer here).
    """
    inc("repro_rounds_total", rounds, driver=driver)
    inc("repro_bytes_total", float(nbytes) * rounds, driver=driver)
    set_gauge("repro_round_bytes", nbytes, driver=driver)
    if objective is not None:
        set_gauge("repro_objective", objective, driver=driver)
    if grad_norm is not None:
        set_gauge("repro_grad_norm", grad_norm, driver=driver)
    if step_norm is not None:
        set_gauge("repro_step_norm", step_norm, driver=driver)


# -- Prometheus text exposition ---------------------------------------------


def _escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _render(series: dict, mtype: str) -> list[str]:
    lines: list[str] = []
    seen: set = set()
    for (name, labels), value in sorted(series.items()):
        if name not in seen:
            seen.add(name)
            lines.append(f"# TYPE {name} {mtype}")
        if labels:
            lab = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
            lines.append(f"{name}{{{lab}}} {value:g}")
        else:
            lines.append(f"{name} {value:g}")
    return lines


def render_prometheus(extra_counters: dict | None = None) -> str:
    """The registry (plus optional extra counter series) as exposition
    text.  ``extra_counters`` maps (name, ((label, value), ...)) -> n —
    the shape :func:`repro_torch.obs.ledger.counts` folds into."""
    snap = snapshot()
    counters = dict(snap["counters"])
    if extra_counters:
        counters.update(extra_counters)
    lines = _render(counters, "counter") + _render(snap["gauges"], "gauge")
    return "\n".join(lines) + ("\n" if lines else "")


def export_textfile(path, extra_counters: dict | None = None) -> str:
    """Write the exposition text for the node-exporter textfile collector."""
    text = render_prometheus(extra_counters)
    with open(path, "w") as fh:
        fh.write(text)
    return text


def ledger_counter_series(by_site: dict) -> dict:
    """Fold ledger site counts into registry-shaped counter series."""
    return {
        ("repro_declass_total", (("site", site),)): float(n)
        for site, n in by_site.items()
        if site != "_protect_flat"
    } | {
        ("repro_protect_total", ()): float(by_site.get("_protect_flat", 0))
    }
