"""Protocol observability for the port: span tracing, metrics, privacy ledger.

Stdlib-only copies of the JAX package's observability core, kept in the
port so that it imports nothing of the JAX package:

* :mod:`repro_torch.obs.trace`  — ring-buffered host span tracer on the
  profiler's clock (ids, parents, jobs) with JSONL / Chrome-trace
  exporters and an optional ``torch.profiler`` range hook;
* :mod:`repro_torch.obs.ledger` — typed execution counters on every
  ``_protect_flat`` / ``_reveal_flat`` / ``declassify_sum`` boundary;
* :mod:`repro_torch.obs.metrics` — labeled counters/gauges (rounds,
  bytes, the host's reads of device values) + Prometheus textfile export,
  and the ring-collective byte conventions;
* :mod:`repro_torch.obs.gate` — the privacy gate's hook points (the
  boundaries, named-axis collectives and kernel wrappers declared to it).

The audit (:mod:`repro_torch.obs.audit`, ``python -m repro_torch.obs
audit``) reconciles the ledger against the gate's certified census; it
imports the gate (``repro_torch.analysis``) and loads only behind the CLI,
tests and ``chip_smoke.py``.
"""
from . import gate, ledger, metrics, trace  # noqa: F401

__all__ = ["gate", "ledger", "metrics", "trace"]
