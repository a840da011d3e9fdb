"""Protocol observability for the port: span tracing, metrics, privacy ledger.

Stdlib-only copies of the JAX package's observability core, kept in the
port so that it imports nothing of the JAX package:

* :mod:`repro_torch.obs.trace`  — ring-buffered host span tracer with
  JSONL / Chrome-trace exporters and an optional ``torch.profiler``
  range hook;
* :mod:`repro_torch.obs.ledger` — typed execution counters on every
  ``_protect_flat`` / ``_reveal_flat`` / ``declassify_sum`` boundary;
* :mod:`repro_torch.obs.metrics` — labeled counters/gauges + Prometheus
  textfile export, and the ring-collective byte conventions.
"""
from . import ledger, metrics, trace  # noqa: F401

__all__ = ["ledger", "metrics", "trace"]
