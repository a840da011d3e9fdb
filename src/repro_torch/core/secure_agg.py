"""Secure aggregation: the import surface over :mod:`.collective`.

``SecureAggregator`` is an alias of :class:`SecureCollective`, as in the
JAX package, so code written against either name runs on the port.
"""
from __future__ import annotations

from .collective import (  # noqa: F401  (re-exports)
    FlatProtected,
    SecureCollective,
    check_aggregation_headroom,
    declassify_sum,
)

__all__ = [
    "check_aggregation_headroom",
    "declassify_sum",
    "FlatProtected",
    "SecureAggregator",
    "SecureCollective",
]

SecureAggregator = SecureCollective
