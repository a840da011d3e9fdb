"""Horizontal (per-institution) partitioning of pooled datasets."""
from __future__ import annotations

__all__ = ["partition_rows", "ragged_sizes", "split_rows"]


def partition_rows(X, y, num_institutions: int):
    """Split rows contiguously into S near-equal institution-local parts.

    Mirrors the paper's "randomly partitioned the dataset horizontally";
    rows are assumed pre-shuffled (the generators draw i.i.d. rows).
    Parts are views of X and y, not copies.
    """
    n = X.shape[0]
    sizes = [n // num_institutions] * num_institutions
    for i in range(n % num_institutions):
        sizes[i] += 1
    return split_rows(X, y, sizes)


def ragged_sizes(total: int, num_institutions: int) -> list[int]:
    """A mildly uneven split: a +-5% linear ramp around the mean (the
    split the JAX package's ``benchmarks/e2e_secure_fit.py`` uses)."""
    base = total // num_institutions
    sizes = [base + int(base * 0.05 * (2 * j / max(num_institutions - 1, 1)
                                       - 1))
             for j in range(num_institutions)]
    sizes[-1] += total - sum(sizes)
    return sizes


def split_rows(X, y, sizes):
    """Contiguous parts of the given sizes (views of X and y)."""
    parts, off = [], 0
    for s in sizes:
        parts.append((X[off:off + s], y[off:off + s]))
        off += s
    return parts
