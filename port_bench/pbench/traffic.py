"""The one generator of jobs: a traffic mix's parameters and the run's
seed in, an endless closed-loop sequence of jobs out.

A mix names its entry point (``secure_fit`` or ``secure_cv_path``), its
λ grid and, under ``args``, the entry's own keyword arguments, which the
harness passes through as they stand; the seed decides only the order of the λ grid's
points and each job's protocol and fold seeds.  Every seed therefore
gets the same work: each block of as many fits as the grid has points
runs every λ once, in an order drawn from the seed.
"""
from __future__ import annotations

import itertools

import numpy as np

from .data import derive_seed

ENTRIES = ("secure_fit", "secure_cv_path")


def lambda_grid(traffic: dict) -> list[float]:
    """The mix's λ grid, descending: ``{"logspace": [start, stop, num]}``
    in powers of ten."""
    start, stop, num = traffic["lambdas"]["logspace"]
    return [float(v) for v in np.logspace(start, stop, int(num))]


def jobs(traffic: dict, seed: int, stream: int = 1):
    """Endless job dicts for ``traffic`` from ``seed``.  ``stream``
    separates the warm-up's jobs from the window's."""
    entry = traffic["entry"]
    if entry not in ENTRIES:
        raise ValueError(f"unknown entry {entry!r}; known: {ENTRIES}")
    grid = lambda_grid(traffic)
    rng = np.random.default_rng(derive_seed(seed, stream))
    for i in itertools.count():
        if entry == "secure_fit":
            if i % len(grid) == 0:
                order = rng.permutation(len(grid))
            yield {"index": i, "lam": grid[order[i % len(grid)]],
                   "seed": int(rng.integers(0, 2**62))}
        else:
            yield {"index": i, "lambdas": grid,
                   "seed": int(rng.integers(0, 2**62)),
                   "fold_seed": int(rng.integers(0, 2**31))}
