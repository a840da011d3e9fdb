"""What the logistic-regression mixes' job generators share: the λ grid a
mix names.

Each entry's generator lives in its module (``port_bench/entries/``): a
mix's parameters and the run's seed in, an endless closed-loop sequence
of jobs out.  A logistic-regression mix names its λ grid and, under
``args``, the entry's own keyword arguments, which the harness passes
through as they stand; the seed decides only the order of the grid's
points and each job's protocol and fold seeds, so every seed gets the
same work.
"""
from __future__ import annotations

import numpy as np


def lambda_grid(traffic: dict) -> list[float]:
    """The mix's λ grid, descending: ``{"logspace": [start, stop, num]}``
    in powers of ten."""
    start, stop, num = traffic["lambdas"]["logspace"]
    return [float(v) for v in np.logspace(start, stop, int(num))]
