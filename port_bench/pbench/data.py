"""A cell's data, drawn on the device from the seed in a few large calls.

The configuration gives the source's shape (rows, features, the share of
positive labels) and the consortium's split; the values are drawn here,
as its ``assumed`` says: features standard normal, a true coefficient
vector normal with standard deviation ``signal / sqrt(d)``, and labels
Bernoulli(sigmoid(x . beta + offset)), the offset set so that the labels'
positive share is about the source's.  The true coefficients are the
configuration's, drawn once from its ``beta_seed``; the features and the
labels are the run's, drawn from its seed.  So every seed poses the same
problem to the same depth (a fit's rounds follow the coefficients, not the
rows' draw), on rows of its own.  The institutions' parts are views of one
float64 (rows, d) buffer, split in ``split_sizes``' ramp.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def derive_seed(seed: int, *stream: int) -> int:
    """A 62-bit seed for one stream of the run, from the run's seed
    (any whole number, negative or past 64 bits included)."""
    entropy = [int(seed) % 2**64, *(int(s) for s in stream)]
    return int(np.random.default_rng(entropy).integers(0, 2**62))


def split_sizes(total: int, parts: int, ramp: float) -> list[int]:
    """Near-even horizontal split: a linear ramp of +-``ramp`` around the
    mean, the remainder on the last part."""
    base = total // parts
    sizes = [base + int(base * ramp * (2 * j / max(parts - 1, 1) - 1))
             for j in range(parts)]
    sizes[-1] += total - sum(sizes)
    return sizes


def positive_offset(share: float) -> float:
    """The offset whose logistic is ``share``: with a symmetric linear
    term, the labels' positive share is close to it."""
    return math.log(share / (1.0 - share))


def make_parts(config: dict, seed: int, device) -> list:
    """The S institutions' (X_j, y_j), float64 on ``device``."""
    n, d, s = config["rows"], config["features"], config["institutions"]
    assumed = config["assumed"]
    f64 = dict(dtype=torch.float64, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(assumed["beta_seed"])
    beta = torch.randn((d,), generator=gen, **f64) * (
        assumed["signal"] / math.sqrt(d))
    gen.manual_seed(derive_seed(seed, 0))
    X = torch.randn((n, d), generator=gen, **f64)
    eta = X @ beta + positive_offset(config["positive_share"])
    y = (torch.rand((n,), generator=gen, **f64)
         < torch.sigmoid(eta)).to(torch.float64)
    parts, at = [], 0
    for size in split_sizes(n, s, config["split_ramp"]):
        parts.append((X[at:at + size], y[at:at + size]))
        at += size
    return parts
