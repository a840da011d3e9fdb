"""Evaluation datasets shaped like the paper's four studies.

The JAX package's ``data/datasets.py``: Insurance (COIL 2000; 9,822 x 84,
5 institutions), Parkinsons.Motor / Parkinsons.Total (5,875 x 20, 5
institutions; the same covariates with two responses) and a 1M x 6
Synthetic study (6 institutions), as deterministic stand-ins with the
same shapes and institution splits: logistic responses over correlated
Gaussian covariates.

The draws are not JAX's: a seeded CPU ``torch.Generator`` takes the place
of ``jax.random``, so tests that hold the two packages together feed
JAX's arrays through numpy.  One deviation beyond the stream: JAX seeds a
study with ``hash(name)``, which Python randomises per process; the port
uses ``zlib.crc32(name)``, so a port study depends only on (name, seed,
scale).
"""
from __future__ import annotations

import dataclasses
import zlib

import torch

from .._device import resolve_device
from .partition import partition_rows
from .synthetic import generate_synthetic

__all__ = ["Study", "load_study", "STUDIES"]

STUDIES = ("insurance", "parkinsons.motor", "parkinsons.total", "synthetic")


@dataclasses.dataclass
class Study:
    name: str
    parts: list  # [(X_j, y_j)] per institution
    lam: float = 1.0

    @property
    def num_samples(self) -> int:
        return sum(int(p[0].shape[0]) for p in self.parts)

    @property
    def num_features(self) -> int:
        return int(self.parts[0][0].shape[1])

    def pooled(self):
        X = torch.cat([p[0] for p in self.parts], dim=0)
        y = torch.cat([p[1] for p in self.parts], dim=0)
        return X, y


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _logistic_X(gen, n, d, rho=0.3):
    """[1 | correlated covariates] (n, d) float64."""
    common = torch.randn((n, 1), generator=gen, dtype=torch.float64)
    eps = torch.randn((n, d - 1), generator=gen, dtype=torch.float64)
    cov = rho**0.5 * common + (1 - rho)**0.5 * eps
    return torch.cat([torch.ones((n, 1), dtype=torch.float64), cov], dim=1)


def _logistic_y(gen, X, half_width):
    """Bernoulli(sigmoid(X beta)) with beta ~ U(-half_width, half_width)."""
    beta = (torch.rand((X.shape[1],), generator=gen, dtype=torch.float64)
            * 2.0 - 1.0) * half_width
    return torch.bernoulli(torch.sigmoid(X @ beta), generator=gen)


def load_study(name: str, seed: int = 0, scale: float = 1.0,
               device=None) -> Study:
    """``scale`` shrinks row counts for quick runs (1.0 = paper size).
    Drawn on the CPU, then moved to ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)

    def rows(n):
        return max(64, int(n * scale))

    def on_device(parts):
        return [(X.to(dev), y.to(dev)) for X, y in parts]

    if name == "insurance":
        gen = _generator(zlib.crc32(name.encode()) % 2**31 + seed)
        X = _logistic_X(gen, rows(9_822), 84)
        y = _logistic_y(gen, X, 0.8)
        return Study("insurance", on_device(partition_rows(X, y, 5)))
    if name in ("parkinsons.motor", "parkinsons.total"):
        # same covariates, different response (the paper's two
        # sub-studies)
        X = _logistic_X(_generator(424242 + seed), rows(5_875), 20)
        y = _logistic_y(_generator(zlib.crc32(name.encode()) % 2**31 + seed),
                        X, 0.6)
        return Study(name, on_device(partition_rows(X, y, 5)))
    if name == "synthetic":
        study = generate_synthetic(
            zlib.crc32(name.encode()) % 2**31 + seed, num_institutions=6,
            records_per_institution=rows(1_000_000 // 6), dim=6,
            device="cpu")
        return Study("synthetic", on_device(study.parts))
    raise KeyError(f"unknown study {name!r}")
