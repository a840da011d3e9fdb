"""Algorithm 3: synthetic dataset generation, partitioned per institution.

Drawn with a ``torch.Generator`` on the target device.  The draws cannot
reproduce ``jax.random``'s, so tests that hold the port against the JAX
package feed the JAX generator's arrays through numpy instead; this
generator serves standalone runs and the chip smoke run.
"""
from __future__ import annotations

import torch

from .._device import resolve_device

__all__ = ["generate_synthetic", "SyntheticStudy"]


class SyntheticStudy(tuple):
    """(beta_true, parts) where parts = [(X_j, y_j)] per institution."""

    @property
    def beta_true(self):
        return self[0]

    @property
    def parts(self):
        return self[1]

    def pooled(self):
        X = torch.cat([p[0] for p in self[1]], dim=0)
        y = torch.cat([p[1] for p in self[1]], dim=0)
        return X, y


def generate_synthetic(
    seed: int = 0,
    num_institutions: int = 6,
    records_per_institution: int = 10_000,
    dim: int = 6,
    mu: float = 0.0,
    sigma: float = 1.0,
    beta_scale: float = 1.0,
    dtype=torch.float64,
    device=None,
) -> SyntheticStudy:
    """Paper Algorithm 3.

    1. beta ~ U(-beta_scale, beta_scale), d-dimensional (incl. intercept).
    2. Per institution j: cov_j ~ N(mu, sigma^2) of shape (N_j, d-1);
       X_j = [1 | cov_j]; p_j = sigmoid(X_j beta); y_j ~ Bernoulli(p_j).
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    beta = (torch.rand((dim,), generator=gen, dtype=dtype, device=dev)
            * 2.0 - 1.0) * beta_scale
    parts = []
    for _ in range(num_institutions):
        cov = mu + sigma * torch.randn(
            (records_per_institution, dim - 1), generator=gen, dtype=dtype,
            device=dev,
        )
        Xj = torch.cat([torch.ones((records_per_institution, 1),
                                   dtype=dtype, device=dev), cov], dim=1)
        pj = torch.sigmoid(Xj @ beta)
        yj = torch.bernoulli(pj, generator=gen)
        parts.append((Xj, yj))
    return SyntheticStudy((beta, parts))
