"""L2-regularized logistic regression: local summary statistics (Eqs. 4-6).

The paper writes the gradient as ``sum (1-p_i) y_i x_i`` (Eq. 5), the
y in {-1,+1} form; for y in {0,1} the same quantity is
``sum (y_i - p_i) x_i``.  Both give identical Newton iterates; this
module uses the {0,1} form, as the JAX package does.

Everything here is local to one institution: plain functions of that
institution's (X_j, y_j) and the current public beta.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["LocalSummaries", "local_summaries", "predict_proba", "deviance"]


class LocalSummaries(NamedTuple):
    """Per-institution summary statistics (the protocol's 'aggregates')."""

    hessian: torch.Tensor  # (d, d)  sum_i w_ii x_i x_i^T   (unregularized)
    gradient: torch.Tensor  # (d,)    sum_i (y_i - p_i) x_i  (unregularized)
    deviance: torch.Tensor  # ()      -2 sum_i log-likelihood_i
    count: torch.Tensor  # ()      N_j (public in the paper's setting)


def _softplus(z: torch.Tensor) -> torch.Tensor:
    # logaddexp(0, z), as jnp.logaddexp; F.softplus switches to the
    # identity past its threshold and drifts from it by ~1e-11 per row
    return torch.logaddexp(torch.zeros_like(z), z)


def predict_proba(beta: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """p(y=1 | x; beta) = sigmoid(X beta)  (Eq. 1)."""
    return torch.sigmoid(X @ beta)


def deviance(beta: torch.Tensor, X: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """-2 log L(beta) (Eq. 6), numerically stable via logaddexp."""
    z = X @ beta
    return -2.0 * torch.sum(y * z - _softplus(z))


def local_summaries(beta: torch.Tensor, X: torch.Tensor,
                    y: torch.Tensor) -> LocalSummaries:
    """Compute H_j, g_j, dev_j for one institution (Algorithm 1 steps 4-6).

    H_j = X_j^T W_j X_j with w_ii = p_i (1 - p_i); g_j = X_j^T (y_j - p_j).
    The lambda terms are center-side and applied in ``newton.newton_step``.
    """
    z = X @ beta
    p = torch.sigmoid(z)
    w = p * (1.0 - p)
    hessian = (X * w[:, None]).T @ X
    gradient = X.T @ (y - p)
    dev = -2.0 * torch.sum(y * z - _softplus(z))
    return LocalSummaries(hessian, gradient, dev,
                          torch.tensor(X.shape[0], device=X.device))
