"""PathReport: the selection subsystem's deliverable (a copy of the JAX
package's ``selection/report.py``, which is plain numpy).

Everything in here is computed from *revealed global aggregates* only —
per-λ per-fold validation deviance/accuracy sums over the whole cohort —
so the report is exactly what the paper's threat model allows the
consortium to learn: the CV curve, the selected λ, and the refit beta.
No per-institution validation score ever exists in the clear.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PathReport", "one_se_rule"]


def one_se_rule(lambdas: np.ndarray, cv_mean: np.ndarray,
                cv_se: np.ndarray) -> tuple[int, int]:
    """(best_index, one_se_index) over a DESCENDING λ grid.

    ``best`` minimizes the CV-mean held-out deviance; the 1-SE pick is the
    largest λ (strongest regularization, i.e. earliest index) whose CV
    mean is within one standard error of the best — the standard
    parsimony rule from glmnet-style CV.
    """
    best = int(np.argmin(cv_mean))
    bar = cv_mean[best] + cv_se[best]
    for i in range(len(lambdas)):  # descending: first hit = largest λ
        if cv_mean[i] <= bar:
            return best, i
    return best, best


@dataclasses.dataclass
class PathReport:
    """Cross-validated regularization-path results (revealed aggregates)."""

    lambdas: np.ndarray  # (L,) descending λ grid
    l1: float
    num_folds: int
    protect: str
    summaries_backend: str
    # per-(λ, fold) revealed CV aggregates
    fold_betas: np.ndarray  # (L, K, d) converged train-fold iterates
    fold_rounds: np.ndarray  # (L, K) secure rounds each config consumed
    fold_converged: np.ndarray  # (L, K) bool
    val_deviance: np.ndarray  # (L, K) held-out -2 log L (cohort sum)
    val_correct: np.ndarray  # (L, K) held-out correct predictions (sum)
    val_count: np.ndarray  # (L, K) held-out rows (sum)
    # CV curve + picks
    cv_mean: np.ndarray  # (L,) mean per-record held-out deviance
    cv_se: np.ndarray  # (L,) standard error over folds
    cv_accuracy: np.ndarray  # (L,) pooled held-out accuracy
    best_index: int
    lambda_best: float
    one_se_index: int
    lambda_1se: float
    # final model: full-data refit at lambda_1se (warm-started in-path)
    beta: np.ndarray | None  # (d,) or None when refit=False
    refit_rounds: int
    # telemetry (static shapes; no per-leaf walks anywhere)
    rounds_total: int  # secure rounds actually executed (skips excluded)
    bytes_per_round: int  # wire bytes of one (chunk x cohort) sweep round
    bytes_total: int
    # deviance traces, one entry per chunk: (rounds, C) objective rows as
    # read back in blocks from the scanned sweep
    traces: list = dataclasses.field(default_factory=list)

    def summary_lines(self) -> list[str]:
        """Human-readable CV curve for examples/CLI output."""
        lines = [
            f"{'lambda':>10}  {'cv deviance/row':>16}  {'+/- se':>10}  "
            f"{'heldout acc':>11}  {'rounds':>6}"
        ]
        for i, lam in enumerate(self.lambdas):
            tag = ""
            if i == self.best_index:
                tag += "  <- min"
            if i == self.one_se_index:
                tag += "  <- 1-SE pick"
            lines.append(
                f"{lam:>10.5g}  {self.cv_mean[i]:>16.6f}  "
                f"{self.cv_se[i]:>10.6f}  {self.cv_accuracy[i]:>11.4f}  "
                f"{int(self.fold_rounds[i].max()):>6d}{tag}"
            )
        return lines
