"""Secure model selection: cross-validated regularization paths.

A consortium must *choose* λ, and per-fold validation statistics are
per-institution summaries the threat model says must never be revealed.
This package runs the whole (λ-grid x K-fold) sweep through the Shamir
pipeline: fold masks composed onto the packed row masks (kernel K5), a
leading configuration axis over protect -> aggregate -> reveal, blocks of
rounds with per-round generators from (seed, slot), warm starts along the
descending λ path, and a 1-SE-rule pick with a warm-started refit.

Entry points: ``secure_cv_path`` (in-process, fixed partitions) and
``SelectionCoordinator`` (deployment-shaped: fault tolerance, churn-safe
folds, mid-path resume).
"""
from .coordinator import SelectionCoordinator
from .folds import assign_folds, pack_fold_ids
from .path import PathDriver, PathSettings, secure_cv_path
from .report import PathReport, one_se_rule

__all__ = [
    "SelectionCoordinator",
    "assign_folds", "pack_fold_ids",
    "PathDriver", "PathSettings", "secure_cv_path",
    "PathReport", "one_se_rule",
]
