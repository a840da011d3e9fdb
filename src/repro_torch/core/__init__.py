"""Paper core: secure, distributed L2-regularized logistic regression.

Module map (each the counterpart of the JAX package's module of the same
name):

* ``field``, ``fixed_point``, ``flatbuf``, ``shamir`` — the field, the
  codec, the flat wire layout and the leaf-wise Shamir oracle;
* ``logreg``, ``batched_summaries`` — per-institution summaries, batched
  over the packed partitions (K3) and over (config, institution) pairs
  with fold masks (K5);
* ``collective`` (``secure_agg`` re-exports it) — the one protect ->
  aggregate -> reveal chain (K1, K2), the multi-config round,
  ``round_key`` and the ``round_bytes`` wire model;
* ``newton`` — the stopping rule, Newton/prox steps, ``SecureFitDriver``
  and ``secure_fit`` (loop, fused, scan rounds);
* ``scanfit`` — blocks of rounds with one trace read-back;
* ``protocol`` — the deployment shape: ``Institution``,
  ``ComputationCenter``, ``StudyCoordinator``;
* ``multistudy`` — M independent studies advanced by one collective
  round.

``shamir``'s kernel backend shares leaf-wise through K4 and reconstructs
through K2's residues mode.
"""
from .batched_summaries import (
    CVSummaries,
    PackedPartitions,
    batched_cv_summaries,
    batched_local_summaries,
    pack_cache_evict,
    pack_partitions,
)
from .collective import (
    FlatProtected,
    SecureCollective,
    check_aggregation_headroom,
    declassify_sum,
)
from .field import FIELD31, FIELD_WIDE, FieldSpec
from .fixed_point import FixedPointCodec
from .flatbuf import (
    FlatLayout,
    pack_pytree,
    pack_pytree_batched,
    unpack_pytree,
    unpack_pytree_batched,
)
from .logreg import LocalSummaries, deviance, local_summaries, predict_proba
from .multistudy import (
    fused_multistudy_iteration,
    run_multistudy_rounds,
    stack_studies,
)
from .newton import (
    FitResult,
    RoundReport,
    SecureFitDriver,
    centralized_fit,
    newton_step,
    prox_newton_step,
    secure_fit,
)
from .protocol import ComputationCenter, Institution, StudyCoordinator
from .scanfit import fit_scan_block, scan_rounds
from .secure_agg import SecureAggregator
from .shamir import ShamirScheme

__all__ = [
    "FIELD31", "FIELD_WIDE", "FieldSpec", "FixedPointCodec", "ShamirScheme",
    "FlatLayout", "FlatProtected", "pack_pytree", "pack_pytree_batched",
    "unpack_pytree", "unpack_pytree_batched",
    "PackedPartitions", "batched_local_summaries", "pack_partitions",
    "pack_cache_evict", "CVSummaries", "batched_cv_summaries",
    "SecureAggregator", "SecureCollective", "check_aggregation_headroom",
    "declassify_sum",
    "LocalSummaries", "local_summaries", "predict_proba", "deviance",
    "FitResult", "RoundReport", "SecureFitDriver", "centralized_fit",
    "newton_step", "prox_newton_step", "secure_fit",
    "Institution", "ComputationCenter", "StudyCoordinator",
    "scan_rounds", "fit_scan_block",
    "stack_studies", "fused_multistudy_iteration", "run_multistudy_rounds",
]
