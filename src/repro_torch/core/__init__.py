"""Paper core: secure, distributed L2-regularized logistic regression."""
from .batched_summaries import (
    PackedPartitions,
    batched_local_summaries,
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
from .newton import (
    FitResult,
    RoundReport,
    SecureFitDriver,
    centralized_fit,
    newton_step,
    prox_newton_step,
    secure_fit,
)
from .secure_agg import SecureAggregator
from .shamir import ShamirScheme

__all__ = [
    "FIELD31", "FIELD_WIDE", "FieldSpec", "FixedPointCodec", "ShamirScheme",
    "FlatLayout", "FlatProtected", "pack_pytree", "pack_pytree_batched",
    "unpack_pytree", "unpack_pytree_batched",
    "PackedPartitions", "batched_local_summaries", "pack_partitions",
    "SecureAggregator", "SecureCollective", "check_aggregation_headroom",
    "declassify_sum",
    "LocalSummaries", "local_summaries", "predict_proba", "deviance",
    "FitResult", "RoundReport", "SecureFitDriver", "centralized_fit",
    "newton_step", "prox_newton_step", "secure_fit",
]
