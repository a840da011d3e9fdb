"""Batched per-institution summaries: the local phase without the S loop.

The ragged partitions are packed ONCE per fit into a stacked
(S, N_max, d) layout with per-institution row counts, and every
institution's (H_j, g_j, dev_j) comes out of one batched call per
iteration.  Three rungs of precision:

* ``backend="kernel"`` — the port's name for the JAX package's
  ``"pallas"`` rung: one K3 launch (``kernels/fused_irls.py``) for all S
  institutions, float32 Gram, float64 g/dev.
* ``backend="reference"`` — the masked float64 oracle
  (``kernels/ref.py::fused_irls``).
* ``backend="mixed"`` — float64 g/dev with a split-accumulation float32
  Gram (chunked float32 products merged in float64).

Rows >= counts[s] are zero AND masked, so the stacked layout is exact for
arbitrarily uneven partitions.

``batched_cv_summaries`` is the cross-validated variant for the
model-selection sweep: fold masks composed onto the same packed batch, one
pass emitting every (configuration, institution) pair's train-fold
summaries and held-out metrics, on the same three rungs (K5 on "kernel").
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..kernels import ops, ref
from ..obs.trace import traced as _traced
from .logreg import LocalSummaries

__all__ = ["PackedPartitions", "pack_partitions", "pack_cache_clear",
           "pack_cache_evict", "pack_cache_len", "batched_local_summaries",
           "CVSummaries", "batched_cv_summaries", "BACKENDS"]

BACKENDS = ("reference", "kernel", "mixed")


@dataclasses.dataclass(frozen=True)
class PackedPartitions:
    """Stacked ragged partitions + the facts the kernels need.

    ``X``/``y`` are zero-padded to (S, N_max, d); ``y`` is float64 and
    ``X`` the payload dtype ``pack_partitions`` was given.  ``X32`` is the
    float32 copy fed to the Gram (cast once per fit, not per iteration);
    for a float32 payload it is ``X`` itself, one buffer in all.
    """

    X: torch.Tensor  # (S, N_max, d) float64 or float32 payload
    X32: torch.Tensor  # (S, N_max, d) float32 Gram operand
    y: torch.Tensor  # (S, N_max) float64
    counts: torch.Tensor  # (S,) int32 true row counts

    @property
    def num_institutions(self) -> int:
        return self.X.shape[0]

    @property
    def total_records(self) -> int:
        return int(self.counts.sum())

    @property
    def dim(self) -> int:
        return self.X.shape[2]


# LRU pack cache.  Unlike jax arrays, torch tensors are mutable, so a part
# is identified by (id, data_ptr, _version): an in-place edit bumps
# _version and misses the cache, a new buffer changes data_ptr.  Each
# entry holds a weakref to every part tensor whose finalizer evicts the
# entry when any referent is collected, so a recycled id never aliases a
# dead tensor and the cache pins no input (only the packed outputs,
# bounded by _PACK_CACHE_SIZE entries).
_PACK_CACHE: "collections.OrderedDict[tuple, tuple[list, PackedPartitions]]" \
    = collections.OrderedDict()
_PACK_CACHE_SIZE = 4


def _tensor_key(t: torch.Tensor) -> tuple:
    return (id(t), t.data_ptr(), t._version)


def _pack_cache_key(parts, dtype: torch.dtype) -> tuple:
    return (tuple((_tensor_key(X), _tensor_key(y)) for X, y in parts),
            dtype)


def pack_cache_clear() -> None:
    """Drop every cached pack (the packed buffers become collectable)."""
    _PACK_CACHE.clear()


def pack_cache_evict(parts, dtype: torch.dtype | None = None) -> None:
    """Evict every cached pack that includes one of ``parts``' tensors.

    The coordinator's churn hook: an institution that joins or leaves
    takes every pack built around its tensors with it, so no later cohort
    reuses a stale padded batch (the weakref finalizers cover collected
    tensors; this covers live ones leaving a cohort).  ``dtype=None``
    evicts across payload dtypes; a dtype evicts only that payload's packs.
    """
    ids = {id(t) for part in parts for t in part}
    for key in list(_PACK_CACHE):
        part_keys, key_dtype = key
        if dtype is not None and key_dtype != dtype:
            continue
        if any(kx[0] in ids or ky[0] in ids for kx, ky in part_keys):
            _PACK_CACHE.pop(key, None)


def pack_cache_len() -> int:
    """Packs the cache holds."""
    return len(_PACK_CACHE)


def pack_partitions(
    parts: Sequence[tuple[torch.Tensor, torch.Tensor]],
    dtype: torch.dtype = torch.float64,
) -> PackedPartitions:
    """Stack S ragged (X_j, y_j) partitions into one masked batch.

    Once per study: repeated calls with the same, unmodified part tensors
    and the same ``dtype`` return the cached pack.  The pack lives on the
    parts' device.  ``dtype`` is the X payload: float64 keeps the exact
    payload beside a float32 Gram operand; float32 stores one float32
    buffer for both (the summaries widen it to float64 per call, exactly).
    """
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"dtype must be float64 or float32, got {dtype}")
    if not parts:
        raise ValueError("need at least one partition")
    d = parts[0][0].shape[1]
    if any(Xj.shape[1] != d for Xj, _ in parts):
        raise ValueError("all partitions must share the feature dimension")
    key = _pack_cache_key(parts, dtype)
    hit = _PACK_CACHE.get(key)
    if hit is not None:
        _PACK_CACHE.move_to_end(key)
        return hit[1]
    counts = [Xj.shape[0] for Xj, _ in parts]
    n_max = max(counts)
    device = parts[0][0].device
    Xs = torch.stack([
        F.pad(Xj.to(dtype), (0, 0, 0, n_max - Xj.shape[0]))
        for Xj, _ in parts
    ])
    ys = torch.stack([
        F.pad(yj.to(torch.float64), (0, n_max - yj.shape[0]))
        for _, yj in parts
    ])
    packed = PackedPartitions(
        Xs, Xs if dtype == torch.float32 else Xs.to(torch.float32), ys,
        torch.tensor(counts, dtype=torch.int32, device=device),
    )
    # evict-on-collect: if ANY part tensor dies, its id may be recycled
    evict = lambda _ref, key=key: _PACK_CACHE.pop(key, None)  # noqa: E731
    refs = [weakref.ref(t, evict) for part in parts for t in part]
    _PACK_CACHE[key] = (refs, packed)
    while len(_PACK_CACHE) > _PACK_CACHE_SIZE:
        _PACK_CACHE.popitem(last=False)
    return packed


# Gram chunk length for the mixed rung (the JAX package's value)
MIXED_GRAM_CHUNK = 1024


def _mixed_gram(Xw, X32, chunk: int = MIXED_GRAM_CHUNK):
    """Split-accumulation Gram Xw^T X32 (S, d, d) float64: float32
    products over ``chunk``-row slabs, merged across slabs in float64."""
    s_dim, n, d = Xw.shape
    num_chunks = -(-n // chunk)
    pad = num_chunks * chunk - n

    def slabs(a):
        return F.pad(a, (0, 0, 0, pad)).reshape(s_dim, num_chunks, chunk, d)

    # (S, nc, d, d) float32 partial Grams
    Hc = slabs(Xw.to(torch.float32)).transpose(2, 3) @ slabs(X32)
    return Hc.to(torch.float64).sum(dim=1)


def _mixed_summaries(beta, X, X32, y, counts):
    """float64 g/dev + split-accumulation float32 Gram."""
    w, g, dev = ref.masked_irls_terms(beta, X, y, counts)
    return _mixed_gram(X * w[..., None], X32), g, dev


@_traced("summaries")
def batched_local_summaries(
    beta: torch.Tensor,
    packed: PackedPartitions,
    backend: str = "kernel",
) -> LocalSummaries:
    """All S institutions' summaries in one call.

    Returns a ``LocalSummaries`` whose fields carry a leading S axis:
    hessian (S, d, d), gradient (S, d), deviance (S,), count (S,), all
    float64 except count.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}")
    X, y, counts = packed.X.to(torch.float64), packed.y, packed.counts
    if backend == "mixed":
        H, g, dev = _mixed_summaries(beta, X, packed.X32, y, counts)
    elif backend == "kernel":
        H, g, dev = ops.fused_irls(beta, X, y, counts,
                                   mxu_operand=packed.X32)
        # protocol dtype: the fixed-point encode needs float64 past 2**24
        H = H.to(torch.float64)
    else:
        H, g, dev = ref.fused_irls(beta, X, y, counts)
    return LocalSummaries(H, g, dev, counts)


# -- cross-validated summaries: fold masks over the SAME packed batch --------

class CVSummaries(NamedTuple):
    """Per-(config, institution) train summaries + held-out metrics.

    Every field carries leading (C, S) axes — C path configurations
    (lambda x fold pairs, plus a full-data fit with ``fold == -1``) over S
    institutions — all float64.  The validation fields are
    per-institution secrets exactly like H/g/dev: they only ever leave an
    institution secret-shared.
    """

    hessian: torch.Tensor  # (C, S, d, d) train-fold Gram
    gradient: torch.Tensor  # (C, S, d) train-fold score
    deviance: torch.Tensor  # (C, S) train-fold -2 log L
    count: torch.Tensor  # (C, S) train-fold row count
    val_deviance: torch.Tensor  # (C, S) held-out -2 log L
    val_correct: torch.Tensor  # (C, S) held-out correct predictions
    val_count: torch.Tensor  # (C, S) held-out row count


@_traced("summaries")
def batched_cv_summaries(
    betas: torch.Tensor,
    packed: PackedPartitions,
    fold_ids: torch.Tensor,
    fold_of: torch.Tensor,
    backend: str = "kernel",
) -> CVSummaries:
    """All (config, institution) train summaries + held-out metrics in one
    pass over the packed batch — no per-fold repacking.

    ``betas`` (C, d) holds one Newton iterate per configuration,
    ``fold_ids`` (S, N_max) each row's fold (padding rows may hold
    anything: the row mask excludes them), ``fold_of`` (C,) each
    configuration's held-out fold (-1: none).  ``backend`` is the rung of
    ``batched_local_summaries``: "reference" float64 end to end, "kernel"
    one K5 launch (float32 Gram), "mixed" a split-accumulation float32
    Gram.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}")
    fold_ids = fold_ids.to(torch.int32)
    fold_of = fold_of.to(torch.int32)
    X, y, counts = packed.X.to(torch.float64), packed.y, packed.counts
    if backend == "kernel":
        H, g, dev_tr, dev_va, acc_va, n_va = ops.fused_irls_cv(
            betas, X, y, fold_ids, fold_of, counts=counts,
            mxu_operand=packed.X32,
        )
        H = H.to(torch.float64)
    else:
        w, g, dev_tr, dev_va, acc_va, n_va = ref.masked_cv_terms(
            betas, X, y, counts, fold_ids, fold_of)
        # one configuration at a time: an (S, N, d) temporary, not (C, ...)
        if backend == "reference":
            H = torch.stack([torch.einsum("sni,snj->sij",
                                          X * w_c[..., None], X)
                             for w_c in w])
        else:  # mixed: chunked float32 products merged in float64
            H = torch.stack([_mixed_gram(X * w_c[..., None], packed.X32)
                             for w_c in w])
    # train and held-out rows partition the valid rows (also for
    # fold_of == -1, where n_va == 0): no (C, S, N) mask needed
    n_tr = counts[None, :].to(torch.float64) - n_va
    return CVSummaries(H, g, dev_tr, n_tr, dev_va, acc_va, n_va)
