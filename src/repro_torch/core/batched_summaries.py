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
arbitrarily uneven partitions.  The cross-validated variant of the JAX
package (``batched_cv_summaries``) belongs to the model-selection slice.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Sequence

import torch
import torch.nn.functional as F

from ..kernels import ops, ref
from .logreg import LocalSummaries

__all__ = ["PackedPartitions", "pack_partitions", "batched_local_summaries",
           "BACKENDS"]

BACKENDS = ("reference", "kernel", "mixed")


@dataclasses.dataclass(frozen=True)
class PackedPartitions:
    """Stacked ragged partitions + the facts the kernels need.

    ``X``/``y`` are zero-padded to (S, N_max, d) float64; ``X32`` is the
    float32 copy fed to the Gram (cast once per fit, not per iteration).
    """

    X: torch.Tensor  # (S, N_max, d) float64
    X32: torch.Tensor  # (S, N_max, d) float32 Gram operand
    y: torch.Tensor  # (S, N_max) float64
    counts: torch.Tensor  # (S,) int32 true row counts


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


def _pack_cache_key(parts) -> tuple:
    return tuple((_tensor_key(X), _tensor_key(y)) for X, y in parts)


def pack_partitions(
    parts: Sequence[tuple[torch.Tensor, torch.Tensor]],
) -> PackedPartitions:
    """Stack S ragged (X_j, y_j) partitions into one masked batch.

    Once per study: repeated calls with the same, unmodified part tensors
    return the cached pack.  The pack lives on the parts' device.
    """
    if not parts:
        raise ValueError("need at least one partition")
    d = parts[0][0].shape[1]
    if any(Xj.shape[1] != d for Xj, _ in parts):
        raise ValueError("all partitions must share the feature dimension")
    key = _pack_cache_key(parts)
    hit = _PACK_CACHE.get(key)
    if hit is not None:
        _PACK_CACHE.move_to_end(key)
        return hit[1]
    counts = [Xj.shape[0] for Xj, _ in parts]
    n_max = max(counts)
    device = parts[0][0].device
    Xs = torch.stack([
        F.pad(Xj.to(torch.float64), (0, 0, 0, n_max - Xj.shape[0]))
        for Xj, _ in parts
    ])
    ys = torch.stack([
        F.pad(yj.to(torch.float64), (0, n_max - yj.shape[0]))
        for _, yj in parts
    ])
    packed = PackedPartitions(
        Xs, Xs.to(torch.float32), ys,
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


def _mixed_summaries(beta, X, X32, y, counts, chunk: int = MIXED_GRAM_CHUNK):
    """float64 g/dev + split-accumulation float32 Gram: float32 products
    over ``chunk``-row slabs, merged across slabs in float64."""
    s_dim, n, d = X.shape
    w, g, dev = ref.masked_irls_terms(beta, X, y, counts)
    num_chunks = -(-n // chunk)
    pad = num_chunks * chunk - n
    Xw32 = (X * w[..., None]).to(torch.float32)

    def slabs(a):
        return F.pad(a, (0, 0, 0, pad)).reshape(s_dim, num_chunks, chunk, d)

    Hc = slabs(Xw32).transpose(2, 3) @ slabs(X32)  # (S, nc, d, d) f32
    return Hc.to(torch.float64).sum(dim=1), g, dev


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
    X, y, counts = packed.X, packed.y, packed.counts
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
