"""The inputs and layouts of one dry-run cell: the JAX package's
``launch/specs.py`` on the port.

Nothing holds data: the inputs are ``meta`` tensors of the shapes and
dtypes JAX's ``ShapeDtypeStruct``s have, and a decode step's caches come
from ``init_cache`` on ``meta``.  A layout is a spec, the tuple the
port's ``param_pspec`` returns (one entry per dimension: None, an axis
or a tuple of axes).  As in JAX, a dimension is split only where its size
divides the mesh axes, so long_500k's batch of one stays whole on every
rank while its window's slots split over "model".
"""
from __future__ import annotations

import torch

from ..distributed.sharding import train_state_specs
from ..models import transformer as T

__all__ = ["batch_shardings", "cache_pspecs", "input_specs",
           "train_state_specs"]

_META = torch.device("meta")


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0 and n >= size


def _one(axes):
    """A one-axis tuple is that axis (``PartitionSpec``'s form)."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def input_specs(cfg, shape) -> dict:
    """The model inputs of one (arch x shape) cell on ``meta``: train
    {"labels", "tokens" or "embeds"}, prefill {"tokens" or "embeds"},
    decode {"length", "caches", "tokens" or "embeds"} with the whole
    (unsharded) zero caches and ``length`` an int32 scalar."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    def empty(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=_META)

    if shape.kind == "train":
        batch = {"labels": empty((B, S), i32)}
        if cfg.frontend == "embeddings":
            batch["embeds"] = empty((B, S, cfg.d_model), bf16)
        else:
            batch["tokens"] = empty((B, S), i32)
        return batch
    if shape.kind == "prefill":
        if cfg.frontend == "embeddings":
            return {"embeds": empty((B, S, cfg.d_model), bf16)}
        return {"tokens": empty((B, S), i32)}
    if shape.kind == "decode":
        step = {"length": empty((), i32),
                "caches": T.init_cache(cfg, B, S, device=_META)}
        if cfg.frontend == "embeddings":
            step["embeds"] = empty((B, cfg.d_model), bf16)
        else:
            step["tokens"] = empty((B,), i32)
        return step
    raise ValueError(shape.kind)


def batch_shardings(specs: dict, rules) -> dict:
    """The data-parallel spec of each batch leaf: the leading (batch)
    dimension over the dp axes where it divides them, a scalar
    replicated; None for each without a mesh."""
    if rules.mesh is None:
        return {k: None for k in specs}

    def one(leaf):
        spec = [None] * leaf.dim()
        if leaf.dim() and _div(leaf.shape[0], rules.dp_size):
            spec[0] = _one(rules.dp_axes)
        return tuple(spec)

    return {k: one(v) for k, v in specs.items()}


def _cache_leaf_pspec(name: str, leaf, rules) -> tuple:
    """A cache leaf is (L_seg, B, T or window, ...): the batch over dp;
    the time axis of K/V-like leaves over "model" (the sequence-sharded
    cache that lets a 32k x 128 decode fit); RG-LRU's carry and conv tail
    over "model" by channel."""
    tp = rules.tp_axis
    spec = [None] * leaf.dim()
    if leaf.dim() >= 2 and _div(leaf.shape[1], rules.dp_size):
        spec[1] = _one(rules.dp_axes)
    if name in ("k", "v", "ckv", "krope") and leaf.dim() >= 3 and _div(
            leaf.shape[2], rules.tp_size):
        spec[2] = tp
    if name == "h" and leaf.dim() == 3 and _div(leaf.shape[2],
                                                 rules.tp_size):
        spec[2] = tp
    if name == "conv" and leaf.dim() == 4 and _div(leaf.shape[3],
                                                    rules.tp_size):
        spec[3] = tp
    return tuple(spec)


def cache_pspecs(caches, rules, cfg=None) -> list:
    """The spec of each leaf of ``caches`` (one dict a segment, the whole
    caches ``init_cache`` lays out without a mesh); None for each without
    a mesh.  ``cfg`` is accepted as JAX's function takes it."""
    return [{name: (None if rules.mesh is None
                    else _cache_leaf_pspec(name, leaf, rules))
             for name, leaf in seg.items()} for seg in caches]
