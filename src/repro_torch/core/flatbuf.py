"""Flat-buffer tree codec for the fused secure-aggregation pipeline.

Packs a tree of float tensors into ONE contiguous ``(rows, 128)`` buffer
so that each protocol phase is a single kernel launch regardless of the
tree's shape.  The layout is the JAX package's, offset for offset, so
wire bytes and reveals agree between the two packages:

* Trees are dicts (flattened in **sorted-key** order, as
  ``jax.tree_util`` flattens dicts), lists or tuples of tensors.
* Leaves are raveled in flatten order and concatenated.
* The tail is zero-padded up to ``rows * 128`` with ``rows`` a multiple
  of ``row_align`` (default 8).  ``LANES`` and ``ROW_ALIGN`` were the
  TPU's tile shape; they stay because the byte count and the reveal
  layout depend on them.
* ``FlatLayout`` remembers the tree structure, shapes and dtypes so
  ``unpack`` is exact.

Padding is benign end to end: zero floats encode to residue 0, shares of
0 aggregate to shares of 0, and the revealed tail is dropped by unpack.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

__all__ = ["LANES", "ROW_ALIGN", "FlatLayout", "tree_flatten",
           "tree_unflatten", "pack_pytree", "pack_pytree_batched",
           "unpack_pytree", "unpack_pytree_batched"]

LANES = 128
ROW_ALIGN = 8


def tree_flatten(tree):
    """(leaves, treedef) with dict keys in sorted order; tensors are leaves."""
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        leaves, defs = [], []
        for k in keys:
            sub, d = tree_flatten(tree[k])
            leaves += sub
            defs.append(d)
        return leaves, ("dict", keys, tuple(defs))
    if isinstance(tree, (list, tuple)):
        leaves, defs = [], []
        for item in tree:
            sub, d = tree_flatten(item)
            leaves += sub
            defs.append(d)
        return leaves, (type(tree).__name__, len(tree), tuple(defs))
    return [tree], None


def _count(treedef) -> int:
    if treedef is None:
        return 1
    return sum(_count(d) for d in treedef[2])


def tree_unflatten(treedef, leaves):
    """Invert ``tree_flatten``."""
    leaves = list(leaves)
    if treedef is None:
        return leaves[0]
    kind, keys, defs = treedef
    out, off = [], 0
    for d in defs:
        n = _count(d)
        out.append(tree_unflatten(d, leaves[off:off + n]))
        off += n
    if kind == "dict":
        return dict(zip(keys, out))
    return tuple(out) if kind == "tuple" else out


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Static description of how a tree maps into one (rows, 128) buffer."""

    treedef: tuple | None
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    rows: int


def _rows_for(n: int, row_align: int) -> int:
    rows = max(1, -(-n // LANES))
    return -(-rows // row_align) * row_align


def _result_dtype(leaves) -> torch.dtype:
    return functools.reduce(torch.promote_types, [l.dtype for l in leaves])


def pack_pytree(tree, dtype=None, row_align: int = ROW_ALIGN
                ) -> tuple[torch.Tensor, FlatLayout]:
    """Pack a float tree into one zero-padded (rows, 128) buffer.

    ``dtype`` defaults to the promoted dtype of the leaves (float64 trees
    stay float64 — required for exact fixed-point encode past 2**24).
    """
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        raise ValueError("cannot pack an empty pytree")
    if dtype is None:
        dtype = _result_dtype(leaves)
    flat = torch.cat([l.reshape(-1).to(dtype) for l in leaves])
    rows = _rows_for(flat.numel(), row_align)
    buf = F.pad(flat, (0, rows * LANES - flat.numel())).reshape(rows, LANES)
    return buf, FlatLayout(treedef, tuple(tuple(l.shape) for l in leaves),
                           tuple(l.dtype for l in leaves), rows)


def pack_pytree_batched(tree, dtype=None, row_align: int = ROW_ALIGN
                        ) -> tuple[torch.Tensor, FlatLayout]:
    """Pack a tree of S-leading tensors into one (S, rows, 128) buffer.

    The returned ``FlatLayout`` describes a SINGLE slice (leaf shapes
    without the batch axis), so the aggregate over S unpacks with plain
    ``unpack_pytree``.
    """
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        raise ValueError("cannot pack an empty pytree")
    batch = leaves[0].shape[0]
    if any(tuple(l.shape[:1]) != (batch,) for l in leaves):
        raise ValueError("all leaves need the same leading batch axis")
    if dtype is None:
        dtype = _result_dtype(leaves)
    flat = torch.cat([l.reshape(batch, -1).to(dtype) for l in leaves],
                     dim=1)  # (S, num_elements)
    rows = _rows_for(flat.shape[1], row_align)
    buf = F.pad(flat, (0, rows * LANES - flat.shape[1]))
    return buf.reshape(batch, rows, LANES), FlatLayout(
        treedef, tuple(tuple(l.shape[1:]) for l in leaves),
        tuple(l.dtype for l in leaves), rows,
    )


def unpack_pytree_batched(buf: torch.Tensor, layout: FlatLayout,
                          dtype=None):
    """Invert ``pack_pytree_batched``: (B, rows, 128) -> tree of
    (B, *shape) leaves."""
    batch = buf.shape[0]
    flat = buf.reshape(batch, -1)
    leaves, offset = [], 0
    for shape, ldt in zip(layout.shapes, layout.dtypes):
        n = math.prod(shape)
        leaves.append(flat[:, offset:offset + n].reshape((batch,) + shape)
                      .to(dtype or ldt))
        offset += n
    return tree_unflatten(layout.treedef, leaves)


def unpack_pytree(buf: torch.Tensor, layout: FlatLayout, dtype=None):
    """Invert ``pack_pytree``: (rows, 128) buffer -> original tree.

    ``dtype`` overrides the per-leaf restore dtype.
    """
    flat = buf.reshape(-1)
    leaves, offset = [], 0
    for shape, ldt in zip(layout.shapes, layout.dtypes):
        n = math.prod(shape)
        leaves.append(flat[offset:offset + n].reshape(shape).to(dtype or ldt))
        offset += n
    return tree_unflatten(layout.treedef, leaves)
