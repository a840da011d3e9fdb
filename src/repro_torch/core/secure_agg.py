"""Secure aggregation: the import surface over :mod:`.collective` (the
wire names ``secure_psum``, ``ShardedAggregate``, ``REVEAL_MODES`` and
``OUT_MODES`` included), and the share algebra outside its chain.

``SecureAggregator`` is an alias of :class:`SecureCollective`, as in the
JAX package, so code written against either name runs on the port.

Shares of A and B made at the same evaluation points add share-wise into
valid shares of A + B (Algorithm 2), and multiply share-wise by a public
field constant c into valid shares of c A; neither needs the holders to
talk.  :func:`secure_add` and :func:`secure_scale_by_public` do that for
share tensors or trees of them (dicts, lists, tuples), with the port's
int64 field elements.
"""
from __future__ import annotations

from .collective import (  # noqa: F401  (re-exports)
    OUT_MODES,
    REVEAL_MODES,
    FlatProtected,
    SecureCollective,
    ShardedAggregate,
    check_aggregation_headroom,
    declassify_sum,
    secure_psum,
)
from .field import FieldSpec, fadd, fmul
from .flatbuf import tree_flatten, tree_unflatten

__all__ = [
    "check_aggregation_headroom",
    "declassify_sum",
    "FlatProtected",
    "SecureAggregator",
    "SecureCollective",
    "ShardedAggregate",
    "secure_add",
    "secure_psum",
    "secure_scale_by_public",
    "REVEAL_MODES",
    "OUT_MODES",
]

SecureAggregator = SecureCollective


def secure_add(a, b, field: FieldSpec, residue_axis: int = 0):
    """Algorithm 2: share-wise addition of two share tensors or trees of
    one structure.

    ``residue_axis`` is 0 for single-holder slices (R, ...) and 1 for full
    share stacks (w, R, ...).
    """
    leaves_a, treedef = tree_flatten(a)
    leaves_b, treedef_b = tree_flatten(b)
    if treedef_b != treedef:
        raise ValueError("secure_add takes two trees of one structure")
    return tree_unflatten(treedef, [
        fadd(x, y, field, residue_axis) for x, y in zip(leaves_a, leaves_b)])


def secure_scale_by_public(shares, const_field, field: FieldSpec,
                           residue_axis: int = 0):
    """Multiply a secret (in shares) by a public field constant
    ``const_field``, reduced and broadcastable against each leaf."""
    leaves, treedef = tree_flatten(shares)
    return tree_unflatten(treedef, [
        fmul(s, const_field, field, residue_axis) for s in leaves])
