"""Mesh axis names of the secure wires.

The counterpart of the names in the JAX package's
``distributed/sharding.py``.  Its logical-axis rules for the LM's
tensor-parallel sharding (``MeshRules``, ``param_pspec``,
``param_shardings``) are a later slice of the port.
"""
from __future__ import annotations

__all__ = ["POD_AXIS", "SHARE_AXIS"]

# The institution axis: one paper party per pod.  secure_psum's share
# reductions (and the sharded reveal's reduce-scatter) run over this axis.
POD_AXIS = "pod"

# The computation-center axis of the 2D (pod, share) mesh
# (``distributed.multihost``): reveal point j lives on mesh column j, so a
# center-device only ever holds its own share slice and reconstruction is
# a sum of Lagrange-weighted slices over this axis.  Orthogonal to
# POD_AXIS.
SHARE_AXIS = "share"
