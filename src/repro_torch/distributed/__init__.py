"""Distributed execution: meshes and the multi-device secure wires.

The torch counterpart of the JAX package's ``distributed/``: a rank of a
``torch.distributed`` process group is the SPMD program (JAX's
``shard_map`` has no counterpart), a ``DeviceMesh`` with named dimensions
is the mesh (:mod:`.compat`), and :mod:`.multihost` is the launcher layer
around the wires on :class:`repro_torch.core.collective.SecureCollective`.

The LM's tensor-parallel sharding rules (:mod:`.sharding`:
``MeshRules``, ``param_pspec``, ``param_shardings``, ``shard_params``)
say which block of each parameter a rank holds; the models run each
rank's part under ``rules=`` (:mod:`._tp`), with the collectives of
:mod:`.compat`.

Lazy re-exports (PEP 562), as in the JAX package: ``core.collective``
imports ``distributed.compat`` while ``multihost`` imports
``core.collective``, so no submodule loads before its first use.
"""
from __future__ import annotations

__all__ = ["MeshRules", "POD_AXIS", "SHARE_AXIS", "axis_index",
           "axis_size", "initialize_distributed", "make_mesh",
           "param_pspec", "param_shardings", "pod_mesh", "pod_share_mesh",
           "run_scanned_rounds", "scan_secure_rounds", "secure_psum_2d",
           "shard_params", "use_mesh"]

_COMPAT = ("axis_index", "axis_size", "make_mesh", "use_mesh")
_SHARDING = ("MeshRules", "POD_AXIS", "SHARE_AXIS", "param_pspec",
             "param_shardings", "shard_params")
_MULTIHOST = ("initialize_distributed", "pod_mesh", "pod_share_mesh",
              "run_scanned_rounds", "scan_secure_rounds", "secure_psum_2d")


def __getattr__(name: str):
    if name in _COMPAT:
        from . import compat
        return getattr(compat, name)
    if name in _SHARDING:
        from . import sharding
        return getattr(sharding, name)
    if name in _MULTIHOST:
        from . import multihost
        return getattr(multihost, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
