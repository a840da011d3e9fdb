"""Carry a study, a fit's state and LM parameters from the JAX package
into the port.

Every function takes plain numpy values, so nothing here imports JAX.
A JAX state's ``key`` has no torch counterpart and is dropped: the port's
``load_state_dict`` reseeds its generator instead.  That is safe because a
reveal does not depend on the sharing randomness — Lagrange reconstruction
cancels the sharing polynomials exactly — so the resumed run reveals the
same aggregates and follows the same trajectory.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ._device import resolve_device

__all__ = ["state_from_jax", "coordinator_state_from_jax",
           "selection_state_from_jax", "fold_parts_from_jax",
           "lm_params_from_jax", "parts_from_numpy", "adamw_state_from_jax"]

# the JAX SecureFitDriver.state_dict() keys the port carries over
_CARRIED = ("beta", "iteration", "obj_prev", "trace", "converged", "bytes",
            "online", "latency", "centers_online", "round_base")


def state_from_jax(state: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Turn a JAX ``SecureFitDriver.state_dict()`` into the port's:
    every field but the JAX ``key``."""
    return {k: np.asarray(state[k]) for k in _CARRIED if k in state}


def coordinator_state_from_jax(state: dict[str, np.ndarray]
                               ) -> dict[str, np.ndarray]:
    """Turn a JAX ``StudyCoordinator.state_dict()`` into the port's:
    every field but the JAX ``key``."""
    return {k: np.asarray(v) for k, v in state.items() if k != "key"}


def selection_state_from_jax(state: dict[str, np.ndarray],
                             fold_ids: Mapping[str, np.ndarray]
                             ) -> dict[str, np.ndarray]:
    """Turn a JAX ``SelectionCoordinator.state_dict()`` into the port's:
    the sweep state (``path_*``) as it is, the wrapped study's
    (``study_*``) without its ``key``, and the fold ids the JAX run drew
    for each institution (``fold_ids``: name -> (rows,) ids, as its
    ``assign_folds`` gives them) as ``folds_<name>``.  The port draws its
    folds from another generator, so the continued path needs JAX's."""
    if not fold_ids:
        raise ValueError("a JAX checkpoint needs the fold ids it was "
                         "measured on")
    out = {k: np.array(v) for k, v in state.items() if k != "study_key"}
    out.update({f"folds_{name}": np.array(ids, dtype=np.int32)
                for name, ids in fold_ids.items()})
    return out


def fold_parts_from_jax(fold_ids) -> list[torch.Tensor]:
    """The JAX package's per-institution fold ids (as numpy) as the
    port's ``fold_parts``: int32 CPU tensors, one per institution, for
    ``PathDriver.run_chunk``.  The port's own ``assign_folds`` draws other
    (equally balanced) folds, so a run held against the JAX package passes
    these in."""
    return [torch.from_numpy(np.array(f, dtype=np.int32)) for f in fold_ids]


def parts_from_numpy(parts, device=None):
    """Move a study's [(X_j, y_j)] numpy partitions onto the device as
    float64 tensors (``device=None`` means the CUDA card)."""
    dev = resolve_device(device)
    return [
        (torch.as_tensor(np.asarray(X), dtype=torch.float64, device=dev),
         torch.as_tensor(np.asarray(y), dtype=torch.float64, device=dev))
        for X, y in parts
    ]


def _tensor_from_numpy(a, dev) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy the tensor may own
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: torch refuses it
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            dev)
    return torch.from_numpy(a).to(dev)


def lm_params_from_jax(params, device=None):
    """Turn a JAX LM parameter tree (``transformer.init_params``, its
    leaves as numpy arrays) into the port's: the same dicts and lists,
    each leaf a tensor of the same shape, dtype and bits on ``device``
    (``None``: the CUDA card)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _tensor_from_numpy(np.asarray(node), dev)

    return walk(params)


def adamw_state_from_jax(state, device=None):
    """Turn a JAX ``AdamWState`` (``step``, ``mu``, ``nu``; its leaves as
    numpy arrays) into the port's: the step as an int32 scalar tensor and
    the float32 moment trees as ``lm_params_from_jax`` carries
    parameters, on ``device`` (``None``: the CUDA card)."""
    from .optim.adamw import AdamWState

    step, mu, nu = state
    dev = resolve_device(device)
    return AdamWState(
        step=torch.tensor(np.asarray(step), dtype=torch.int32, device=dev),
        mu=lm_params_from_jax(mu, device=dev),
        nu=lm_params_from_jax(nu, device=dev))
