"""Carry a study and a fit's state from the JAX package into the port.

Both functions take plain numpy values, so nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device

__all__ = ["state_from_jax", "parts_from_numpy"]

# the JAX SecureFitDriver.state_dict() keys the port carries over
_CARRIED = ("beta", "iteration", "obj_prev", "trace", "converged", "bytes",
            "online", "latency", "centers_online", "round_base")


def state_from_jax(state: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Turn a JAX ``SecureFitDriver.state_dict()`` into the port's.

    Every field carries over except the JAX ``key``, which has no torch
    counterpart: the port's ``load_state_dict`` reseeds its generator
    instead.  That is safe because a reveal does not depend on the
    sharing randomness — Lagrange reconstruction cancels the sharing
    polynomials exactly — so the resumed fit reveals the same aggregates
    and follows the same trajectory.
    """
    return {k: np.asarray(state[k]) for k in _CARRIED if k in state}


def parts_from_numpy(parts, device=None):
    """Move a study's [(X_j, y_j)] numpy partitions onto the device as
    float64 tensors (``device=None`` means the CUDA card)."""
    dev = resolve_device(device)
    return [
        (torch.as_tensor(np.asarray(X), dtype=torch.float64, device=dev),
         torch.as_tensor(np.asarray(y), dtype=torch.float64, device=dev))
        for X, y in parts
    ]
