"""Churn-safe cross-validation fold assignment.

Fold membership is a deterministic function of the institution's identity
(its name, hashed salt-free with crc32) and the fold seed — never of the
cohort.  An institution joining or leaving mid-path cannot reshuffle
anyone else's folds, and a returning institution gets its exact folds
back.  Within an institution the folds are balanced (sizes differ by at
most one row): a permuted ``arange % K`` pattern.

The JAX package permutes with ``jax.random.permutation`` under threefry,
which torch cannot reproduce; the port keeps the contract (balanced,
a function of (name, fold_seed, rows, K) alone) with a seeded CPU
``torch.Generator``, so the same folds come out on every device.  Tests
that hold the port against the JAX package pass JAX's fold ids in.
"""
from __future__ import annotations

import zlib
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..obs.trace import traced as _traced

__all__ = ["assign_folds", "pack_fold_ids"]


@_traced("folds")
def assign_folds(num_rows: int, num_folds: int, name: str | int,
                 fold_seed: int = 0) -> torch.Tensor:
    """(num_rows,) int32 fold ids in [0, num_folds) for one institution,
    on the CPU.  Depends only on (``name``, ``fold_seed``, ``num_rows``,
    ``num_folds``): crc32 is salt-free (unlike ``hash``)."""
    if num_folds < 2:
        raise ValueError("need at least 2 folds")
    if num_rows < num_folds:
        raise ValueError(
            f"institution {name!r} has {num_rows} rows < {num_folds} folds"
        )
    crc = zlib.crc32(str(name).encode()) & 0x7FFFFFFF
    gen = torch.Generator()
    gen.manual_seed(((int(fold_seed) & 0xFFFFFFFF) << 31) | crc)
    pattern = torch.arange(num_rows, dtype=torch.int32) % num_folds
    return pattern[torch.randperm(num_rows, generator=gen)]


@_traced("folds")
def pack_fold_ids(fold_parts: Sequence, n_max: int,
                  device=None) -> torch.Tensor:
    """Stack per-institution fold ids into the packed (S, N_max) int32
    layout on ``device``.  Padding rows get -1; the packed batch's row
    mask excludes them from both the train and the held-out mask."""
    def as_ids(f):
        if not isinstance(f, torch.Tensor):
            f = torch.from_numpy(np.array(f, dtype=np.int32))
        return f.to(device=device, dtype=torch.int32)

    return torch.stack([F.pad(as_ids(f), (0, n_max - len(f)), value=-1)
                        for f in fold_parts])
