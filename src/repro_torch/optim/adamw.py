"""AdamW over a parameter tree: the JAX package's ``optim/adamw.py``.

The tree is the port's (dicts and lists of tensors, flattened in sorted
key order as ``jax.tree_util`` flattens dicts).  Moments are float32 and
parameters keep their dtype (bf16 weights with float32 moments is
mixed-precision training).  The order of operations is JAX's: the global
float32 grad norm, the clip scale, the warm-up schedule, the float32 bias
corrections, weight decay on every leaf, the new parameter cast back to
its dtype.

Unlike JAX, :func:`adamw_update` writes the new parameters and moments
into the tensors it was given, one leaf at a time under
``torch.no_grad()``: at Qwen2.5-32B's width a second copy of the moments
alone would be 20 GB.  It returns the same tensors.  No ``_foreach`` or
fused optimizer runs here.  A leaf larger than ``UPDATE_CHUNK`` elements
is updated a slice of its flat view at a time, so the float32
temporaries of one pass stay near 1 GB (a whole Qwen3-MoE expert leaf,
805,306,368 elements, would take ~10 GB of them); the update is
elementwise, so the numbers do not change.

Under a mesh the trees hold this rank's blocks
(``sharding.shard_params``), and the moments are laid out alike
(:func:`adamw_init` on the blocks; ``sharding.train_state_specs``).  The
update stays elementwise on the blocks; only the global grad norm reaches
across ranks: ``split_axes`` (``sharding.split_axes``) names for each
leaf the mesh axes its block is split across, its squares are summed
over those axes, and a leaf whole over an axis counts once.  Leaves split
over the same axes share one psum.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.flatbuf import tree_flatten, tree_unflatten
from ..distributed import compat

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update"]

# elements of a leaf that one pass of the update takes at a time
UPDATE_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar: updates taken
    mu: dict
    nu: dict


def adamw_init(params) -> AdamWState:
    """Zero float32 moments shaped like ``params``, on their devices."""
    leaves, treedef = tree_flatten(params)
    dev = leaves[0].device

    def zeros():
        return tree_unflatten(treedef, [
            torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves])

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros(), nu=zeros())


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """lr * min(1, (step + 1) / warmup), in float32."""
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm.to(torch.float32)


def _pieces(p, g, m, v):
    """(p, g, m, v) as slices of at most ``UPDATE_CHUNK`` elements of
    their flat views, written through to the leaves; a leaf that is not
    contiguous is one piece."""
    n = p.numel()
    if n <= UPDATE_CHUNK or not all(t.is_contiguous() for t in (p, m, v)):
        yield p, g, m, v
        return
    flat = (p.view(-1), g.reshape(-1), m.view(-1), v.view(-1))
    for i in range(0, n, UPDATE_CHUNK):
        yield tuple(t[i:i + UPDATE_CHUNK] for t in flat)


def _global_norm(flat_g, split_axes):
    """The grad norm of the whole tree from this rank's blocks: per set
    of axes, the sum of squares of the leaves split across exactly those
    axes, psum'd over them on the current mesh (``compat.use_mesh``)."""
    sums: dict = {}
    for g, axes in zip(flat_g, split_axes, strict=True):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        sums[axes] = sums[axes] + sq if axes in sums else sq
    total = 0.0
    for axes in sorted(sums):  # the same collectives on every rank
        total = total + (compat.psum(sums[axes], axes) if axes
                         else sums[axes])
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig, *,
                 split_axes=None):
    """One AdamW step.  Returns (params, state, {"grad_norm", "lr"}):
    ``params`` and the moments are updated in place.  ``split_axes``, a
    tuple of mesh axis names for each leaf in ``tree_flatten`` order, is
    given when the trees hold a rank's blocks (every leaf whole without
    it); the grad norm then runs under that mesh's ``compat.use_mesh``."""
    flat_p, treedef = tree_flatten(params)
    flat_g = tree_flatten(grads)[0]
    flat_m = tree_flatten(state.mu)[0]
    flat_v = tree_flatten(state.nu)[0]
    gnorm = _global_norm(flat_g, split_axes or [()] * len(flat_g))
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0)
             if cfg.grad_clip else 1.0)
    step = state.step + 1
    lr = _schedule(cfg, state.step)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=stepf.device), stepf)
    for leaf in zip(flat_p, flat_g, flat_m, flat_v):
        for p, g, m, v in _pieces(*leaf):
            g = g.to(torch.float32) * scale
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
            del g
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            p32 = p.to(torch.float32)
            p.copy_(p32 - lr * (delta + cfg.weight_decay * p32))
            del delta, p32
    return (tree_unflatten(treedef, flat_p), AdamWState(step, state.mu,
                                                        state.nu),
            {"grad_norm": gnorm, "lr": lr})
