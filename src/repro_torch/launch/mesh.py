"""Production meshes, and the fake world a dry run plays one rank of.

The JAX package compiles its dry run for a 16 x 16 (or 2 x 16 x 16) mesh
of placeholder CPU devices that XLA never runs.  The port's dry run runs
its program, so it plays one rank of such a mesh instead: a process group
on torch's ``fake`` backend (:func:`fake_world`) gives one process a rank
of a world of any size, whose collectives take ``meta`` tensors and move
nothing (``distributed/compat.py``).  The meshes are functions, not
module-level constants, so importing this module touches no process
group.
"""
from __future__ import annotations

import contextlib

from ..distributed.compat import make_mesh
from ..distributed.sharding import POD_AXIS

__all__ = ["fake_world", "make_local_mesh", "make_production_mesh"]


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 = 256 ranks a pod, ("data", "model"); two pods, 512 ranks,
    ("pod", "data", "model").  The paper's institutions map onto the
    "pod" axis (one institution a pod); "model" carries tensor, expert
    and sequence parallelism.  A collective: every rank of a world of
    that size calls it."""
    if multi_pod:
        return make_mesh((2, 16, 16), (POD_AXIS, "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_local_mesh(axes=("data", "model")):
    """A mesh of one rank (every axis of size 1) over a world of one."""
    return make_mesh((1,) * len(axes), axes)


@contextlib.contextmanager
def fake_world(size: int, rank: int = 0):
    """Run the block as ``rank`` of a ``fake`` world of ``size`` ranks
    (the default process group, destroyed after)."""
    import torch.distributed as dist
    # importing it registers the fake backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()
