"""Named mesh axes and their collectives on ``torch.distributed``.

The torch counterpart of the JAX package's ``distributed/compat.py`` and
of the ``jax.lax`` collectives its wires call by axis name:

* :func:`make_mesh` builds a ``torch.distributed.device_mesh.DeviceMesh``
  with named dimensions over the default process group (its world size
  is the product of the axis sizes);
* :func:`use_mesh` says which mesh the code inside it runs under — the
  part of ``shard_map`` a torch program needs, since a rank already *is*
  the SPMD program — and :func:`axis_size`, :func:`axis_index` and
  :func:`axis_group` resolve a named axis of that mesh;
* :func:`psum`, :func:`pmax`, :func:`psum_scatter`, :func:`all_gather`
  and :func:`ppermute` are ``jax.lax.psum`` / ``pmax`` /
  ``psum_scatter(..., tiled=True)`` / ``all_gather(..., tiled=True)`` /
  ``ppermute`` over ``axis_name``'s process group, so every wire keeps
  JAX's ``axis_name``.  As in JAX, an axis name may also be a tuple of
  names: the ranks that differ only along those dimensions, in row-major
  order over them (the LM's FSDP axes, ``("pod", "data")``, and the full
  mesh).

Transport.  NCCL carries CUDA tensors for every collective here.  Gloo
carries CUDA tensors only for ``all_reduce`` (and ``broadcast``), so for
a reduce-scatter, an all-gather or a permute of a CUDA tensor on a gloo
group the
operand goes to the host and the result comes back through ONE function,
:func:`stage_through_host`, which counts the bytes it moves.  This is a
transport, not a fallback: the kernels still run on the card.  A CUDA
tensor on any other backend raises.  ``wire_stats`` counts, per rank, the
operand bytes handed to each kind of collective and the bytes staged.

Each named-axis collective is declared to the privacy gate
(``obs/gate.py``) with its axis: a sum over a mesh axis of two or more
ranks is Algorithm 2 on the wire.
"""
from __future__ import annotations

import collections
import contextlib

import torch
import torch.distributed as dist

from ..obs import gate as _gate

__all__ = ["Pending", "all_gather", "axis_group", "axis_index", "axis_size",
           "current_mesh", "make_mesh", "pmax", "ppermute", "psum",
           "psum_scatter", "reset_wire_stats", "stage_through_host",
           "use_mesh", "wire_stats"]

_MESHES: list = []  # innermost last: the meshes use_mesh entered
_STATS: collections.Counter = collections.Counter()
# (id(mesh), dims) -> (the mesh, this rank's group over those mesh
# dimensions); holding the mesh keeps its id from being reused
_GROUPS: dict = {}

# the collectives each backend carries on CUDA tensors
_CUDA_OPS = {"nccl": ("all_reduce", "reduce_scatter", "all_gather",
                      "ppermute"),
             "gloo": ("all_reduce",)}

# torch 2.13 renamed the tensor forms; older builds have only the old names
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def make_mesh(axis_shapes, axis_names):
    """A ``DeviceMesh`` of shape ``axis_shapes`` named ``axis_names`` over
    the default process group (a collective: every rank calls it).

    Its device type is ``"cuda"`` on an NCCL world and ``"cpu"`` on a gloo
    one, whose ranks may still hand the wires CUDA tensors (the transport
    above).
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group or "
                           "multihost.initialize_distributed)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(int(s) for s in axis_shapes),
                            mesh_dim_names=tuple(axis_names))


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the block under ``mesh``: named axes resolve against it."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def current_mesh():
    """The innermost mesh :func:`use_mesh` entered."""
    if not _MESHES:
        raise RuntimeError("no mesh: run the wire inside `with "
                           "use_mesh(mesh):` (the counterpart of shard_map)")
    return _MESHES[-1]


def _dims(axis_name) -> tuple:
    """(the current mesh, the dimension index of each name in
    ``axis_name``, a name or a tuple of names)."""
    mesh = current_mesh()
    names = tuple(mesh.mesh_dim_names or ())
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    for name in axes:
        if name not in names:
            raise ValueError(f"axis {name!r} is not a dimension of the mesh "
                             f"{names}")
    return mesh, tuple(names.index(name) for name in axes)


def axis_size(axis_name) -> int:
    """Size of a named axis (or the product over a tuple of them) of the
    current mesh."""
    mesh, dims = _dims(axis_name)
    n = 1
    for d in dims:
        n *= int(mesh.size(d))
    return n


def axis_index(axis_name) -> int:
    """This rank's coordinate along a named axis of the current mesh (over
    a tuple of axes, row-major over them)."""
    mesh, dims = _dims(axis_name)
    names = mesh.mesh_dim_names
    idx = 0
    for d in dims:
        idx = idx * int(mesh.size(d)) + int(mesh.get_local_rank(names[d]))
    return idx


def axis_group(axis_name):
    """The process group of this rank's line along ``axis_name``.  A tuple
    of two or more dimensions gets a group of its own, made on first use
    (every rank must reach that use, as in any SPMD program): group rank
    i is the rank at row-major coordinate i over those dimensions."""
    mesh, dims = _dims(axis_name)
    if len(dims) == 1:
        return mesh.get_group(mesh.mesh_dim_names[dims[0]])
    key = (id(mesh), dims)
    if key not in _GROUPS:
        ranks = mesh.mesh
        rest = [d for d in range(ranks.dim()) if d not in dims]
        lines = ranks.permute(*rest, *dims).reshape(-1, axis_size(
            axis_name)).tolist()
        me = dist.get_rank()
        for line in lines:  # every rank makes every group, in one order
            group = dist.new_group(line)
            if me in line:
                _GROUPS[key] = (mesh, group)
    return _GROUPS[key][1]


# -- transport ---------------------------------------------------------------

def wire_stats() -> dict:
    """Per-rank counts since the last reset: operand bytes handed to each
    collective (``all_reduce``, ``reduce_scatter``, ``all_gather``), the
    calls, and ``host_staged`` bytes moved between card and host."""
    return dict(_STATS)


def reset_wire_stats() -> None:
    _STATS.clear()


def stage_through_host(t: torch.Tensor, device) -> torch.Tensor:
    """The one place a collective's operand or result crosses between the
    card and the host: a copy of ``t`` to ``device`` (the host for an
    operand, its card for a result), counted in
    ``wire_stats()["host_staged"]``."""
    _STATS["host_staged"] += t.numel() * t.element_size()
    return t.to(device)


def _operand(t: torch.Tensor, group, op: str):
    """(the tensor the backend carries for ``op``, the card its result
    goes back to or None).  Host tensors go as they are; a CUDA tensor
    goes as it is where the backend carries it, through the host on gloo,
    and raises elsewhere."""
    _STATS[op] += t.numel() * t.element_size()
    _STATS[op + "_calls"] += 1
    if not t.is_cuda:
        return t, None
    backend = dist.get_backend(group)
    if op in _CUDA_OPS.get(backend, ()):
        return t, None
    if backend == "gloo":
        return stage_through_host(t, "cpu"), t.device
    raise RuntimeError(f"backend {backend!r} cannot carry a CUDA tensor "
                       f"for {op}")


class Pending:
    """An asynchronous collective's result: :meth:`wait` blocks until it
    has landed (back on the card when it was staged) and returns it."""

    def __init__(self, work, result: torch.Tensor, home=None, then=None):
        self._work, self._result, self._home = work, result, home
        self._then = then

    def then(self, fn) -> "Pending":
        """The same collective with ``fn`` applied to its result."""
        prev = self._then
        return Pending(self._work, self._result, self._home,
                       fn if prev is None else (lambda x: fn(prev(x))))

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
        out = self._result if self._home is None else \
            stage_through_host(self._result, self._home)
        return out if self._then is None else self._then(out)


def _all_reduce(t, axis_name, op, async_op, donate):
    group = axis_group(axis_name)
    buf, home = _operand(t.contiguous(), group, "all_reduce")
    if buf is t and not donate:  # all_reduce works in place
        buf = t.clone()
    work = dist.all_reduce(buf, op=op, group=group, async_op=async_op)
    pending = Pending(work, buf, home)
    return pending if async_op else pending.wait()


@_gate.collective("psum")
def psum(t: torch.Tensor, axis_name: str, async_op: bool = False,
         donate: bool = False):
    """Sum over ``axis_name`` (``jax.lax.psum``): every rank gets the
    total, and ``t`` is left as it was unless ``donate`` gives it to the
    collective (a temporary the caller drops).  ``async_op=True`` returns
    a :class:`Pending`."""
    return _all_reduce(t, axis_name, dist.ReduceOp.SUM, async_op, donate)


@_gate.collective("pmax")
def pmax(t: torch.Tensor, axis_name: str):
    """Maximum over ``axis_name`` (``jax.lax.pmax``)."""
    return _all_reduce(t, axis_name, dist.ReduceOp.MAX, False, False)


@_gate.collective("psum_scatter")
def psum_scatter(t: torch.Tensor, axis_name: str, scatter_dimension: int = 0,
                 async_op: bool = False):
    """Sum over ``axis_name`` and keep this rank's 1/D block of
    ``scatter_dimension`` (``jax.lax.psum_scatter(..., tiled=True)``).

    ``reduce_scatter`` splits dim 0, so the scattered axis moves to the
    front for the collective and back after it.
    """
    group = axis_group(axis_name)
    d = dist.get_world_size(group)
    front = t.movedim(scatter_dimension, 0).contiguous()
    if front.shape[0] % d:
        raise ValueError(f"axis {scatter_dimension} of size "
                         f"{front.shape[0]} does not split into {d} tiles")
    buf, home = _operand(front, group, "reduce_scatter")
    out = torch.empty((front.shape[0] // d,) + tuple(front.shape[1:]),
                      dtype=buf.dtype, device=buf.device)
    work = _reduce_scatter(out, buf, op=dist.ReduceOp.SUM, group=group,
                           async_op=async_op)
    pending = Pending(work, out, home).then(
        lambda x: x.movedim(0, scatter_dimension))
    return pending if async_op else pending.wait()


@_gate.collective("all_gather")
def all_gather(t: torch.Tensor, axis_name, axis: int = 0):
    """Concatenate every rank's ``t`` along ``axis`` in axis order
    (``jax.lax.all_gather(..., tiled=True)``)."""
    group = axis_group(axis_name)
    d = dist.get_world_size(group)
    front = t.movedim(axis, 0).contiguous()
    buf, home = _operand(front, group, "all_gather")
    out = torch.empty((front.shape[0] * d,) + tuple(front.shape[1:]),
                      dtype=buf.dtype, device=buf.device)
    _all_gather(out, buf, group=group)
    out = out if home is None else stage_through_host(out, home)
    return out.movedim(0, axis)


@_gate.collective("ppermute")
def ppermute(t: torch.Tensor, axis_name, perm):
    """Send ``t`` along ``perm``, pairs (source, destination) of
    coordinates on ``axis_name`` (``jax.lax.ppermute``): this rank gets
    the tensor its source sent, or zeros if no pair names it as a
    destination."""
    group = axis_group(axis_name)
    ranks = dist.get_process_group_ranks(group)
    me = axis_index(axis_name)
    sources = [s for s, d in perm if d == me]
    dests = [d for s, d in perm if s == me]
    out = torch.zeros_like(t)
    buf, home = _operand(t.contiguous(), group, "ppermute")
    recv = torch.empty_like(buf)
    works = []
    for d in dests:
        if d == me:
            recv.copy_(buf)
        else:
            works.append(dist.isend(buf, ranks[d], group=group))
    for s in sources:
        if s != me:
            works.append(dist.irecv(recv, ranks[s], group=group))
    for w in works:
        w.wait()
    if sources:
        out.copy_(recv if home is None else stage_through_host(recv, home))
    return out
