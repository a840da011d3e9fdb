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

The ``fake`` backend (``torch.testing._internal.distributed.fake_pg``)
is a dry run's world: one process plays one rank of a mesh of any size
(``launch/mesh.py``, ``launch/dryrun.py``) on ``meta`` tensors, the
port's counterpart of the placeholder devices XLA compiles the JAX
package's dry run for.  Nothing crosses a wire and no result holds data,
but every collective is called with the shapes the real one would be, so
``wire_stats`` and the cost counter (``obs/cost.py``: each kind's bytes
with ``obs/metrics.py``'s factors) count what each call would move.  A
fake group carries ``meta`` tensors only.

Each named-axis collective is declared to the privacy gate
(``obs/gate.py``) with its axis: a sum over a mesh axis of two or more
ranks is Algorithm 2 on the wire.

Gradients.  With autograd recording and an operand that requires a
gradient, :func:`psum`, :func:`all_gather`, :func:`psum_scatter` and
:func:`ppermute` run as ``torch.autograd.Function`` objects whose
backward is JAX's transpose of the same collective under
``shard_map``: a psum's cotangent goes to each rank as it is (the result
is the same on every rank, and each rank holds its whole gradient), an
all-gather's is reduce-scattered, a reduce-scatter's all-gathered, a
permutation's sent back along the reverse pairs.  :func:`pvary` is the
identity whose backward is a psum (``jax.lax.pvary``; Megatron's *f*):
it marks a tensor that is the same on every rank of an axis where each
rank goes on to compute a different part, so each rank's gradient of it
is partial.  The backward runs the same declared functions, under the
mesh the forward ran under, so ``wire_stats`` and the gate count it.
``pmax`` carries no gradient.
"""
from __future__ import annotations

import collections
import contextlib

import torch
import torch.distributed as dist

from ..obs import cost as _cost
from ..obs import gate as _gate
from ..obs.metrics import (ALL_GATHER_FACTOR, ALL_REDUCE_FACTOR,
                           REDUCE_SCATTER_FACTOR)

__all__ = ["Pending", "all_gather", "axis_group", "axis_index", "axis_size",
           "current_mesh", "make_mesh", "pmax", "ppermute", "psum",
           "psum_scatter", "pvary", "reset_wire_stats",
           "stage_through_host", "use_mesh", "wire_stats"]

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
    above), or on a ``fake`` one, whose ranks hand them ``meta`` tensors.
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


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


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
    _STATS[op] += _bytes(t)
    _STATS[op + "_calls"] += 1
    backend = dist.get_backend(group)
    if backend == "fake":
        if t.device.type != "meta":
            raise RuntimeError(f"a fake group carries meta tensors only, "
                               f"not {t.device} ({op})")
        return t, None
    if not t.is_cuda:
        return t, None
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
    _cost.collective("all-reduce", ALL_REDUCE_FACTOR * _bytes(t))
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
    a :class:`Pending`.  Differentiable (the cotangent to each rank as it
    is)."""
    if _records(t) and not async_op:
        return _Psum.apply(t, axis_name)
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
    Differentiable (the cotangents all-gathered)."""
    if _records(t) and not async_op:
        return _PsumScatter.apply(t, axis_name, scatter_dimension)
    return _psum_scatter(t, axis_name, scatter_dimension, async_op)


def _psum_scatter(t, axis_name, scatter_dimension, async_op):
    """``reduce_scatter`` splits dim 0, so the scattered axis moves to the
    front for the collective and back after it."""
    group = axis_group(axis_name)
    d = dist.get_world_size(group)
    front = t.movedim(scatter_dimension, 0).contiguous()
    if front.shape[0] % d:
        raise ValueError(f"axis {scatter_dimension} of size "
                         f"{front.shape[0]} does not split into {d} tiles")
    buf, home = _operand(front, group, "reduce_scatter")
    _cost.collective("reduce-scatter", REDUCE_SCATTER_FACTOR * _bytes(front))
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
    (``jax.lax.all_gather(..., tiled=True)``).  Differentiable (the
    cotangents reduce-scattered: each rank's gradient of the whole is
    partial, as for a weight every rank applies to its own data)."""
    if _records(t):
        return _AllGather.apply(t, axis_name, axis)
    return _all_gather_raw(t, axis_name, axis)


def _all_gather_raw(t, axis_name, axis):
    group = axis_group(axis_name)
    d = dist.get_world_size(group)
    front = t.movedim(axis, 0).contiguous()
    buf, home = _operand(front, group, "all_gather")
    _cost.collective("all-gather", ALL_GATHER_FACTOR * d * _bytes(front))
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
    destination.  Differentiable (the cotangents sent back along the
    reverse pairs)."""
    if _records(t):
        return _Ppermute.apply(t, axis_name, tuple(map(tuple, perm)))
    return _ppermute_raw(t, axis_name, perm)


def _ppermute_raw(t, axis_name, perm):
    group = axis_group(axis_name)
    ranks = dist.get_process_group_ranks(group)
    me = axis_index(axis_name)
    sources = [s for s, d in perm if d == me]
    dests = [d for s, d in perm if s == me]
    out = torch.zeros_like(t)
    buf, home = _operand(t.contiguous(), group, "ppermute")
    _cost.collective("collective-permute", _bytes(t))
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


def pvary(t: torch.Tensor, axis_name):
    """``t`` as it is, whose backward sums the cotangent over
    ``axis_name`` (``jax.lax.pvary``): for a tensor the same on every rank
    of that axis that each rank then uses differently (a column-parallel
    product's input, a replicated weight applied to each rank's own rows),
    so each rank's gradient of it is a partial sum.  Without autograd
    recording, or over an axis of one rank, ``t`` itself."""
    if not _records(t) or axis_size(axis_name) == 1:
        return t
    return _Pvary.apply(t, axis_name)


# -- autograd ----------------------------------------------------------------

def _records(t: torch.Tensor) -> bool:
    """Autograd records an op on ``t`` (grad mode on and ``t`` requires a
    gradient): the collective runs as its ``autograd.Function``."""
    return torch.is_grad_enabled() and t.requires_grad


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis_name):
        return _all_reduce(t, axis_name, dist.ReduceOp.SUM, False, False)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis_name):
        ctx.mesh, ctx.axis_name = current_mesh(), axis_name
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        with use_mesh(ctx.mesh):  # autograd runs it outside the caller's
            return psum(g, ctx.axis_name), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis_name, axis):
        ctx.mesh, ctx.args = current_mesh(), (axis_name, axis)
        return _all_gather_raw(t, axis_name, axis)

    @staticmethod
    def backward(ctx, g):
        with use_mesh(ctx.mesh):
            return psum_scatter(g, *ctx.args), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis_name, dim):
        ctx.mesh, ctx.args = current_mesh(), (axis_name, dim)
        return _psum_scatter(t, axis_name, dim, False)

    @staticmethod
    def backward(ctx, g):
        with use_mesh(ctx.mesh):
            return all_gather(g, *ctx.args), None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis_name, perm):
        ctx.mesh, ctx.axis_name = current_mesh(), axis_name
        ctx.back = [(d, s) for s, d in perm]
        return _ppermute_raw(t, axis_name, perm)

    @staticmethod
    def backward(ctx, g):
        with use_mesh(ctx.mesh):
            return ppermute(g, ctx.axis_name, ctx.back), None, None
