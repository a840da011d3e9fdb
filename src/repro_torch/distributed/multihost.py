"""Multi-process secure rounds: pod x share meshes, pipelined round chains.

The counterpart of the JAX package's ``distributed/multihost.py``: the
launcher layer around the wires on
:class:`repro_torch.core.collective.SecureCollective` (``psum``,
``psum_2d``).  Institutions lie along the ``POD_AXIS`` of a mesh, one
rank a party; on the 2D (pod, share) mesh the Computation Centers lie
along ``SHARE_AXIS``, each center-rank holds only its own share slice,
and the reveal is itself a collective (``_distributed_reveal``).

A rank of a ``torch.distributed`` process group is the SPMD program:
where the JAX package runs one program over a mesh of devices under
``shard_map``, here every rank calls the same function under
``compat.use_mesh(mesh)``.  On one card, NCCL refuses two ranks; several
ranks then share the card over a gloo group, whose transport
``compat.stage_through_host`` completes.
"""
from __future__ import annotations

import datetime
import math
import os
import tempfile
import time

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..obs import trace as _trace
from .compat import (
    all_gather,
    axis_index,
    axis_size,
    current_mesh,
    make_mesh,
    use_mesh,
)
from .sharding import POD_AXIS, SHARE_AXIS

__all__ = [
    "SHARE_AXIS",
    "initialize_distributed",
    "pod_mesh",
    "pod_share_mesh",
    "secure_psum_2d",
    "scan_secure_rounds",
    "run_scanned_rounds",
    "spawn_ranks",
]

# every process group this module opens fails a hung collective after this
GROUP_TIMEOUT = datetime.timedelta(seconds=120)
# how long run_scanned_rounds waits for the ranks it spawned
SPAWN_DEADLINE_S = 600.0


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           backend: str | None = None) -> bool:
    """Start ``torch.distributed`` from torchrun's environment; a no-op
    for a single process.

    Arguments default from torchrun's variables (``WORLD_SIZE``, ``RANK``,
    and ``MASTER_ADDR``/``MASTER_PORT`` through ``env://``) where the JAX
    package reads ``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``/
    ``JAX_COORDINATOR_ADDRESS``.  ``backend`` defaults to NCCL when every
    rank can have a card of its own and gloo otherwise.  Returns True iff
    a process group was started; world size 1 needs none and returns
    False.  The group fails a hung collective after ``GROUP_TIMEOUT``.
    """
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world_size <= 1:
        return False
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() and \
            torch.cuda.device_count() >= world_size else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=GROUP_TIMEOUT)
    return True


def pod_mesh(num_pods: int):
    """1D institution mesh: one party per rank along ``POD_AXIS``."""
    return make_mesh((num_pods,), (POD_AXIS,))


def pod_share_mesh(num_pods: int, num_centers: int):
    """2D (pod, share) mesh: institutions x Computation Centers.

    ``num_centers`` is the reveal-subset size — normally the threshold t,
    one column of ranks per center in the distributed reveal.
    """
    return make_mesh((num_pods, num_centers), (POD_AXIS, SHARE_AXIS))


def secure_psum_2d(tree, seed: int, aggregator=None, dtype=torch.float32,
                   pod_axis: str = POD_AXIS, share_axis: str = SHARE_AXIS,
                   points=None):
    """Secret-shared all-reduce on a 2D (pod, share) mesh: call on every
    rank under ``use_mesh(pod_share_mesh(...))``.  See
    :meth:`repro_torch.core.collective.SecureCollective.psum_2d`."""
    from ..core.collective import secure_psum_2d as _wire

    return _wire(tree, seed, aggregator=aggregator, dtype=dtype,
                 pod_axis=pod_axis, share_axis=share_axis, points=points)


def scan_secure_rounds(tree, seed: int, num_rounds: int, aggregator=None,
                       axis_name: str = POD_AXIS,
                       reveal: str = "replicated", dtype=torch.float32):
    """``num_rounds`` secure rounds chained on the wire.

    Call on every rank under a mesh with ``axis_name``.  Each round
    protects the current tree (one K1 launch), sums the t-slice share
    buffer over ``axis_name`` and reveals the aggregate (one K2 launch);
    the revealed *mean* feeds the next round (a stand-in for the Newton
    update that keeps the real fit's round-to-round dependency).

    Double buffering: round r + 1's sharing coefficients are drawn while
    round r's collective is in flight (``async_op=True``, then
    ``wait()``), the counterpart of the JAX package's in-scan draw that
    its latency-hiding scheduler overlaps with the collective.  Round r
    draws from ``round_key(round_seed(seed, axis_index), r)``, so the
    chain is reproducible however it is cut.  Returns ``(final_tree,
    trace)``, ``trace`` the (num_rounds,) float64 first element of each
    round's revealed aggregate.
    """
    from ..core.collective import (
        REVEAL_MODES,
        SecureCollective,
        check_aggregation_headroom,
    )
    from ..core.field import random_elements_fast
    from ..core.flatbuf import LANES, pack_pytree, unpack_pytree
    from ..kernels import ops

    agg = aggregator or SecureCollective(backend="kernel")
    if agg.backend != "kernel":
        raise ValueError("scan_secure_rounds needs the flat-buffer wire")
    if reveal not in REVEAL_MODES:
        raise ValueError(f"reveal must be one of {REVEAL_MODES}")
    pts = agg._validated_points(None)
    scheme, field = agg.scheme, agg.scheme.field
    num_devices = axis_size(axis_name)
    check_aggregation_headroom(num_devices, field)
    rank_seed = agg.round_seed(seed, axis_index(axis_name))

    row_align = 8 if reveal == "replicated" else math.lcm(8, num_devices)
    buf, layout = pack_pytree(tree, row_align=row_align)
    buf = buf.to(torch.float64)

    def draw_coeffs(slot: int) -> torch.Tensor:
        return random_elements_fast(
            agg.round_key(rank_seed, slot, buf.device),
            (scheme.threshold - 1, layout.rows, LANES), field,
            dtype=torch.int32)

    coeffs = draw_coeffs(0)
    trace = []
    for r in range(num_rounds):
        shares = ops.shamir_protect_flat(
            buf, coeffs, scheme.num_shares, field.moduli,
            agg.codec.frac_bits, points=pts)
        pending = agg.allreduce(
            shares, axis_name, async_op=True,
            scatter_axis=None if reveal == "replicated" else 2)
        # round r + 1's sharing randomness: independent of the collective
        # in flight, so the draw overlaps it
        coeffs = draw_coeffs(r + 1)
        flat = agg.reveal_wire(pending.wait(), pts)
        if reveal == "sharded":
            flat = all_gather(flat, axis_name, axis=0)
        buf = flat / num_devices  # revealed mean -> next round's input
        trace.append(flat[0, 0])
    return unpack_pytree(buf, layout, dtype=dtype), torch.stack(trace)


def run_scanned_rounds(num_pods: int, tree, seed: int, num_rounds: int,
                       aggregator=None, reveal: str = "replicated",
                       dtype=torch.float32, device=None):
    """:func:`scan_secure_rounds` over ``num_pods`` pods, on ``device``
    (the card unless the caller passes a CPU device).

    The input tree is the same on every pod, so round 1 reveals
    ``num_pods * tree`` and every later round preserves the mean.
    Inside a process group of ``num_pods`` ranks, every rank calls this
    and gets the result (under the current mesh if it has a ``POD_AXIS``
    of that size, else a new ``pod_mesh``).  With no process group, this
    process spawns ``num_pods`` ranks on a gloo group of its own (all on
    ``device``: several ranks may share one card), joins them within
    ``SPAWN_DEADLINE_S`` and returns rank 0's result.  Returns
    ``(final_tree, trace)`` on ``device``.
    """
    from ..core.flatbuf import tree_flatten, tree_unflatten

    device = resolve_device(device)
    leaves, treedef = tree_flatten(tree)
    tree = tree_unflatten(treedef, [l.to(device) for l in leaves])
    if dist.is_initialized():
        if dist.get_world_size() != num_pods:
            raise ValueError(f"a process group of {dist.get_world_size()} "
                             f"ranks cannot run {num_pods} pods")
        mesh = None
        try:
            if axis_size(POD_AXIS) == num_pods:
                mesh = current_mesh()
        except (RuntimeError, ValueError):  # no mesh, or no pod axis
            pass
        with use_mesh(mesh or pod_mesh(num_pods)), _trace.span(
                "scan_block", "run_scanned_rounds", num_pods=num_pods,
                num_rounds=num_rounds):
            return scan_secure_rounds(tree, seed, num_rounds,
                                      aggregator=aggregator, reveal=reveal,
                                      dtype=dtype)
    host_tree = tree_unflatten(treedef, [l.cpu() for l in leaves])
    final, trace = spawn_ranks(
        num_pods, _scanned_rounds_rank,
        (host_tree, seed, num_rounds, aggregator, reveal, dtype,
         str(device)))
    leaves, treedef = tree_flatten(final)
    return (tree_unflatten(treedef, [l.to(device) for l in leaves]),
            trace.to(device))


def _scanned_rounds_rank(rank, world, rdzv, out_path, args):
    """One spawned rank of :func:`run_scanned_rounds`."""
    tree, seed, num_rounds, aggregator, reveal, dtype, device = args
    from ..core.flatbuf import tree_flatten, tree_unflatten

    dist.init_process_group("gloo", init_method=rdzv, rank=rank,
                            world_size=world, timeout=GROUP_TIMEOUT)
    try:
        final, trace = run_scanned_rounds(world, tree, seed, num_rounds,
                                          aggregator=aggregator,
                                          reveal=reveal, dtype=dtype,
                                          device=device)
        if rank == 0:
            leaves, treedef = tree_flatten(final)
            torch.save((tree_unflatten(treedef, [l.cpu() for l in leaves]),
                        trace.cpu()), out_path)
    finally:
        dist.destroy_process_group()


def spawn_ranks(world: int, fn, args,
                 deadline_s: float = SPAWN_DEADLINE_S):
    """Run ``fn(rank, world, rendezvous, out_path, args)`` in ``world``
    spawned processes on a file rendezvous; return what rank 0 saved to
    ``out_path``.  Raises if a rank fails or the ranks outlast
    ``deadline_s`` (every rank is stopped either way)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        rdzv = f"file://{os.path.join(tmp, 'rdzv')}"
        out_path = os.path.join(tmp, "result.pt")
        procs = [ctx.Process(target=fn, args=(r, world, rdzv, out_path,
                                              args), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + deadline_s
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            if any(p.is_alive() for p in procs):
                raise RuntimeError(f"spawned ranks outlasted {deadline_s} s")
            codes = [p.exitcode for p in procs]
            if any(codes):
                raise RuntimeError(f"a spawned rank failed: exit codes "
                                   f"{codes}")
            return torch.load(out_path, weights_only=False)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
