"""Driver specs: which secure rounds the gate certifies, and their taints.

Each :class:`DriverSpec` names one secure driver round, builds it on tiny
deterministic inputs on a device (``setup(device) -> (fn, args,
taints)``) and labels every argument with its taint.  The port's twelve
specs are the JAX package's (``src/repro/analysis/drivers.py``), in the
same order and under the same names:

* ``secure_fit_fused``   — ``SecureFitDriver.step``'s fused round
  (``newton._fused_secure_iteration``).
* ``coordinator_fused``  — the same round in ``StudyCoordinator``'s trim
  (``include_count=True``).
* ``secure_fit_scan``    — ``rounds="scan"``'s block
  (``scanfit.fit_scan_block``), shared by driver and coordinator.
* ``selection_scan``     — the CV sweep's multi-configuration block
  (``selection.path._cv_sweep_block``).
* ``secure_psum[replicated]`` / ``[sharded,tree]`` / ``[sharded,tile]``
  — the 1D wire in every reveal and out mode, on a pod mesh of 4 ranks.
* ``secure_psum_2d``     — the (pod, share) mesh with the distributed
  Lagrange reveal, 3 pods x t centers.

The fused, scan and selection specs run under both ``protect="both"``
and ``protect="gradient"`` (the paper's pragmatic mode, which exercises
``declassify_sum``).  JAX's specs trace devicelessly on an
``AbstractMesh``; the port's psum specs have to run on ranks:
:func:`run_world` spawns a gloo world of the spec's mesh, every rank on
the device asked for, and certifies the spec on every rank
(``chip_smoke.py`` runs them inside its own ranks on the card).  Entry
points default to the card.

Every spec's round routes through the one
:class:`repro_torch.core.collective.SecureCollective` chain, so the
boundaries the taint rules key on are the calls the runtime ledger
counts: certifying a driver here certifies the only chain it can use.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Callable

import numpy as np
import torch

from .._device import resolve_device
from .report import AnalysisReport
from .taint import PUBLIC, SECRET, verify_run

__all__ = ["DriverSpec", "all_driver_specs", "certify", "run_world",
           "toy_parts"]

# every process group a spawned world opens gives up after this long
GROUP_TIMEOUT_S = 120


@dataclasses.dataclass(frozen=True)
class DriverSpec:
    """One certified driver round + the taint labels of its arguments."""

    name: str
    # device -> (fn, args, taints): the round as a call on that device
    setup: Callable
    threshold: int
    # ((axis, size), ...) of the mesh the round runs on, () for one
    # process; a world spec is certified on every rank of that mesh
    world: tuple = ()

    def runner(self, device=None) -> None:
        """The same round, ungated (the runtime audit's run)."""
        fn, args, _ = self.setup(resolve_device(device))
        fn(*args)


def certify(spec: DriverSpec, device=None,
            report: AnalysisReport | None = None, *, lint: bool = False):
    """Run ``spec``'s round under the gate on ``device`` (default: the
    card): ``(report, trace)``.  With ``lint``, the run's host reads and
    collectives are linted into the report too.  A world spec must run on
    every rank, under ``use_mesh`` of its mesh."""
    fn, args, taints = spec.setup(resolve_device(device))
    rep, trace, _ = verify_run(fn, args, taints, spec.threshold,
                               target=spec.name, report=report)
    if lint:
        from .lints import lint_host_reads, lint_mesh_axes

        lint_host_reads(trace.host_reads, spec.name, rep)
        lint_mesh_axes(trace.collectives, spec.name, rep)
    return rep, trace


def toy_parts(device, num_parts: int = 3, n: int = 8, d: int = 4):
    """Tiny deterministic partitions (no rng: specs must be stable), the
    JAX package's ``toy_parts``."""
    parts = []
    for j in range(num_parts):
        base = np.arange(n * d, dtype=np.float64).reshape(n, d)
        X = np.tanh((base + j) / (n * d))
        y = ((base.sum(axis=1) + j) % 2).astype(np.float64)
        parts.append((torch.as_tensor(X, device=device),
                      torch.as_tensor(y, device=device)))
    return parts


def _aggregator():
    from ..core.collective import SecureCollective

    return SecureCollective(backend="kernel")


def _packed(device, num_parts: int = 3, n: int = 8, d: int = 4):
    from ..core.batched_summaries import pack_partitions

    return pack_partitions(toy_parts(device, num_parts, n, d))


def _generator(device, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _fused_spec(name: str, protect: str, include_count: bool):
    def setup(device):
        from ..core.newton import _fused_secure_iteration

        agg = _aggregator()
        packed = _packed(device)

        def fn(beta, generator, packed):
            return _fused_secure_iteration(
                beta, generator, packed, 1.0, agg, protect, 0.0,
                points=None, include_count=include_count,
                summaries_backend="kernel")

        beta = torch.zeros((packed.dim,), dtype=torch.float64,
                           device=device)
        return fn, (beta, _generator(device), packed), \
            (PUBLIC, PUBLIC, SECRET)

    return DriverSpec(name, setup, _aggregator().scheme.threshold)


def _scan_spec(name: str, protect: str, include_count: bool):
    def setup(device):
        from ..core.scanfit import fit_scan_block

        agg = _aggregator()
        packed = _packed(device)

        def fn(beta, obj_prev, conv, iters, packed):
            return fit_scan_block(
                beta, obj_prev, conv, iters, 0, 0, packed, 1.0, agg,
                protect, 0.0, 1e-10, None, include_count, "kernel",
                num_rounds=3, num_parts=packed.num_institutions,
                max_rounds=3)

        f64 = dict(dtype=torch.float64, device=device)
        args = (torch.zeros((packed.dim,), **f64),
                torch.tensor(np.inf, **f64),
                torch.tensor(False, device=device),
                torch.zeros((), dtype=torch.int32, device=device), packed)
        return fn, args, (PUBLIC,) * 4 + (SECRET,)

    return DriverSpec(name, setup, _aggregator().scheme.threshold)


def _selection_spec(name: str, protect: str):
    def setup(device):
        from ..selection.folds import assign_folds, pack_fold_ids
        from ..selection.path import _cv_sweep_block

        agg = _aggregator()
        num_parts, n, d, num_folds = 3, 8, 4, 2
        packed = _packed(device, num_parts, n, d)
        fold_ids = pack_fold_ids(
            [assign_folds(n, num_folds, j, 0) for j in range(num_parts)],
            packed.X.shape[1], device)
        lam_grid = (1.0, 0.5)
        cfg = len(lam_grid) * num_folds
        f64 = dict(dtype=torch.float64, device=device)
        lams = torch.as_tensor(np.repeat(lam_grid, num_folds), **f64)
        fold_of = torch.as_tensor(
            np.tile(np.arange(num_folds, dtype=np.int32), len(lam_grid)),
            device=device)
        zeros = torch.zeros((cfg,), **f64)
        carry = (torch.zeros((cfg, d), **f64),
                 torch.full((cfg,), np.inf, **f64),
                 torch.zeros((cfg,), dtype=torch.bool, device=device),
                 torch.zeros((cfg,), dtype=torch.int32, device=device),
                 zeros, zeros.clone(), zeros.clone(), 0)

        def fn(carry, packed, fold_ids, fold_of, lams):
            return _cv_sweep_block(
                carry, 0, packed, fold_ids, fold_of, lams, agg, protect,
                0.0, 1e-10, None, "kernel", num_rounds=2,
                num_parts=packed.num_institutions, max_rounds=2)

        # fold ids are institution-local row metadata: SECRET like the
        # rows they index; the config -> fold map and the λ grid are public
        return fn, (carry, packed, fold_ids, fold_of, lams), \
            (PUBLIC, SECRET, SECRET, PUBLIC, PUBLIC)

    return DriverSpec(name, setup, _aggregator().scheme.threshold)


def _toy_tree(device, d: int = 12):
    g = np.linspace(-1.0, 1.0, d)
    return {"gradient": torch.as_tensor(g, device=device),
            "bias": torch.as_tensor(g[:4].reshape(2, 2) * 0.5,
                                    device=device)}


def _psum_spec(name: str, reveal: str, out: str, num_pods: int = 4):
    from ..distributed.sharding import POD_AXIS

    def setup(device):
        from ..core.collective import secure_psum

        agg = _aggregator()

        def fn(tree):
            return secure_psum(tree, POD_AXIS, 0, aggregator=agg,
                               reveal=reveal, out=out)

        return fn, (_toy_tree(device),), (SECRET,)

    return DriverSpec(name, setup, _aggregator().scheme.threshold,
                      world=((POD_AXIS, num_pods),))


def _psum_2d_spec(name: str, num_pods: int = 3):
    from ..distributed.sharding import POD_AXIS, SHARE_AXIS

    def setup(device):
        from ..core.collective import secure_psum_2d

        agg = _aggregator()

        def fn(tree):
            return secure_psum_2d(tree, 0, aggregator=agg)

        return fn, (_toy_tree(device),), (SECRET,)

    # one share column per reveal point: share axis == threshold
    t = _aggregator().scheme.threshold
    return DriverSpec(name, setup, t,
                      world=((POD_AXIS, num_pods), (SHARE_AXIS, t)))


def all_driver_specs() -> list:
    """Every round the gate certifies, in the JAX package's order."""
    return [
        _fused_spec("secure_fit_fused[protect=both]", "both", False),
        _fused_spec("secure_fit_fused[protect=gradient]", "gradient",
                    False),
        _fused_spec("coordinator_fused[protect=both]", "both", True),
        _fused_spec("coordinator_fused[protect=gradient]", "gradient",
                    True),
        _scan_spec("secure_fit_scan[protect=both]", "both", False),
        _scan_spec("secure_fit_scan[protect=gradient]", "gradient",
                   False),
        _selection_spec("selection_scan[protect=both]", "both"),
        _selection_spec("selection_scan[protect=gradient]", "gradient"),
        _psum_spec("secure_psum[replicated]", "replicated", "tree"),
        _psum_spec("secure_psum[sharded,tree]", "sharded", "tree"),
        _psum_spec("secure_psum[sharded,tile]", "sharded", "tile"),
        _psum_2d_spec("secure_psum_2d"),
    ]


# -- the psum specs' ranks -------------------------------------------------


def certify_on_rank(names, device, audit: bool = True) -> dict:
    """Certify each named world spec on this rank, under the current
    mesh, with this rank's run linted; with ``audit``, also run it
    ungated under the ledger and reconcile.  Returns ``{name: {"report",
    "census", "rounds", "audit", "collectives"}}`` (``audit`` a
    ``SpecAudit``, None without ``audit``)."""
    from ..obs import ledger
    from ..obs.audit import reconcile

    by_name = {s.name: s for s in all_driver_specs()}
    out = {}
    for name in names:
        spec = by_name[name]
        rep, trace = certify(spec, device, lint=True)
        census, rounds, _ = trace.round_census()
        audited = None
        if audit:
            with ledger.capture() as cap:
                spec.runner(device)
            audited = reconcile(name, census, rounds, cap)
        out[name] = {"report": rep, "census": census, "rounds": rounds,
                     "audit": audited, "collectives": trace.collectives}
    return out


def _world_rank(rank, world, rdzv, out_path, args):
    """One spawned rank: join the gloo world, build the spec's mesh,
    certify the named specs; rank 0 saves every rank's results."""
    import torch.distributed as dist

    from ..distributed import compat

    device, axes, names, audit = args
    dist.init_process_group(
        "gloo", init_method=rdzv, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        mesh = compat.make_mesh([s for _, s in axes], [a for a, _ in axes])
        with compat.use_mesh(mesh):
            mine = certify_on_rank(names, device, audit)
        gathered = [None] * world
        dist.all_gather_object(gathered, mine)
        if rank == 0:
            torch.save(gathered, out_path)
    finally:
        dist.destroy_process_group()


def run_world(specs, device=None, audit: bool = True) -> dict:
    """Certify world specs on spawned gloo ranks (one world per distinct
    mesh, started together; every rank on ``device``, default the card);
    returns ``{name: [per-rank results]}``."""
    import threading

    from ..distributed.multihost import spawn_ranks

    device = resolve_device(device)
    groups: dict = {}
    for s in specs:
        groups.setdefault(s.world, []).append(s.name)
    results, errors = {}, []

    def one(axes, names):
        try:
            world = math.prod(n for _, n in axes)
            per_rank = spawn_ranks(world, _world_rank,
                                   (str(device), axes, names, audit))
            for name in names:
                results[name] = [r[name] for r in per_rank]
        except Exception as e:  # re-raised below, after every world ends
            errors.append(e)

    threads = [threading.Thread(target=one, args=item)
               for item in groups.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return results
