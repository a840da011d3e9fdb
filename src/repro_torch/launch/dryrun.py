"""Shape dry run: every (arch x shape) cell at full size, on one rank of a
production mesh, with no device memory.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell for
a mesh of placeholder devices and reads XLA's memory and cost analyses.
The port has no compiler, so it runs the cell instead: this process
plays rank 0 of a ``fake`` world of the mesh's size (``launch/mesh.py``)
and calls the real entry points on ``meta`` tensors, under the cost
counter (``launch/cost_analysis.py``):

* train — ``launch.train.mesh_step`` (the sharded ``loss_fn`` gradient,
  microbatched by ``--microbatch`` or the config's ``train_microbatch``,
  then the sharded ``adamw_update``);
* prefill — ``models.transformer.prefill(rules=)``;
* decode — ``models.transformer.decode_step(rules=)`` on the rank's part
  of ``init_cache(rules=)``, at the last position of the cache.

Every kernel on the path (K7, K8a, K8b) gives its outputs' shapes on
``meta`` and charges its declared work.  One JSON record a cell goes to
``--out`` (default ``results/torch_dryrun``), with JAX's keys where the
quantity is the same: ``memory`` (argument, output, alias and temp bytes
a rank; temp is the predicted peak less the arguments) and ``model``
(parameters), and under ``cost_analysis`` the counter's figures (there is
no HLO): FLOPs, bytes, collective bytes and counts by kind, kernel calls,
the predicted peak, and the loops it probed.  ``wire_stats`` is what
``distributed/compat.py`` counted (operand bytes by collective).  The
numbers are host arithmetic on the ``meta`` device: no time, rate or
memory of any card.

A rank's arguments are counted as JAX counts them: its blocks of the
parameters and the AdamW state, its rows of the batch
(``launch/specs.batch_shardings``: the port's entry points take the whole
batch on every rank and cut their rows, which a deployment would feed
each rank alone), and for decode its part of the caches and the int32
length.  The parameters, moments and caches are updated in place, so
those outputs alias arguments (``alias_bytes_per_device``).

Ops on ``meta`` cost host time each, and some loops run thousands of
steps that cost alike (the recurrences over time, the banded attention's
query blocks, a step's microbatches): with ``--probe-loops N`` (default
3) such a loop of more steps runs its first N and the counter scales
what they count (``cost_analysis``: FLOPs exact); the record lists them
under ``scaled_loops``.  ``--all`` plays the cells on a pool of
``--jobs`` worker processes, each importing the port once.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2_72b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--jobs 4]
  python -m repro_torch.launch.dryrun --arch deepseek_7b --shape train_4k \\
      --smoke --mesh-shape 2,2
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import torch

from ..configs import ARCH_IDS, get_config, smoke_config
from ..models.config import SHAPES

__all__ = ["LM_ARCHS", "dry_run", "main", "parse_args", "run_cell"]

LM_ARCHS = tuple(a for a in ARCH_IDS if a != "logreg_paper")
PROBE_LOOPS = 3
_META = torch.device("meta")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) on --jobs worker "
                         "processes")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--out", default="results/torch_dryrun")
    ap.add_argument("--host-devices", type=int, default=None,
                    help="the fake world's size (default: the mesh's)")
    ap.add_argument("--mesh-shape", default=None,
                    help="override the mesh, e.g. '2,2' or '2,2,2'")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (tests)")
    ap.add_argument("--variant", default="baseline",
                    help="variant tag recorded in the result")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="gradient-accumulation microbatches for train "
                         "cells (activations scale with B/n)")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the per-(arch, shape) preset "
                         "(configs/perf_presets.py)")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE", dest="overrides",
                    help="dataclasses.replace override on the model config "
                         "(int/float/str auto-coerced); repeatable")
    ap.add_argument("--probe-loops", type=int, default=PROBE_LOOPS,
                    help="run at most this many steps of a loop whose "
                         "steps cost alike, on meta, and scale its counts "
                         "(0: every step)")
    return ap.parse_args(argv)


def mesh_dims(args) -> tuple:
    """(the mesh's shape, its axis names)."""
    if args.mesh_shape:
        dims = tuple(int(x) for x in args.mesh_shape.split(","))
        return dims, ("pod", "data", "model")[-len(dims):]
    if args.multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def cell_config(arch: str, shape, *, smoke=False, optimized=False,
                overrides=()):
    """The model config of one cell: full or smoke, the preset applied
    with ``optimized``, then each ``KEY=VALUE`` override."""
    cfg = smoke_config(arch) if smoke else get_config(arch)
    if optimized:
        from ..configs.perf_presets import apply_preset

        cfg = apply_preset(cfg, shape)
    if overrides:
        kv = {}
        for item in overrides:
            key, val = item.split("=", 1)
            field_t = type(getattr(cfg, key))
            kv[key] = field_t(val) if field_t is not bool else val == "True"
        cfg = dataclasses.replace(cfg, **kv)
    return cfg


def _bytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (any nesting of dicts, lists and
    tuples, the AdamW state's named tuple among them)."""
    from torch.utils._pytree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _owned(tree):
    """Each leaf of ``tree`` (a rank's blocks, views of whole ``meta``
    leaves) as a ``meta`` tensor of its own, so a storage is a block."""
    from torch.utils._pytree import tree_map

    return tree_map(lambda t: torch.empty_like(
        t, memory_format=torch.contiguous_format), tree)


def _shard_bytes(batch: dict, rules) -> int:
    """The bytes of this rank's rows of ``batch`` (``batch_shardings``)."""
    from .specs import batch_shardings

    total = 0
    for name, spec in batch_shardings(batch, rules).items():
        n = _bytes(batch[name])
        total += n // rules.dp_size if spec and spec[0] is not None else n
    return total


def dry_run(cfg, shape, rules, *, n_micro: int = 1,
            probe_loops: int = PROBE_LOOPS) -> dict:
    """Run one cell's entry point on ``meta`` as this rank of
    ``rules.mesh`` (a mesh of the current process group: a ``fake`` world
    for a dry run) under a cost counter.  Returns the record's
    ``memory``, ``cost_analysis``, ``wire_stats`` and ``n_micro``."""
    from ..distributed import compat
    from ..distributed.sharding import shard_params
    from ..models import transformer as T
    from ..optim.adamw import AdamWConfig, adamw_init
    from .cost_analysis import CostCounter
    from .specs import input_specs
    from .train import mesh_step

    inputs = input_specs(cfg, shape)
    params = _owned(shard_params(T.abstract_params(cfg), rules, cfg))
    kind = shape.kind
    if kind == "train":
        state = adamw_init(params)
        held, batch = (params, state), inputs
    elif kind == "prefill":
        held, batch = params, inputs
    else:
        caches = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                              device=_META, rules=rules)
        held = (params, list(caches))
        batch = {k: v for k, v in inputs.items() if k in ("tokens", "embeds")}
    # decode also takes the length, an int32 scalar in JAX
    args = (_bytes(held) + _shard_bytes(batch, rules)
            + 4 * (kind == "decode"))
    compat.reset_wire_stats()
    counter = CostCounter(probe_loops=probe_loops)
    n = max(n_micro, cfg.train_microbatch)
    with counter:
        counter.track(held)
        counter.reserve(args - _bytes(held))
        if kind == "train":
            params, state, metrics = mesh_step(
                params, state, batch, cfg, AdamWConfig(), rules=rules,
                n_micro=n)
            out = (params, state, metrics)
            alias = _bytes((params, state))
        elif kind == "prefill":
            logits, caches, _ = T.prefill(
                params, cfg, batch.get("tokens"),
                embeds=batch.get("embeds"), rules=rules)
            out, alias = (logits, list(caches)), 0
        else:
            logits, caches, _ = T.decode_step(
                params, caches, shape.seq_len - 1, cfg, batch.get("tokens"),
                embeds=batch.get("embeds"), rules=rules)
            out, alias = (logits, list(caches)), _bytes(list(caches))
        peak = counter.peak_bytes
    # prefill and decode also return the length (an int32 in JAX)
    out_bytes = _bytes(out) + 4 * (kind != "train")
    return {
        "n_micro": n if kind == "train" else None,
        "memory": {
            "argument_bytes_per_device": args,
            "output_bytes_per_device": out_bytes,
            "alias_bytes_per_device": alias,
            "temp_bytes_per_device": peak - args,
        },
        "cost_analysis": {
            "flops_per_device": counter.flops,
            "bytes_per_device": counter.bytes,
            "collective_bytes_per_device": dict(counter.collective_bytes),
            "collective_counts": dict(counter.collective_count),
            "kernel_calls": dict(counter.kernel_calls),
            "kernel_flops": dict(counter.kernel_flops),
            "predicted_peak_bytes_per_device": peak,
            "scaled_loops": counter.scaled_loops,
            "note": "counted by the port's cost counter on the meta device "
                    "(host arithmetic; no time or rate of any card)",
        },
        "wire_stats": compat.wire_stats(),
    }


def run_cell(args, arch: str, shape_name: str) -> dict:
    """One cell's record, this process playing rank 0 of a fake world."""
    from ..distributed import compat
    from ..distributed.sharding import MeshRules
    from ..models import transformer as T
    from .mesh import fake_world

    shape = SHAPES[shape_name]
    cfg = cell_config(arch, shape, smoke=args.smoke,
                      optimized=args.optimized, overrides=args.overrides)
    dims, axes = mesh_dims(args)
    world = math.prod(dims)
    if args.host_devices not in (None, world):
        raise SystemExit(f"--host-devices {args.host_devices}: the fake "
                         f"world must be the mesh's {world} ranks")
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in dims), "axes": list(axes),
        "devices": world, "variant": args.variant,
        "overrides": args.overrides, "smoke": args.smoke,
        "optimized": args.optimized,
    }
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        result["skipped"] = ("pure full-attention arch: 512k dense decode "
                             "excluded, as the JAX package's dry run "
                             "excludes it")
        return result
    t0 = time.perf_counter()
    with fake_world(world):
        rules = MeshRules(compat.make_mesh(dims, axes))
        result.update(dry_run(cfg, shape, rules,
                              n_micro=args.microbatch,
                              probe_loops=args.probe_loops))
    result["seconds"] = time.perf_counter() - t0
    result["model"] = {"params": T.count_params(cfg),
                       "active_params": T.count_params(cfg,
                                                       active_only=True)}
    return result


def _out_file(args, arch: str, shape: str) -> str:
    tag = "multipod" if args.multi_pod else "singlepod"
    if args.variant != "baseline":
        tag += f"__{args.variant}"
    return os.path.join(args.out, f"{arch}__{shape}__{tag}.json")


def _cell_job(argv) -> str | None:
    """One cell of ``--all`` in a pool worker: its record written, or the
    error that stopped it."""
    args = parse_args(argv)
    try:
        result = run_cell(args, args.arch, args.shape)
    except Exception:  # the sweep goes on; the cell is reported failed
        import traceback

        return traceback.format_exc()
    with open(_out_file(args, args.arch, args.shape), "w") as f:
        json.dump(result, f, indent=2)
    return None


def _run_all(args) -> int:
    """Every (arch x shape) cell on a pool of ``--jobs`` worker processes
    (each imports the port once and plays one cell at a time), training
    cells and the deepest models first; returns the exit code (1 if any
    cell failed)."""
    import concurrent.futures
    import multiprocessing

    kinds = {"train": 0, "prefill": 1, "decode": 2}
    cells = sorted(((a, s) for a in LM_ARCHS for s in SHAPES),
                   key=lambda c: (kinds[SHAPES[c[1]].kind],
                                  -get_config(c[0]).num_layers))
    base = ["--out", args.out, "--variant", args.variant, "--microbatch",
            str(args.microbatch), "--probe-loops", str(args.probe_loops)]
    for item in args.overrides:
        base += ["--set", item]
    for flag in ("optimized", "multi_pod", "smoke"):
        if getattr(args, flag):
            base.append("--" + flag.replace("_", "-"))
    if args.mesh_shape:
        base += ["--mesh-shape", args.mesh_shape]
    failures = []
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(args.jobs,
                                                mp_context=ctx) as pool:
        jobs = {}
        for arch, shape in cells:
            if os.path.exists(_out_file(args, arch, shape)):
                print(f"skip (exists): {_out_file(args, arch, shape)}",
                      flush=True)
                continue
            jobs[pool.submit(_cell_job, ["--arch", arch, "--shape", shape,
                                         *base])] = (arch, shape)
        for fut in concurrent.futures.as_completed(jobs):
            err = fut.result()
            if err is not None:
                failures.append(jobs[fut])
                print(f"FAIL {jobs[fut]}: {err}", flush=True)
    print(f"done; {len(failures)} failures: {failures}", flush=True)
    return 1 if failures else 0


def main(argv=None) -> int:
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.all:
        return _run_all(args)
    if not (args.arch and args.shape):
        raise SystemExit("--arch and --shape (or --all)")
    result = run_cell(args, args.arch, args.shape)
    with open(_out_file(args, args.arch, args.shape), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
