"""End-to-end training driver: the JAX package's ``launch/train.py`` on
the port, with the same flags plus ``--device`` (default ``cuda``; ``cpu``
for a run without a card).

Two pipelines behind one CLI, selected by ``--arch``:

* ``--arch logreg_paper`` — the paper's pipeline: S institutions run
  Algorithm 1 (distributed summaries -> Shamir shares -> secure
  aggregation at the Computation Centers -> Newton step) with
  straggler/center-failure tolerance and checkpoint/restart of protocol
  state.

* ``--arch <lm-arch>`` — LM training on the decoder stack, with the
  paper's technique as an optimizer feature: ``--secure-agg shamir``
  replaces the cross-institution gradient mean with secret-shared
  aggregation, the role H_j/g_j sharing plays in Algorithm 1.
  ``--institutions S`` splits every global batch S ways; each
  institution's gradient is protected before any aggregation.  AdamW,
  grad clipping, checkpoint/restart (atomic, retain-k), failure
  injection.  One step is :func:`train_step`.

Under a mesh, one step of the sharded program is :func:`mesh_train_step`
(the JAX package's ``launch/dryrun.py`` ``train_step``): every rank holds
its blocks of the parameters and moments and computes the gradient of
the global loss with respect to them.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch logreg_paper \\
      --study parkinsons.total --scale 0.05
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_5_32b \\
      --smoke --steps 8 --batch 4 --seq-len 32 --secure-agg shamir \\
      --institutions 2 --lr 1e-2 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .._device import resolve_device
from ..core.flatbuf import (
    LANES,
    ROW_ALIGN,
    _rows_for,
    tree_flatten,
    tree_unflatten,
)
from ..obs import cost as _cost

__all__ = ["main", "mean_gradients", "mesh_step", "mesh_train_step",
           "parse_args", "run_lm", "run_logreg", "train_step", "wire_bytes"]

# the synthetic LM stream cycles over a fixed corpus of this many batches
CORPUS_BATCHES = 4


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    # --- logreg pipeline
    ap.add_argument("--study", default="synthetic",
                    help="insurance | parkinsons.motor | parkinsons.total | "
                         "synthetic")
    ap.add_argument("--protect", default="gradient",
                    choices=["none", "gradient", "hessian", "both"])
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--l1", type=float, default=0.0,
                    help="L1 penalty (elastic net); institution protocol "
                         "unchanged, center solver switches to prox-Newton")
    ap.add_argument("--tol", type=float, default=1e-10)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="row-count scale for quick runs")
    ap.add_argument("--centers", type=int, default=3)
    ap.add_argument("--threshold", type=int, default=2)
    ap.add_argument("--rounds", default="step", choices=["step", "scan"],
                    help="round execution for the secure fit: 'step' "
                         "returns to Python every Newton round; 'scan' runs "
                         "blocks of rounds with one host read per round "
                         "(requires --fused)")
    ap.add_argument("--rounds-per-sync", type=int, default=None,
                    metavar="K", help="scan block size (default: the whole "
                                      "fit as one block)")
    ap.add_argument("--fused", action="store_true",
                    help="cohort-level batched coordinator rounds (kernel "
                         "backend)")
    ap.add_argument("--select-lambda", default=None, metavar="GRID",
                    help="choose λ by secure K-fold cross-validation over "
                         "a comma-separated descending grid, print the CV "
                         "curve, pick the 1-SE λ and refit on all data")
    ap.add_argument("--folds", type=int, default=5,
                    help="CV folds for --select-lambda")
    ap.add_argument("--deadline", type=float, default=None,
                    help="straggler deadline (simulated seconds)")
    # --- LM pipeline
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--secure-agg", default="none",
                    choices=["none", "shamir"])
    ap.add_argument("--secure-backend", default="pallas",
                    choices=["pallas", "reference"],
                    help="shamir aggregation wire: 'pallas' (the JAX "
                         "package's name) runs the cohort round on the "
                         "flat-buffer int32 wire through the kernels "
                         "(SecureCollective(backend='kernel')); 'reference' "
                         "keeps the per-leaf oracle loop")
    ap.add_argument("--institutions", type=int, default=4,
                    help="batch splits treated as paper institutions")
    # --compress builds the error-feedback tree and nothing reads it, as
    # in the JAX package's driver; it is accepted so its command lines run
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-feedback gradient compression "
                         "(plain mode only)")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject an institution failure at this step")
    # --- common
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--out", default=None, help="write metrics JSON here")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


# --------------------------------------------------------------- logreg path
def run_logreg(args) -> dict:
    from ..checkpoint import CheckpointManager
    from ..core.collective import SecureCollective
    from ..core.newton import centralized_fit, secure_fit
    from ..core.protocol import Institution, StudyCoordinator
    from ..core.shamir import ShamirScheme
    from ..data.datasets import load_study

    dev = resolve_device(args.device)
    study = load_study(args.study, seed=args.seed, scale=args.scale,
                       device=dev)
    insts = [Institution(f"inst{j}", Xj, yj)
             for j, (Xj, yj) in enumerate(study.parts)]
    if args.select_lambda:
        from ..selection import SelectionCoordinator

        lambdas = [float(x) for x in args.select_lambda.split(",")]
        agg = SecureCollective(
            scheme=ShamirScheme(threshold=args.threshold,
                                num_shares=args.centers, backend="kernel"),
            overflow_check=True)
        coord = SelectionCoordinator(
            insts, lambdas, num_folds=args.folds, l1=args.l1,
            protect=args.protect, aggregator=agg, deadline=args.deadline,
            tol=args.tol, seed=args.seed, device=dev)
        report = coord.run_path()
        print("\n".join(report.summary_lines()))
        out = {
            "pipeline": "logreg_paper", "study": study.name,
            "mode": "select-lambda",
            "lambdas": [float(v) for v in report.lambdas],
            "folds": args.folds,
            "cv_mean_deviance": [float(v) for v in report.cv_mean],
            "cv_se": [float(v) for v in report.cv_se],
            "cv_accuracy": [float(v) for v in report.cv_accuracy],
            "lambda_best": report.lambda_best,
            "lambda_1se": report.lambda_1se,
            "secure_rounds": report.rounds_total,
            "bytes_per_round": report.bytes_per_round,
            "bytes_transmitted": report.bytes_total,
            "nonzero_coefs": int((np.abs(report.beta) > 1e-6).sum()),
            "features": study.num_features,
            "protect": args.protect,
        }
        print(json.dumps(out, indent=2))
        return out
    if args.l1 > 0.0:
        res = secure_fit(study.parts, lam=args.lam, l1=args.l1,
                         tol=args.tol, protect=args.protect, device=dev)
        out = {
            "pipeline": "logreg_paper", "study": study.name,
            "regularization": f"elastic-net lam={args.lam} l1={args.l1}",
            "iterations": res.iterations, "converged": res.converged,
            "nonzero_coefs": int((abs(res.beta) > 1e-6).sum()),
            "features": study.num_features,
            "total_seconds": res.total_seconds,
        }
        print(json.dumps(out, indent=2))
        return out
    # overflow_check armed on every secure path, as in the JAX driver: a
    # raise beats silently saturating into a plausible reveal
    agg = SecureCollective(
        scheme=ShamirScheme(threshold=args.threshold,
                            num_shares=args.centers,
                            backend="kernel" if args.fused else "reference"),
        overflow_check=True)
    coord = StudyCoordinator(
        insts, lam=args.lam, protect=args.protect, aggregator=agg,
        deadline=args.deadline, tol=args.tol, seed=args.seed,
        fused=args.fused, rounds=args.rounds,
        rounds_per_sync=args.rounds_per_sync, device=dev)

    ckpt = None
    if args.checkpoint_dir:
        ckpt = CheckpointManager(args.checkpoint_dir, retain=3)
        if args.resume and ckpt.latest_step() is not None:
            state, step = ckpt.restore(
                {"beta": coord.beta.cpu().numpy(), "obj_prev": np.float64(0)})
            coord.beta = torch.as_tensor(state["beta"], dtype=torch.float64,
                                         device=dev)
            coord._obj_prev = float(state["obj_prev"])
            coord.iteration = step
            print(f"resumed protocol at iteration {step}")

    t0 = time.perf_counter()
    while not coord.converged and coord.iteration < 50:
        rep = coord.step()
        print(f"iter {rep.iteration:2d} obj={rep.objective:.10f} "
              f"responders={len(rep.responders)} "
              f"stragglers={rep.stragglers}")
        if ckpt:
            ckpt.save(rep.iteration, {
                "beta": coord.beta.cpu().numpy(),
                "obj_prev": np.float64(coord._obj_prev)})
    total_s = time.perf_counter() - t0

    X, y = study.pooled()
    gold = centralized_fit(X, y, lam=args.lam, tol=args.tol, device=dev)
    beta = coord.beta.cpu().numpy()
    r2 = float(np.corrcoef(beta, gold.beta)[0, 1] ** 2)
    out = {
        "pipeline": "logreg_paper",
        "study": study.name,
        "samples": study.num_samples,
        "features": study.num_features,
        "iterations": coord.iteration,
        "converged": bool(coord.converged),
        "r2_vs_gold": r2,
        "max_abs_err_vs_gold": float(np.max(np.abs(beta - gold.beta))),
        "total_seconds": total_s,
        "bytes_transmitted": int(sum(r.bytes_transmitted
                                     for r in coord.reports)),
        "protect": args.protect,
        "device": str(dev),
    }
    print(json.dumps(out, indent=2))
    return out


# ------------------------------------------------------------------- LM path
def _value_and_grad(params, batch, cfg, rules=None):
    """(loss, its metrics {"ce", "aux"}, gradient leaves in
    ``tree_flatten`` order) of ``loss_fn`` on ``batch``, detached.  The
    parameters are differentiated through detached views, so no copy of
    them is made.  A leaf the loss does not read (the token table under
    the ``embeddings`` frontend) gets a zero gradient, as ``jax.grad``
    gives it.  Under ``rules``, this rank's blocks and their gradients."""
    from ..models import transformer as T

    leaves, treedef = tree_flatten(params)
    req = [p.detach().requires_grad_(True) for p in leaves]
    loss, metrics = T.loss_fn(tree_unflatten(treedef, req), batch, cfg,
                              rules=rules)
    grads = torch.autograd.grad(loss, req, materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            list(grads))


def _loss_and_grads(params, batch, cfg):
    """(loss as a float, gradient leaves in ``tree_flatten`` order) of one
    institution's batch (:func:`_value_and_grad`)."""
    loss, _, grads = _value_and_grad(params, batch, cfg)
    return float(loss), grads


def wire_bytes(agg, num_elements: int, num_parts: int) -> int:
    """Share bytes a secure gradient round sends for ``num_parts``
    institutions' trees of ``num_elements`` values: w x R slices of the
    flat int32 buffer (kernel backend) or int64 leaves (reference)."""
    w = agg.scheme.num_shares
    num_r = agg.scheme.field.num_residues
    if agg.backend == "kernel":
        rows = _rows_for(num_elements, ROW_ALIGN)
        return num_parts * w * num_r * rows * LANES * 4
    return num_parts * w * num_r * num_elements * 8


def mean_gradients(params, inst_batches, cfg, agg=None, generator=None):
    """Each institution's loss and gradient, then their mean over the
    institutions in float32: (mean loss, the mean gradient tree, wire
    bytes).

    Plain (``agg=None``): each institution's gradient is added into one
    float32 sum as it arrives — the order of additions of the JAX
    driver's ``sum(...)`` — and divided by S.  Secure: the institutions'
    trees go through ``agg`` (``SecureCollective``): with the kernel
    backend stacked S-leading into one batched round (one K1, one K2),
    with the reference backend protected one by one, aggregated and
    revealed; only the sum is revealed."""
    leaves, treedef = tree_flatten(params)
    losses, acc, per_inst = [], None, []
    for batch in inst_batches:
        loss, grads = _loss_and_grads(params, batch, cfg)
        losses.append(loss)
        if agg is not None:
            per_inst.append(grads)
        elif acc is None:
            acc = [g.to(torch.float32) for g in grads]
        else:
            for a, g in zip(acc, grads):
                a.add_(g.to(torch.float32))
        del grads
    n = len(inst_batches)
    loss = sum(losses) / n
    if agg is None:
        for a in acc:
            a.div_(n)
        return loss, tree_unflatten(treedef, acc), 0
    num_elements = sum(p.numel() for p in leaves)
    if agg.backend == "kernel":
        stacked = tree_unflatten(treedef, [
            torch.stack([g[i] for g in per_inst])
            for i in range(len(leaves))])
        del per_inst
        summed = agg.secure_round_batched(generator, stacked,
                                          dtype=torch.float32)
    else:
        protected = [agg.protect(generator, tree_unflatten(treedef, g))
                     for g in per_inst]
        summed = agg.reveal(agg.aggregate(protected), dtype=torch.float32)
    mean = [(x / n).to(torch.float32) for x in tree_flatten(summed)[0]]
    return loss, tree_unflatten(treedef, mean), wire_bytes(agg, num_elements,
                                                           n)


def train_step(params, opt_state, inst_batches, cfg, opt_cfg, agg=None,
               generator=None):
    """One training step: every live institution's gradient on its batch
    (``inst_batches``: one {"tokens" or "embeds", "labels"} dict each),
    their mean (plain, or secure through ``agg``), then ``adamw_update``,
    which updates ``params`` and the moments in place.  Returns (params,
    opt_state, metrics: loss, grad_norm, lr, bytes)."""
    from ..optim.adamw import adamw_update

    loss, grads, nbytes = mean_gradients(params, inst_batches, cfg, agg,
                                         generator)
    params, opt_state, om = adamw_update(grads, opt_state, params, opt_cfg)
    return params, opt_state, {"loss": loss,
                               "grad_norm": float(om["grad_norm"]),
                               "lr": float(om["lr"]), "bytes": nbytes}


def mesh_train_step(params, opt_state, batch, cfg, opt_cfg, *, rules,
                    n_micro=None):
    """One step of the sharded program (the JAX package's
    ``launch/dryrun.py`` ``train_step`` under ``MeshRules(mesh)``):
    ``params`` and ``opt_state`` are this rank's blocks
    (``sharding.shard_params``, ``adamw_init`` of them), ``batch`` the
    whole global batch on every rank.  With ``n_micro`` = max(the
    argument, ``cfg.train_microbatch``) above 1 the batch splits into
    that many microbatches along its rows, whose gradients are summed in
    float32 and divided by ``n_micro``; the loss is their mean and the
    other metrics the last one's.  Then the sharded ``adamw_update``,
    which updates ``params`` and the moments in place.  Returns (params,
    opt_state, metrics: loss, ce, aux, grad_norm, lr as floats).  With
    ``rules`` None, or a mesh of one rank, it is the unsharded step.

    The step itself is :func:`mesh_step`, which returns the metrics as
    tensors: the dry run (``launch/dryrun.py``) runs it on ``meta``
    tensors, which hold no value to read."""
    params, opt_state, metrics = mesh_step(params, opt_state, batch, cfg,
                                           opt_cfg, rules=rules,
                                           n_micro=n_micro)
    return params, opt_state, {k: float(v) for k, v in metrics.items()}


def mesh_step(params, opt_state, batch, cfg, opt_cfg, *, rules,
              n_micro=None):
    """:func:`mesh_train_step` with its metrics (loss, ce, aux, grad_norm,
    lr) left as scalar tensors on the step's device: no host read."""
    from ..distributed import compat
    from ..distributed.sharding import split_axes
    from ..optim.adamw import adamw_update

    n = max(n_micro or 1, cfg.train_microbatch)
    leaves, treedef = tree_flatten(params)
    if n <= 1:
        loss, metrics, grads = _value_and_grad(params, batch, cfg, rules)
    else:
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split into "
                             f"{n} microbatches")
        per = rows // n
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        # a dry run on meta may run a few of the microbatches, which cost
        # alike, and scale what they count (obs/cost.py)
        steps = _cost.loop_steps(n, leaves[0])
        for i in _cost.probed(range(steps), n, steps, "microbatches"):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            lm, metrics, gm = _value_and_grad(params, mb, cfg, rules)
            for a, g in zip(grads, gm):
                a.add_(g.to(torch.float32))
            loss = loss + lm
            del gm
        for a in grads:
            a.div_(n)
        loss = loss / n
    grads = tree_unflatten(treedef, grads)
    if rules is None or rules.mesh is None:
        params, opt_state, om = adamw_update(grads, opt_state, params,
                                             opt_cfg)
    else:
        with compat.use_mesh(rules.mesh):
            params, opt_state, om = adamw_update(
                grads, opt_state, params, opt_cfg,
                split_axes=split_axes(cfg, rules))
    return params, opt_state, {**metrics, "grad_norm": om["grad_norm"],
                               "lr": om["lr"], "loss": loss}


def corpus_batch(seed: int, step: int, batch: int, seq_len: int,
                 vocab_size: int, device, embed_dim: int = 0):
    """The synthetic LM stream's batch for ``step``: a fixed corpus of
    ``CORPUS_BATCHES`` batches, cycled, tokens uniform in [0, V), drawn
    on the CPU from a generator seeded by (seed + 1, step % 4), so every
    device sees the same corpus.  (The JAX driver's contract; not its
    threefry stream.)  With ``embed_dim`` (the ``embeddings`` frontend)
    the inputs are ``embeds``, a standard normal of shape (batch,
    seq_len, embed_dim) in bf16 from the same generator, in place of the
    tokens, as the JAX driver draws them."""
    gen = torch.Generator().manual_seed(
        (seed + 1) * CORPUS_BATCHES + step % CORPUS_BATCHES)
    tokens = torch.randint(0, vocab_size, (batch, seq_len + 1),
                           generator=gen)
    out = {"labels": tokens[:, 1:].to(device)}
    if embed_dim:
        out["embeds"] = torch.randn((batch, seq_len, embed_dim),
                                    generator=gen).to(torch.bfloat16).to(
                                        device)
    else:
        out["tokens"] = tokens[:, :-1].to(device)
    return out


def run_lm(args) -> dict:
    from ..checkpoint import CheckpointManager
    from ..configs import get_config, smoke_config
    from ..core.collective import SecureCollective
    from ..models import transformer as T
    from ..optim.adamw import AdamWConfig, adamw_init
    from ..optim.compression import init_error_feedback
    from ..runtime import FailureInjector, HeartbeatMonitor, SimClock

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = T.init_params(cfg, seed=args.seed, device=dev)
    # warm-up fits the run, as in the JAX driver
    opt_cfg = AdamWConfig(lr=args.lr,
                          warmup_steps=min(100, max(1, args.steps // 2)))
    opt_state = adamw_init(params)
    S = max(1, args.institutions)
    agg = (SecureCollective(backend="kernel" if args.secure_backend
                            == "pallas" else "reference",
                            overflow_check=True)
           if args.secure_agg == "shamir" else None)
    err_fb = init_error_feedback(params) if args.compress else None  # noqa: F841

    B, L = args.batch, args.seq_len
    if B % S:
        raise SystemExit(f"--batch {B} must be divisible by "
                         f"--institutions {S}")

    # fault-tolerance wiring
    clock = SimClock()
    monitor = HeartbeatMonitor(clock, timeout=5.0)
    for j in range(S):
        monitor.register(f"inst{j}")
    injector = FailureInjector(
        {args.fail_at: [f"inst{S - 1}"]} if args.fail_at is not None else {})

    ckpt = None
    start = 0
    if args.checkpoint_dir:
        ckpt = CheckpointManager(args.checkpoint_dir, retain=3,
                                 async_writes=False)
        if args.resume and ckpt.latest_step() is not None:
            state, start = ckpt.restore({"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            print(f"resumed LM training at step {start}")

    losses, step_bytes = [], []
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        clock.advance(1.0)
        killed = injector.apply(step, monitor)
        if killed:
            print(f"step {step}: institutions failed: {killed}")
        live = monitor.alive()
        live_idx = sorted(int(w[4:]) for w in live)
        if not live_idx:
            raise RuntimeError("no live institutions")
        for w in live:
            monitor.beat(w)
        batch = corpus_batch(args.seed, step, B, L, cfg.vocab_size, dev,
                             cfg.d_model if cfg.frontend == "embeddings"
                             else 0)
        per = B // S
        inst_batches = [{k: v[j * per:(j + 1) * per] for k, v in
                         batch.items()} for j in live_idx]
        gen = (SecureCollective.round_key(args.seed, step, dev)
               if agg is not None else None)
        params, opt_state, m = train_step(params, opt_state, inst_batches,
                                          cfg, opt_cfg, agg, gen)
        losses.append(m["loss"])
        step_bytes.append(m["bytes"])
        if step % args.log_every == 0:
            print(f"step {step:4d} loss={m['loss']:.4f} "
                  f"gnorm={m['grad_norm']:.3f} live={len(live_idx)}/{S}")
        if ckpt and (step + 1) % args.checkpoint_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    total_s = time.perf_counter() - t0
    if ckpt:
        ckpt.save(args.steps, {"params": params, "opt": opt_state})
        ckpt.close()
    out = {
        "pipeline": "lm",
        "arch": cfg.name,
        "params": T.count_params(cfg),
        "steps": args.steps - start,
        "secure_agg": args.secure_agg,
        "secure_backend": args.secure_backend
        if args.secure_agg != "none" else None,
        "institutions": S,
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "losses": losses,
        "bytes_per_step": step_bytes,
        "seconds": total_s,
        "device": str(dev),
    }
    print(json.dumps(out, indent=2))
    return out


def main(argv=None):
    args = parse_args(argv)
    if args.arch == "logreg_paper":
        out = run_logreg(args)
    else:
        out = run_lm(args)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
