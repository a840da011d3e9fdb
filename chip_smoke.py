#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them.

    python3 chip_smoke.py [--profile] [--repeats 5] [--trace PATH]

Phases, each printing one line (any failure raises and exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and torch/CUDA versions;
2. the build of every CUDA kernel from ``src/repro_torch/csrc`` (nvcc,
   one process per source, all started together);
3. each kernel against its plain PyTorch version on the card, at the
   shapes the paths give it: K1 encode+share and K2 reveal bit-identical,
   K3 summaries within the stated tolerances; K5 cross-validated
   summaries at the λ-path's (5 folds) and refit's (fold -1) shapes and
   at a ragged shape with a count past N_max, H within 2e-5 max|H|, g and
   the deviances within 1e-10 of the sums of absolute terms, held-out
   counts exact;
4. a full ``secure_fit`` at the acceptance configuration (S=8
   institutions, d=128, N=200,000 rows split +-5%, protect="both", 2-of-3
   Shamir over the (2^31-1, 2^31-19) CRT pair, 28 fractional bits)
   through ``SecureCollective(backend="kernel")`` and the kernel
   summaries rung, checked for convergence, exact wire bytes, beta
   against the port's ``centralized_fit``, and one launch of each kernel
   per iteration; then the same fit as ``SecureFitDriver(rounds="scan")``
   blocks, checked against it (iterations, bytes, beta);
5. the secure cross-validated λ path on the same study at
   ``benchmarks/lambda_path.py``'s acceptance configuration (8 λs from
   logspace(1.5, -1.5), 5 folds, lam_block 1, 8 rounds per sync, at most
   50 rounds, refit on, seed 0, the kernel rung), through
   ``secure_cv_path`` and once through ``SelectionCoordinator.run_path``:
   every fold and the refit converged, exact bytes, the refit beta
   against ``centralized_fit`` at λ_1se, and K5, K1 and K2 launched once
   per executed round (K3 never);
6. with ``--profile`` only: ``--repeats`` more timed runs of the fit and
   of the λ path, then one of each under ``torch.profiler`` (device time
   per kernel name, the union of device-busy intervals over the run's
   wall window, so the card's idle share), as ``profile`` JSON lines;
   ``--trace`` also writes the fit's Chrome trace;
7. one JSON line with each kernel's time, bound and launches.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card
the script exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, CUDA-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12

S, D, N, PROTECT, FRAC_BITS = 8, 128, 200_000, "both", 28
SEED = 0
QUANT_TOL = (S + 1) / 2**FRAC_BITS  # 3.35e-8
# the lambda path: benchmarks/lambda_path.py's acceptance configuration
NUM_LAMBDAS, FOLDS, LAM_BLOCK, ROUNDS_PER_SYNC, MAX_ROUNDS = 8, 5, 1, 8, 50
PATH_ROUND_BYTES = 16_711_680
# what the JAX package printed there (a CPU run, with its own fold ids):
# shown for reference, not checked
JAX_PATH = {"rounds": 37, "lambda_1se": 31.622776601683793,
            "lambda_best": 4.393970560760792}
SPIN_CYCLES = 5_000_000  # a few ms of card time, longer than any enqueue


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_times(fn, reps: int) -> tuple[float, float]:
    """(device ms, call ms) of ``fn``, medians over ``reps`` samples.

    Device ms: CUDA events around one call, recorded while the card is
    kept busy by a spin kernel, so the host's enqueue cost (Python,
    ctypes, allocation) never shows as card time.  Call ms: host clock
    around one call and a synchronize — what a caller pays, wrapper
    overhead included.
    """
    import torch

    fn()  # warm-up
    dev, call = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)  # the host enqueues behind this
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        dev.append(a.elapsed_time(b))
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        call.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(dev), statistics.median(call)


def bound(nbytes: float, f32_ops: float = 0.0, f64_ops: float = 0.0):
    """(least ms, what bounds it): the larger of the bytes' time and the
    operations' time; float32 and float64 run on separate pipes, so the
    operations take the longer of the two."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(f32_ops / PEAK_F32, f64_ops / PEAK_F64)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _union_us(intervals) -> float:
    total, end = 0.0, -1.0
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


# device-time categories of a round, by kernel-name substring (first hit)
CATEGORIES = (
    ("K5 fused_irls_cv", ("irls_cv_",)),
    ("K3 fused_irls", ("irls_partial", "irls_reduce")),
    ("K1 encode_share", ("encode_share",)),
    ("K2 reconstruct", ("reconstruct_kernel",)),
    ("solve (LU, cuBLAS/cuSOLVER)", ("getrf", "getrs", "laswp", "trsm",
                                     "trsv", "ipiv", "lu_", "magma",
                                     "solve", "gemv", "batch_")),
    ("memcpy/memset", ("Memcpy", "Memset", "memcpy", "memset")),
)


def _category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "small ops"


def profile_run(run, rounds_of, label: str, repeats: int,
                trace: str = "") -> dict:
    """``repeats`` timed runs, then one under ``torch.profiler``: the
    device time per kernel name and per category, and the card's idle
    share of the run.  ``rounds_of(result)`` counts the run's rounds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    per_round = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        per_round.append((time.perf_counter() - t0) / rounds_of(res))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        with record_function(label):
            res = run()
            torch.cuda.synchronize()
    rounds = rounds_of(res)
    events = prof.events()
    window = next(e for e in events if e.name == label
                  and e.device_type == DeviceType.CPU)
    w0, w1 = window.time_range.start, window.time_range.end
    by_name: dict = collections.defaultdict(lambda: [0, 0.0])
    busy = []
    for e in events:
        # device kernels and copies only: the record_function range is
        # mirrored on the device timeline as an annotation, skip it
        if e.device_type != DeviceType.CUDA or e.name == label \
                or getattr(e, "is_user_annotation", False):
            continue
        a, b = e.time_range.start, e.time_range.end
        by_name[e.name][0] += 1
        by_name[e.name][1] += b - a
        busy.append((max(a, w0), min(b, w1)))
    busy_us = _union_us([(a, b) for a, b in busy if b > a])
    wall_us = w1 - w0
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    by_cat: dict = collections.defaultdict(float)
    for n, (_, us) in top:
        by_cat[_category(n)] += us / rounds
    if trace:
        prof.export_chrome_trace(trace)
    return {
        "run": label,
        "rounds": rounds,
        "seconds_per_round": per_round,
        "profiled_wall_us": wall_us,
        "device_busy_us": busy_us,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "device_us_per_round": sum(us for _, (_, us) in top) / rounds,
        "device_us_per_round_by_category": dict(
            sorted(by_cat.items(), key=lambda kv: -kv[1])),
        "device_kernels": [{"name": n[:120], "count": c, "us": us}
                           for n, (c, us) in top],
    }


def rel_close(got, want, scale, rtol: float) -> bool:
    """|got - want| <= rtol * scale elementwise (scale: sums of absolute
    terms, so a sum that cancels to ~0 is still held to its terms)."""
    return bool(((got - want).abs() <= rtol * scale + 1e-300).all())


def gram_f64(Xm, w32):
    """(S, d, d): the float32 products (Xm w) x Xm of the Gram summed in
    float64 — what the kernel and the plain version each round only in
    their float32 sums, so each one's summation error shows against it."""
    import torch

    return torch.einsum("sni,snj->sij",
                        (Xm * w32[..., None]).double(), Xm.double())


def check_k5(dev, gen, packed, beta):
    """K5 against its plain version on the card; returns (max|dH| over
    the cases, the path-shape arguments for timing, and per case the
    largest |H - gram_f64| of the kernel and of the plain version)."""
    import torch
    from repro_torch.kernels.fused_irls import fused_irls_cv_kernel, \
        fused_irls_cv_plain
    from repro_torch.kernels.ref import masked_cv_terms
    from repro_torch.selection import assign_folds, pack_fold_ids

    n_max = packed.X.shape[1]
    fids = pack_fold_ids([assign_folds(int(c), FOLDS, j) for j, c in
                          enumerate(packed.counts.tolist())], n_max, dev)
    betas = beta[None] + 0.01 * torch.randn(
        (FOLDS, D), generator=gen, dtype=torch.float64, device=dev)
    folds = torch.arange(FOLDS, dtype=torch.int32, device=dev)
    path = (betas, packed.X, packed.X32, packed.y, packed.counts, fids,
            folds)
    refit = (betas[:1],) + path[1:6] + (
        torch.tensor([-1], dtype=torch.int32, device=dev),)
    # ragged, d = 130 (two H tiles per edge), a count past N_max, 4
    # folds: fold_of holds -1 and every fold
    n_r, d_r = 2500, 130
    Xr = torch.randn((3, n_r, d_r), generator=gen, dtype=torch.float64,
                     device=dev)
    yr = (torch.rand((3, n_r), generator=gen, device=dev) < 0.4).double()
    cr = torch.tensor([1000, 37, 3000], dtype=torch.int32, device=dev)
    fr = pack_fold_ids([assign_folds(n_r, 4, f"r{j}") for j in range(3)],
                       n_r, dev)
    fr = torch.where(torch.arange(n_r, device=dev)[None] < cr[:, None], fr,
                     -1)
    ragged = (0.05 * torch.randn((5, d_r), generator=gen,
                                 dtype=torch.float64, device=dev),
              Xr, Xr.float(), yr, cr, fr,
              torch.tensor([-1, 0, 1, 2, 3], dtype=torch.int32, device=dev))
    k5_err, vs_f64 = 0.0, {}
    for name, args in (("path C=5", path), ("refit C=1", refit),
                       ("ragged C=5 d=130", ragged)):
        got = fused_irls_cv_kernel(*args)
        want = fused_irls_cv_plain(*args)
        b, X, _, y, cnt, fid, fold_of = args
        n = X.shape[1]
        valid = (torch.arange(n, device=dev)[None, :]
                 < cnt.clamp(max=n)[:, None])[None]
        z = torch.einsum("snd,cd->csn", X, b)
        p = torch.sigmoid(z)
        g_scale = torch.einsum("snd,csn->csd", X.abs(),
                               ((y[None] - p) * valid).abs())
        ll = (y[None] * z - torch.logaddexp(torch.zeros_like(z), z)) * valid
        dev_scale = 2.0 * ll.abs().sum(dim=2)
        dH = float((got[0] - want[0]).abs().max())
        check(dH <= 2e-5 * float(want[0].abs().max()), f"K5 {name} H {dH}")
        check(rel_close(got[1], want[1], g_scale, 1e-10), f"K5 {name} g")
        for k, what in ((2, "dev_train"), (3, "dev_val")):
            check(rel_close(got[k], want[k], dev_scale, 1e-10),
                  f"K5 {name} {what}")
        for k, what in ((4, "correct_val"), (5, "count_val")):
            check(torch.equal(got[k], want[k]), f"K5 {name} {what}")
        k5_err = max(k5_err, dH)
        w32 = masked_cv_terms(b, X, y, cnt, fid, fold_of)[0].float()
        H64 = torch.stack([gram_f64(args[2], w_c) for w_c in w32])
        vs_f64[name] = (float((got[0] - H64).abs().max()),
                        float((want[0] - H64).abs().max()))
    torch.cuda.synchronize()
    return k5_err, path, vs_f64


def check_path_launches(launches: dict, rounds: int, what: str) -> None:
    """Every executed round of the λ path, sweep and refit alike, is one
    multi-configuration round: one K5, one K1 protect and one K2 reveal;
    K3 (the single-configuration summaries) never runs there."""
    want = {"fused_irls_cv_kernel": rounds, "encode_share_kernel": rounds,
            "reconstruct_kernel": rounds, "fused_irls_kernel": 0}
    check(all(launches[k] == n for k, n in want.items()),
          f"{what} launches {launches} vs {rounds} rounds")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also time and profile the fit (phase 5)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--trace", default="",
                    help="with --profile, write the Chrome trace here")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core.batched_summaries import (
        batched_local_summaries, pack_partitions,
    )
    from repro_torch.core.collective import SecureCollective
    from repro_torch.core.field import FIELD31, FIELD_WIDE, fsum
    from repro_torch.core.flatbuf import pack_pytree_batched
    from repro_torch.core.newton import centralized_fit, secure_fit
    from repro_torch.core.protocol import Institution
    from repro_torch.data import generate_synthetic, ragged_sizes, split_rows
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_irls import fused_irls_cv_kernel, \
        fused_irls_cv_plain, fused_irls_kernel, fused_irls_plain
    from repro_torch.selection import SelectionCoordinator, secure_cv_path
    from repro_torch.kernels.shamir_poly import encode_share_kernel, \
        encode_share_plain
    from repro_torch.kernels.shamir_reconstruct import reconstruct_kernel, \
        reconstruct_plain

    # full float32 products everywhere: the plain versions and the
    # library yardstick must not drop to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. the card -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    ptxas = [ln.strip() for ln in _build.build_log().read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {time.perf_counter() - t0:.1f} s; ptxas: "
          + " | ".join(ptxas))

    # -- the study (Algorithm 3, drawn on the card from a seed) -------------
    study = generate_synthetic(SEED, num_institutions=1,
                               records_per_institution=N, dim=D, device=dev)
    X_all, y_all = study.pooled()
    parts = split_rows(X_all, y_all, ragged_sizes(N, S))
    packed = pack_partitions(parts)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    beta = 0.02 * torch.randn((D,), generator=gen, dtype=torch.float64,
                              device=dev)

    # -- 3. kernels vs plain versions --------------------------------------
    k3_args = (beta, packed.X, packed.X32, packed.y, packed.counts)
    H, g, dv = fused_irls_kernel(*k3_args)
    Hp, gp, dvp = fused_irls_plain(*k3_args)
    n_max = packed.X.shape[1]
    mask = (torch.arange(n_max, device=dev)[None, :]
            < packed.counts[:, None]).double()
    z = torch.einsum("snd,d->sn", packed.X, beta)
    p = torch.sigmoid(z)
    g_scale = torch.einsum("snd,sn->sd", packed.X.abs(),
                           ((packed.y - p) * mask).abs())
    dev_scale = ((packed.y * z - torch.logaddexp(torch.zeros_like(z), z))
                 * mask).abs().sum(dim=1)
    dH = float((H - Hp).abs().max())
    check(dH <= 2e-5 * float(Hp.abs().max()), f"K3 H err {dH}")
    H64 = gram_f64(packed.X32, (p * (1 - p) * mask).float())
    k3_vs_f64 = (float((H - H64).abs().max()), float((Hp - H64).abs().max()))
    check(bool(((g - gp).abs() <= 1e-12 * g_scale).all()), "K3 g err")
    check(bool(((dv - dvp).abs() <= 1e-12 * dev_scale).all()), "K3 dev err")
    k3_err = dH
    # d = 130 (two H tiles per edge) with ragged counts
    Xb = torch.randn((3, 2500, 130), generator=gen, dtype=torch.float64,
                     device=dev)
    yb = (torch.rand((3, 2500), generator=gen, device=dev) < 0.4).double()
    cb = torch.tensor([1000, 37, 2500], dtype=torch.int32, device=dev)
    bb = 0.05 * torch.randn((130,), generator=gen, dtype=torch.float64,
                            device=dev)
    small = (bb, Xb, Xb.float(), yb, cb)
    Hb, gb, dvb = fused_irls_kernel(*small)
    Hbp, gbp, dvbp = fused_irls_plain(*small)
    check(float((Hb - Hbp).abs().max()) <= 2e-5 * float(Hbp.abs().max()),
          "K3 d=130 H err")
    check(float((gb - gbp).abs().max()) <= 1e-9, "K3 d=130 g err")
    check(float((dvb - dvbp).abs().max()) <= 1e-9, "K3 d=130 dev err")

    sm = batched_local_summaries(beta, packed, backend="kernel")
    tree = {"deviance": sm.deviance, "gradient": sm.gradient,
            "hessian": sm.hessian}
    buf, layout = pack_pytree_batched(tree)
    rows = layout.rows
    x = buf.reshape(S * rows, 128).contiguous()  # (1088, 128) f64
    check(tuple(x.shape) == (1088, 128), f"protect payload {x.shape}")
    cap = FIELD_WIDE.max_signed / 2**FRAC_BITS
    edges = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 0.0, -0.0, cap, -cap,
                          2 * cap, -2 * cap, 1e20, -1e20], dtype=torch.float64,
                         device=dev)
    x_edge = x.clone()
    x_edge.view(-1)[:13] = edges * 2**-FRAC_BITS
    x_edge.view(-1)[13:26] = edges
    x31 = (x / x.abs().max() * 3.0).contiguous()  # inside FIELD31 capacity

    def coeffs_for(field, t, n_rows):
        return torch.stack([
            torch.randint(0, p, (t - 1, n_rows, 128), generator=gen,
                          device=dev) for p in field.moduli
        ]).to(torch.int32)

    coeffs = coeffs_for(FIELD_WIDE, 2, S * rows)
    k1_cases = [
        (x, coeffs, FIELD_WIDE, (1, 2, 3)),
        (x_edge, coeffs, FIELD_WIDE, (1, 2, 3)),
        (x_edge.float(), coeffs, FIELD_WIDE, (1, 2, 3)),
        (x, coeffs, FIELD_WIDE, (2,)),
        (x_edge, coeffs, FIELD_WIDE, (1, 3)),
        (x31, coeffs_for(FIELD31, 2, S * rows), FIELD31, (1, 2, 3)),
        (x31.float(), coeffs_for(FIELD31, 2, S * rows), FIELD31, (1, 2, 3)),
    ]
    k1_err = 0.0
    for xi, ci, field, pts in k1_cases:
        got = encode_share_kernel(xi, ci, field.moduli, FRAC_BITS, pts)
        want = encode_share_plain(xi, ci, field.moduli, FRAC_BITS, pts)
        check(torch.equal(got, want),
              f"K1 {field.name} {xi.dtype} points {pts}")
        k1_err = max(k1_err, float((got.long() - want.long()).abs().max()))
    shares = encode_share_kernel(x, coeffs, FIELD_WIDE.moduli, FRAC_BITS,
                                 (1, 2, 3))  # (3, 2, 1088, 128)
    aggd = fsum(shares.reshape(3, 2, S, rows, 128), FIELD_WIDE, axis=2,
                residue_axis=1)  # (3, 2, 136, 128)
    shares31 = encode_share_kernel(x31, coeffs_for(FIELD31, 2, S * rows),
                                   FIELD31.moduli, FRAC_BITS, (1, 2, 3))
    aggd31 = fsum(shares31.reshape(3, 1, S, rows, 128), FIELD31, axis=2,
                  residue_axis=1)
    k2_err = 0.0
    for agg_buf, field in ((aggd, FIELD_WIDE), (aggd31, FIELD31)):
        for pts in ((1, 2), (1, 3), (2, 3)):
            sel = agg_buf[[q - 1 for q in pts]].contiguous()
            for fb in (FRAC_BITS, None):
                got = reconstruct_kernel(sel, pts, field.moduli, fb)
                want = reconstruct_plain(sel, pts, field.moduli, fb)
                check(torch.equal(got, want),
                      f"K2 {field.name} points {pts} frac_bits {fb}")
                k2_err = max(k2_err, float((got.double() - want.double())
                                           .abs().max()))
    revealed = reconstruct_kernel(aggd[[0, 1]].contiguous(), (1, 2),
                                  FIELD_WIDE.moduli, FRAC_BITS)
    want_sum = buf.sum(dim=0)
    check(float((revealed - want_sum).abs().max()) <= (S + 1) / 2**FRAC_BITS,
          "K2 reveal vs plaintext sum")
    k5_err, k5_args, k5_vs_f64 = check_k5(dev, gen, packed, beta)
    torch.cuda.synchronize()
    print("kernels vs plain: K1 bit-identical (2 fields, f32/f64, points, "
          f"edges); K2 bit-identical (3 point sets, R=1 and 2, residues); "
          f"K3 max|dH| {dH:.3e} (<= 2e-5 max|H| {float(Hp.abs().max()):.4e})"
          ", g/dev within 1e-12 of the abs sums; d=130 ok; K5 max|dH| "
          f"{k5_err:.3e} over the path (C=5), refit (C=1) and ragged "
          "(d=130, count > N_max) shapes, g/dev within 1e-10, held-out "
          "counts exact")
    print("max|H - float64 sum of the float32 products| (kernel, plain): "
          f"K3 {k3_vs_f64}; K5 {k5_vs_f64}")

    # -- 4. the main path: secure_fit at the acceptance config --------------
    agg = SecureCollective(backend="kernel")
    fit_kw = dict(protect=PROTECT, aggregator=agg, summaries_backend="kernel",
                  device=dev)
    secure_fit(parts, **fit_kw)  # warm-up: allocator, pack cache
    gold = centralized_fit(X_all, y_all, device=dev)
    torch.cuda.synchronize()
    counters = (encode_share_kernel, reconstruct_kernel, fused_irls_kernel,
                fused_irls_cv_kernel)

    def reset_counts():
        for k in counters:
            k.launches = 0

    def read_counts():
        return {k.__name__: k.launches for k in counters}

    reset_counts()
    t0 = time.perf_counter()
    res = secure_fit(parts, **fit_kw)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_counts()
    round_bytes = agg.round_bytes(D, S, PROTECT)
    err = float(abs(res.beta - gold.beta).max())
    check(res.converged, "secure_fit converged")
    check(round_bytes == 3_342_336, f"round bytes {round_bytes}")
    check(res.bytes_transmitted == res.iterations * 3_342_336,
          f"bytes {res.bytes_transmitted} for {res.iterations} iterations")
    check(err <= (S + 1) / 2**FRAC_BITS, f"beta err vs centralized {err}")
    check(all(launches[k.__name__] == res.iterations
              for k in counters[:3]) and launches["fused_irls_cv_kernel"]
          == 0, f"launches {launches} != iterations {res.iterations}")
    print(f"secure_fit: S={S} d={D} N={N} protect={PROTECT} iterations "
          f"{res.iterations} converged {res.converged} bytes "
          f"{res.bytes_transmitted} max|beta - centralized| {err:.3e} "
          f"seconds {fit_s:.4f} per-iter {fit_s / res.iterations:.4f} "
          f"launches {launches}")

    # the same fit in scan blocks of 4 rounds: one trace read per block
    reset_counts()
    t0 = time.perf_counter()
    scan = secure_fit(parts, rounds="scan", rounds_per_sync=4, **fit_kw)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    scan_launches = read_counts()
    scan_err = float(abs(scan.beta - res.beta).max())
    check(scan.converged and scan.iterations == res.iterations,
          f"scan iterations {scan.iterations} vs step {res.iterations}")
    check(scan.bytes_transmitted == res.bytes_transmitted,
          f"scan bytes {scan.bytes_transmitted}")
    check(scan_err <= QUANT_TOL, f"scan beta vs step {scan_err}")
    check(all(scan_launches[k.__name__] == scan.iterations
              for k in counters[:3]), f"scan launches {scan_launches}")
    print(f"secure_fit rounds=scan (blocks of 4): iterations "
          f"{scan.iterations} bytes {scan.bytes_transmitted} max|beta - "
          f"step beta| {scan_err:.3e} seconds {scan_s:.4f} per-iter "
          f"{scan_s / scan.iterations:.4f} launches {scan_launches}")

    # -- 5. the secure cross-validated lambda path ---------------------------
    lambdas = [float(v) for v in np.logspace(1.5, -1.5, NUM_LAMBDAS)]
    path_kw = dict(num_folds=FOLDS, protect=PROTECT, aggregator=agg,
                   lam_block=LAM_BLOCK, rounds_per_sync=ROUNDS_PER_SYNC,
                   max_rounds=MAX_ROUNDS, refit=True, seed=SEED,
                   summaries_backend="kernel")

    def run_path():
        return secure_cv_path(parts, lambdas, device=dev, **path_kw)

    secure_cv_path(parts, lambdas[:1], device=dev, **path_kw)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rep = run_path()
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    path_launches = read_counts()
    refit_bytes = agg.round_bytes(D, S, PROTECT, include_count=True,
                                  num_configs=1, extra_scalars=3)
    check(agg.round_bytes(D, S, PROTECT, include_count=True,
                          num_configs=FOLDS * LAM_BLOCK, extra_scalars=3)
          == PATH_ROUND_BYTES, "path round_bytes model")
    check(bool(rep.fold_converged.all()), "every fold configuration "
          f"converged: {rep.fold_converged.tolist()}")
    check(rep.refit_rounds < MAX_ROUNDS, "the refit converged "
          f"({rep.refit_rounds} rounds)")
    check(rep.bytes_per_round == PATH_ROUND_BYTES,
          f"path bytes per round {rep.bytes_per_round}")
    sweep_rounds = rep.rounds_total - rep.refit_rounds
    check(rep.bytes_total == sweep_rounds * PATH_ROUND_BYTES
          + rep.refit_rounds * refit_bytes, f"path bytes {rep.bytes_total}")
    gold_1se = centralized_fit(X_all, y_all, lam=rep.lambda_1se, device=dev)
    refit_err = float(abs(rep.beta - gold_1se.beta).max())
    check(refit_err <= QUANT_TOL, f"refit beta vs centralized {refit_err}")
    check_path_launches(path_launches, rep.rounds_total, "secure_cv_path")
    print(f"lambda path: S={S} d={D} N={N} L={NUM_LAMBDAS} K={FOLDS} "
          f"protect={PROTECT} rounds {rep.rounds_total} (refit "
          f"{rep.refit_rounds}) lambda_best {rep.lambda_best:.6g} "
          f"lambda_1se {rep.lambda_1se:.6g} bytes/round "
          f"{rep.bytes_per_round} bytes {rep.bytes_total} max|refit - "
          f"centralized(lambda_1se)| {refit_err:.3e} seconds {path_s:.4f} "
          f"per-round {path_s / rep.rounds_total:.5f} launches "
          f"{path_launches}; the JAX package's CPU run (its own folds): "
          f"{JAX_PATH}")

    # the deployment shape: institutions named by index get the same folds
    reset_counts()
    t0 = time.perf_counter()
    sel = SelectionCoordinator(
        [Institution(str(j), X, y) for j, (X, y) in enumerate(parts)],
        lambdas, device=dev, **path_kw)
    crep = sel.run_path()
    torch.cuda.synchronize()
    coord_s = time.perf_counter() - t0
    coord_launches = read_counts()
    coord_err = float(abs(crep.beta - rep.beta).max())
    check(bool(crep.fold_converged.all())
          and bool(sel.state["refit_converged"]), "coordinator converged")
    check((crep.lambda_best, crep.lambda_1se, crep.rounds_total,
           crep.bytes_total) == (rep.lambda_best, rep.lambda_1se,
                                 rep.rounds_total, rep.bytes_total),
          "coordinator report vs secure_cv_path")
    check(coord_err <= QUANT_TOL, f"coordinator refit beta {coord_err}")
    check_path_launches(coord_launches, crep.rounds_total,
                        "SelectionCoordinator")
    print(f"SelectionCoordinator.run_path: rounds {crep.rounds_total} "
          f"lambda_1se {crep.lambda_1se:.6g} bytes {crep.bytes_total} "
          f"max|beta - secure_cv_path beta| {coord_err:.3e} seconds "
          f"{coord_s:.4f} launches {coord_launches}")

    # -- 6. where the time goes (--profile) ---------------------------------
    if args.profile:
        print(json.dumps({"profile": profile_run(
            lambda: secure_fit(parts, **fit_kw), lambda r: r.iterations,
            "secure_fit", args.repeats, args.trace), "card": smi}))
        print(json.dumps({"profile": profile_run(
            run_path, lambda r: r.rounds_total, "lambda_path",
            args.repeats), "card": smi}))

    # -- 7. times and bounds -------------------------------------------------
    n1 = S * rows * 128
    rows_total = int(packed.counts.sum())
    k2_in = aggd[[0, 1]].contiguous()
    w32 = (p * (1 - p) * mask).float()
    Xm = packed.X32
    from repro_torch.kernels.ref import masked_cv_terms
    k5_b, k5_X, _, k5_y, k5_c, k5_f, k5_o = k5_args
    k5_terms = masked_cv_terms(k5_b, k5_X, k5_y, k5_c, k5_f, k5_o)
    # (C, S, N) float32 train-fold weights for the library call
    w5 = k5_terms[0].float()
    n_cfg = k5_b.shape[0]
    # (configuration, row) pairs on train rows: a held-out row has weight
    # 0 and adds nothing to H or g
    k5_train = n_cfg * rows_total - int(k5_terms[5].sum())
    entries = [
        dict(name="K1 encode_share", fn=encode_share_kernel,
             source="src/repro_torch/csrc/shamir_poly.cu",
             replaces="src/repro/kernels/shamir_poly.py:223",
             run=lambda: encode_share_kernel(x, coeffs, FIELD_WIDE.moduli,
                                             FRAC_BITS, (1, 2, 3)),
             plain=lambda: encode_share_plain(x, coeffs, FIELD_WIDE.moduli,
                                              FRAC_BITS, (1, 2, 3)),
             library=None, err=k1_err,
             bound=bound(n1 * 8 + n1 * 2 * 4 + n1 * 3 * 2 * 4,
                         f64_ops=n1)),
        dict(name="K2 reconstruct", fn=reconstruct_kernel,
             source="src/repro_torch/csrc/shamir_reconstruct.cu",
             replaces="src/repro/kernels/shamir_reconstruct.py:120",
             run=lambda: reconstruct_kernel(k2_in, (1, 2), FIELD_WIDE.moduli,
                                            FRAC_BITS),
             plain=lambda: reconstruct_plain(k2_in, (1, 2),
                                             FIELD_WIDE.moduli, FRAC_BITS),
             library=None, err=k2_err,
             bound=bound(k2_in.numel() * 4 + rows * 128 * 8,
                         f64_ops=rows * 128)),
        dict(name="K3 fused_irls", fn=fused_irls_kernel,
             source="src/repro_torch/csrc/fused_irls.cu",
             replaces="src/repro/kernels/fused_irls.py:100",
             run=lambda: fused_irls_kernel(*k3_args),
             plain=lambda: fused_irls_plain(*k3_args),
             library=lambda: torch.matmul(
                 (Xm * w32[..., None]).transpose(1, 2), Xm),
             err=k3_err,
             bound=bound(rows_total * (D * 12 + 8) + D * 8
                         + S * (D * D * 4 + D * 8 + 8),
                         # the symmetric Gram: d (d + 1) / 2 entries
                         f32_ops=rows_total * D * (D + 1),
                         f64_ops=rows_total * (4 * D + 30))),
        dict(name="K5 fused_irls_cv", fn=fused_irls_cv_kernel,
             source="src/repro_torch/csrc/fused_irls_cv.cu",
             replaces="src/repro/kernels/fused_irls.py:270",
             run=lambda: fused_irls_cv_kernel(*k5_args),
             plain=lambda: fused_irls_cv_plain(*k5_args),
             library=lambda: torch.matmul(
                 (Xm[None] * w5[..., None]).transpose(-1, -2), Xm[None]),
             err=k5_err,
             # one read of X, Xm, y and the fold ids; a symmetric Gram and
             # g over each configuration's train rows, z and the deviance
             # terms over every valid row
             bound=bound(rows_total * (D * 12 + 8 + 4) + n_cfg * (D * 8 + 4)
                         + n_cfg * S * (D * D * 4 + D * 8 + 4 * 8),
                         f32_ops=k5_train * D * (D + 1),
                         f64_ops=n_cfg * rows_total * (2 * D + 30)
                         + k5_train * 2 * D)),
    ]
    kernels = []
    for e in entries:
        ms, call_ms = cuda_times(e["run"], 30)
        plain_ms, _ = cuda_times(e["plain"], 20)
        lib_ms = cuda_times(e["library"], 20)[0] if e["library"] else None
        bound_ms, bound_by = e["bound"]
        kernels.append({
            "name": e["name"], "route": "cuda", "source": e["source"],
            "replaces": e["replaces"],
            # each kernel's count on the path it was ported for: K1-K3
            # the secure_fit run, K5 the lambda path
            "launches": (path_launches if e["fn"] is fused_irls_cv_kernel
                         else launches)[e["fn"].__name__],
            "launches_by_path": {
                "secure_fit": launches[e["fn"].__name__],
                "lambda_path": path_launches[e["fn"].__name__]},
            "max_abs_err": e["err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "call_ms": call_ms,
        })
    print(json.dumps({
        "kernels": kernels,
        "fit_seconds_per_iter": fit_s / res.iterations,
        "fit_iterations": res.iterations,
        "scan_fit_seconds_per_iter": scan_s / scan.iterations,
        "path_seconds": path_s,
        "path_rounds": rep.rounds_total,
        "path_seconds_per_round": path_s / rep.rounds_total,
        "coordinator_path_seconds": coord_s,
        "card": smi,
    }))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
