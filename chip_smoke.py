#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--profile] [--repeats 5] [--trace PATH]

Phases, each printing one line (any failure raises and exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and torch/CUDA versions;
2. the build of every CUDA kernel from ``src/repro_torch/csrc`` (nvcc);
3. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it: K1 encode+share and K2 reveal
   bit-identical, K3 summaries within the stated tolerances;
4. a full ``secure_fit`` at the acceptance configuration (S=8
   institutions, d=128, N=200,000 rows split +-5%, protect="both", 2-of-3
   Shamir over the (2^31-1, 2^31-19) CRT pair, 28 fractional bits)
   through ``SecureCollective(backend="kernel")`` and the kernel
   summaries rung, checked for convergence, exact wire bytes, beta
   against the port's ``centralized_fit``, and one launch of each kernel
   per iteration;
5. with ``--profile`` only: ``--repeats`` more timed fits, then one fit
   under ``torch.profiler`` (device time per kernel name, the union of
   device-busy intervals over the fit's wall window, so the card's idle
   share), as one ``profile`` JSON line; ``--trace`` also writes the
   Chrome trace;
6. one JSON line with each kernel's time, bound and launches.

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


def profile_fit(run_fit, repeats: int, trace: str) -> dict:
    """``repeats`` timed fits, then one fit under ``torch.profiler``: the
    device time per kernel name and the card's idle share of the fit."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    per_iter = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_fit()
        torch.cuda.synchronize()
        per_iter.append((time.perf_counter() - t0) / res.iterations)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        with record_function("secure_fit"):
            res = run_fit()
            torch.cuda.synchronize()
    events = prof.events()
    window = next(e for e in events if e.name == "secure_fit"
                  and e.device_type == DeviceType.CPU)
    w0, w1 = window.time_range.start, window.time_range.end
    by_name: dict = collections.defaultdict(lambda: [0, 0.0])
    busy = []
    for e in events:
        # device kernels and copies only: the record_function range is
        # mirrored on the device timeline as an annotation, skip it
        if e.device_type != DeviceType.CUDA or e.name == "secure_fit" \
                or getattr(e, "is_user_annotation", False):
            continue
        a, b = e.time_range.start, e.time_range.end
        by_name[e.name][0] += 1
        by_name[e.name][1] += b - a
        busy.append((max(a, w0), min(b, w1)))
    busy_us = _union_us([(a, b) for a, b in busy if b > a])
    wall_us = w1 - w0
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    if trace:
        prof.export_chrome_trace(trace)
    return {
        "iterations": res.iterations,
        "seconds_per_iter": per_iter,
        "profiled_wall_us": wall_us,
        "device_busy_us": busy_us,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "device_us_per_iter": sum(us for _, (_, us) in top) / res.iterations,
        "device_kernels": [{"name": n[:120], "count": c, "us": us}
                           for n, (c, us) in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also time and profile the fit (phase 5)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--trace", default="",
                    help="with --profile, write the Chrome trace here")
    args = ap.parse_args()
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
    from repro_torch.data import generate_synthetic, ragged_sizes, split_rows
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_irls import fused_irls_kernel, \
        fused_irls_plain
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
    torch.cuda.synchronize()
    print("kernels vs plain: K1 bit-identical (2 fields, f32/f64, points, "
          f"edges); K2 bit-identical (3 point sets, R=1 and 2, residues); "
          f"K3 max|dH| {dH:.3e} (<= 2e-5 max|H| {float(Hp.abs().max()):.4e})"
          ", g/dev within 1e-12 of the abs sums; d=130 ok")

    # -- 4. the main path: secure_fit at the acceptance config --------------
    agg = SecureCollective(backend="kernel")
    fit_kw = dict(protect=PROTECT, aggregator=agg, summaries_backend="kernel",
                  device=dev)
    secure_fit(parts, **fit_kw)  # warm-up: allocator, pack cache
    gold = centralized_fit(X_all, y_all, device=dev)
    torch.cuda.synchronize()
    counters = (encode_share_kernel, reconstruct_kernel, fused_irls_kernel)
    for k in counters:
        k.launches = 0
    t0 = time.perf_counter()
    res = secure_fit(parts, **fit_kw)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in counters}
    round_bytes = agg.round_bytes(D, S, PROTECT)
    err = float(abs(res.beta - gold.beta).max())
    check(res.converged, "secure_fit converged")
    check(round_bytes == 3_342_336, f"round bytes {round_bytes}")
    check(res.bytes_transmitted == res.iterations * 3_342_336,
          f"bytes {res.bytes_transmitted} for {res.iterations} iterations")
    check(err <= (S + 1) / 2**FRAC_BITS, f"beta err vs centralized {err}")
    check(all(v == res.iterations for v in launches.values()),
          f"launches {launches} != iterations {res.iterations}")
    print(f"secure_fit: S={S} d={D} N={N} protect={PROTECT} iterations "
          f"{res.iterations} converged {res.converged} bytes "
          f"{res.bytes_transmitted} max|beta - centralized| {err:.3e} "
          f"seconds {fit_s:.4f} per-iter {fit_s / res.iterations:.4f} "
          f"launches {launches}")

    # -- 5. where the fit's time goes (--profile) ----------------------------
    if args.profile:
        print(json.dumps({"profile": profile_fit(
            lambda: secure_fit(parts, **fit_kw), args.repeats, args.trace),
            "card": smi}))

    # -- 6. times and bounds -------------------------------------------------
    n1 = S * rows * 128
    rows_total = int(packed.counts.sum())
    k2_in = aggd[[0, 1]].contiguous()
    w32 = (p * (1 - p) * mask).float()
    Xm = packed.X32
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
            "launches": launches[e["fn"].__name__],
            "max_abs_err": e["err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "call_ms": call_ms,
        })
    print(json.dumps({
        "kernels": kernels,
        "fit_seconds_per_iter": fit_s / res.iterations,
        "fit_iterations": res.iterations,
        "card": smi,
    }))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
