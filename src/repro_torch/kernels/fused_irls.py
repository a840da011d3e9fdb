"""K3, K5 and K6: the IRLS summaries and the weighted Gram.

* K3 (:func:`fused_irls_kernel`) — (H_j, g_j, dev_j) per institution, the
  port of the JAX package's ``kernels/fused_irls.py::fused_irls_pallas``
  (CUDA in ``csrc/fused_irls.cu``);
* K5 (:func:`fused_irls_cv_kernel`) — the cross-validated variant over a
  (configuration, institution) grid, train-fold H/g/dev plus held-out
  deviance, correct predictions and row count, the port of
  ``fused_irls_cv_pallas`` (CUDA in ``csrc/fused_irls_cv.cu``);
* K6 (:func:`gram_hessian_kernel`) — X^T diag(w) X for caller-given row
  weights, the port of ``gram_hessian_pallas`` (CUDA in
  ``csrc/gram_hessian.cu``).

The three CUDA entries launch kernels built from one shared source of the
rows, Gram and reduce code (``csrc/irls_tc.cuh``): K3 is K5 with one
configuration and no folds, K6 is K5's Gram and reduce with the caller's
weights.  Each wrapper has its plain PyTorch version beside it
(``*_plain``) — the CPU path and the kernel's oracle.  All keep the JAX
``fused_irls_sim`` precision contract:

* z, p, the residual, g and dev in float64 (in the kernels on the float64
  tensor cores: float64 products and sums);
* the IRLS weight w = p (1 - p) cast to float32;
* H = Xm^T diag(w) Xm from the float32 operand ``Xm`` with float32 sums.
  The plain versions multiply in exact float32 (no TF32).  The kernels
  take the products on the tensor cores as three TF32 products with
  float32 sums: a = w Xm rounded to float32, each of a and Xm split into
  TF32 terms hi + lo (hi = rna(x), lo = rna(x - hi)), and H = a_hi^T x_hi
  + a_hi^T x_lo + a_lo^T x_hi over the upper half, mirrored, within
  ~2^-21 of each exact product.  Each 32-row tile's products are summed
  from zero and added to the running sum with round to nearest, and the
  slices' partial sums are added in slice order: H lies within 2e-5
  max|H| of the plain version, and two calls give the same bits.

Rows >= counts[s] are masked out of every sum; the kernels never read
them.  Per the sim, g/dev always accumulate in float64, which is also
what the H100 runs natively.  On ``meta`` tensors each wrapper returns
its outputs' shapes and dtypes and charges the cost counter for every
row its launch would cover (``kernels/work.py``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build, work as _work
from ..obs import cost as _cost
from ..obs import gate as _gate
from .ref import gram_hessian, masked_cv_terms, masked_irls_terms

__all__ = ["fused_irls_kernel", "fused_irls_plain", "fused_irls_cv_kernel",
           "fused_irls_cv_plain", "gram_hessian_kernel", "gram_hessian_plain"]

_MAX_DIM = 1024


def _check_args(beta, X, Xm, y, counts):
    if X.dim() != 3:
        raise ValueError(f"X must be (S, N, d), got {tuple(X.shape)}")
    s_dim, n, d = X.shape
    if X.dtype != torch.float64 or Xm.dtype != torch.float32 or \
            y.dtype != torch.float64 or beta.dtype != torch.float64:
        raise TypeError("X, y, beta must be float64 and Xm float32")
    if tuple(Xm.shape) != tuple(X.shape) or tuple(y.shape) != (s_dim, n) \
            or tuple(beta.shape) != (d,) or tuple(counts.shape) != (s_dim,):
        raise ValueError("shape mismatch among beta, X, Xm, y, counts")
    if counts.dtype != torch.int32:
        raise TypeError(f"counts must be int32, got {counts.dtype}")
    if len({t.device for t in (beta, X, Xm, y, counts)}) != 1:
        raise ValueError("beta, X, Xm, y, counts must be on one device")


def fused_irls_plain(beta, X, Xm, y, counts):
    """Plain PyTorch K3: (H (S,d,d) f32, g (S,d) f64, dev (S,) f64)."""
    _check_args(beta, X, Xm, y, counts)
    w, g, dev = masked_irls_terms(beta, X, y, counts)
    w32 = w.to(torch.float32)
    H = torch.stack([
        (Xm[j] * w32[j][:, None]).T @ Xm[j] for j in range(X.shape[0])
    ])
    return H, g, dev


def _k3_work(beta, X, *_):
    s_dim, n, d = X.shape
    return _work.k3_fused_irls(s_dim * n, d, s_dim)


@_cost.kernel("K3", _k3_work)
@_gate.kernel
def fused_irls_kernel(beta, X, Xm, y, counts):
    """K3 on the tensors' device: the CUDA kernels for CUDA tensors, the
    plain version for CPU tensors, the outputs' shapes for ``meta``
    tensors.  Returns (H f32, g f64, dev f64)."""
    if _build.plain(X, "K3"):
        return fused_irls_plain(beta, X, Xm, y, counts)
    _check_args(beta, X, Xm, y, counts)
    s_dim, n, d = X.shape
    if d > _MAX_DIM:
        raise ValueError(f"K3 supports d <= {_MAX_DIM}, got {d}")
    if X.device.type == "meta":
        return (torch.empty((s_dim, d, d), dtype=torch.float32,
                            device=X.device),
                torch.empty((s_dim, d), dtype=torch.float64, device=X.device),
                torch.empty((s_dim,), dtype=torch.float64, device=X.device))
    beta, X, Xm, y, counts = (t.contiguous() for t in (beta, X, Xm, y,
                                                        counts))
    shape = cv_launch_shape(1, s_dim, n, d, X.device, kernel="k3")
    nsl_r, nsl_g = shape["nsl_rows"], shape["nsl_gram"]
    dev_ = X.device
    f32, f64 = torch.float32, torch.float64
    H = torch.empty((s_dim, d, d), dtype=f32, device=dev_)
    g = torch.empty((s_dim, d), dtype=f64, device=dev_)
    dev = torch.empty((s_dim,), dtype=f64, device=dev_)
    # scratch, as K5's for one configuration: the weights, the per-slice
    # partials (H's upper half packed row by row)
    w = torch.empty((s_dim, n), dtype=f32, device=dev_)
    Hp = torch.empty((s_dim, nsl_g, d * (d + 1) // 2), dtype=f32,
                     device=dev_)
    gp = torch.empty((s_dim, nsl_r, d), dtype=f64, device=dev_)
    sp = torch.empty((s_dim, nsl_r, 4), dtype=f64, device=dev_)
    err = _build.library().repro_k3_fused_irls(
        beta.data_ptr(), X.data_ptr(), Xm.data_ptr(), y.data_ptr(),
        counts.data_ptr(), H.data_ptr(), g.data_ptr(), dev.data_ptr(),
        w.data_ptr(), Hp.data_ptr(), gp.data_ptr(), sp.data_ptr(), s_dim, n,
        d, nsl_r, shape["tn_rows"], nsl_g,
        torch.cuda.current_stream(dev_).cuda_stream,
    )
    _build.check(err, "K3 fused_irls")
    fused_irls_kernel.launches += 1
    return H, g, dev


fused_irls_kernel.launches = 0


# -- K5: the cross-validated variant ----------------------------------------

def _check_cv_args(betas, X, Xm, y, counts, fold_ids, fold_of):
    if betas.dim() != 2 or betas.shape[0] < 1:
        raise ValueError(f"betas must be (C, d) with C >= 1, got "
                         f"{tuple(betas.shape)}")
    _check_args(betas[0], X, Xm, y, counts)
    s_dim, n, _ = X.shape
    if tuple(fold_ids.shape) != (s_dim, n) or \
            tuple(fold_of.shape) != (betas.shape[0],):
        raise ValueError("fold_ids must be (S, N) and fold_of (C,)")
    if fold_ids.dtype != torch.int32 or fold_of.dtype != torch.int32:
        raise TypeError("fold_ids and fold_of must be int32")
    if len({t.device for t in (betas, X, fold_ids, fold_of)}) != 1:
        raise ValueError("betas, X, fold_ids, fold_of must be on one device")


def fused_irls_cv_plain(betas, X, Xm, y, counts, fold_ids, fold_of):
    """Plain PyTorch K5: (H (C,S,d,d) f32, g (C,S,d), dev_train (C,S),
    dev_val (C,S), correct_val (C,S), count_val (C,S)), all but H f64."""
    _check_cv_args(betas, X, Xm, y, counts, fold_ids, fold_of)
    w, *rest = masked_cv_terms(betas, X, y, counts, fold_ids, fold_of)
    w32 = w.to(torch.float32)
    # one 2-D product per (configuration, institution), as K3's plain
    # version: cuBLAS's batched product over S summed the same float32
    # terms with 75x the kernel's error (0.128 against 0.0017 at the
    # refit shape, chip_smoke.py's float64 check on an H100 80GB HBM3 at
    # 700 W)
    H = torch.stack([
        torch.stack([(Xm[j] * w32[c, j][:, None]).T @ Xm[j]
                     for j in range(X.shape[0])])
        for c in range(betas.shape[0])])
    return (H, *rest)


@functools.lru_cache(maxsize=None)
def irls_plan(kernel: str, d: int, device) -> dict:
    """What ``repro_<kernel>_plan`` (``kernel`` is "k3", "k5" or "k6")
    reports at dimension ``d``: configurations a rows block, the rows
    kernel's and the Gram kernel's tile rows, the Gram blocks a
    configuration (past d = 32 the pairs of 128-column ranges of H's upper
    half; one block, the whole upper block, up to it) and the blocks an SM
    the Gram kernel's registers and shared memory allow; with the device's
    SM count."""
    out = (ctypes.c_int * 5)()
    _build.check(getattr(_build.library(), f"repro_{kernel}_plan")(d, out),
                 f"repro_{kernel}_plan")
    plan = dict(zip(("cb", "tn_rows", "tn_gram", "units", "gram_per_sm"),
                    out))
    plan["sms"] = torch.cuda.get_device_properties(device) \
        .multi_processor_count
    return plan


def _gram_slices(per_slice: int, n: int, plan: dict) -> int:
    """Row slices of a Gram launch of ``per_slice`` blocks a slice over
    ``n`` rows.  The Gram kernel runs in waves of its blocks an SM times
    the SM count: the first slice count, from one that fills a wave,
    whose waves are at least 95% full (up to 4 times that count and 8
    more: a launch of more blocks than a wave, K5's 400 at d 500, finds
    its count past the first few), and no slice shorter than a tile."""
    wave = max(1, plan["gram_per_sm"]) * plan["sms"]
    first = max(1, math.ceil(wave / per_slice))
    nsl = next((c for c in range(first, 4 * first + 9)
                if c * per_slice / (-(-c * per_slice // wave) * wave)
                >= 0.95), first)
    return max(1, min(nsl, math.ceil(n / plan["tn_gram"])))


def cv_launch_shape(c_dim: int, s_dim: int, n: int, d: int, device,
                    kernel: str = "k5") -> dict:
    """K5's (or, ``kernel="k3"``, K3's) launch shape for ``c_dim``
    configurations x ``s_dim`` institutions of ``n`` rows at dimension
    ``d``: the rows kernel (grid: configuration chunks x slices x
    institutions) takes about two blocks per SM, no slice shorter than a
    tile; the Gram kernel's grid has ``c_dim * s_dim * units`` blocks a
    slice (:func:`_gram_slices`)."""
    plan = irls_plan(kernel, d, device)
    chunks = -(-c_dim // plan["cb"])
    nsl_r = max(1, min(math.ceil(2 * plan["sms"] / (chunks * s_dim)),
                       math.ceil(n / plan["tn_rows"])))
    nsl_g = _gram_slices(c_dim * s_dim * plan["units"], n, plan)
    return dict(nsl_rows=nsl_r, tn_rows=plan["tn_rows"], nsl_gram=nsl_g)


def _k5_work(betas, X, *_):
    c_dim = betas.shape[0]
    s_dim, n, d = X.shape
    return _work.k5_fused_irls_cv(s_dim * n, c_dim * s_dim * n, d, c_dim,
                                  s_dim)


@_cost.kernel("K5", _k5_work)
@_gate.kernel
def fused_irls_cv_kernel(betas, X, Xm, y, counts, fold_ids, fold_of):
    """K5 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors, the outputs' shapes for ``meta``
    tensors.  Returns what the plain version does."""
    if _build.plain(X, "K5"):
        return fused_irls_cv_plain(betas, X, Xm, y, counts, fold_ids,
                                   fold_of)
    _check_cv_args(betas, X, Xm, y, counts, fold_ids, fold_of)
    c_dim = betas.shape[0]
    s_dim, n, d = X.shape
    if d > _MAX_DIM:
        raise ValueError(f"K5 supports d <= {_MAX_DIM}, got {d}")
    if X.device.type == "meta":
        f64 = torch.float64
        return (torch.empty((c_dim, s_dim, d, d), dtype=torch.float32,
                            device=X.device),
                torch.empty((c_dim, s_dim, d), dtype=f64, device=X.device),
                *torch.empty((4, c_dim, s_dim), dtype=f64,
                             device=X.device).unbind(0))
    betas, X, Xm, y, counts, fold_ids, fold_of = (
        t.contiguous() for t in (betas, X, Xm, y, counts, fold_ids, fold_of))
    shape = cv_launch_shape(c_dim, s_dim, n, d, X.device)
    nsl_r, nsl_g = shape["nsl_rows"], shape["nsl_gram"]
    dev_ = X.device
    f32, f64 = torch.float32, torch.float64
    H = torch.empty((c_dim, s_dim, d, d), dtype=f32, device=dev_)
    g = torch.empty((c_dim, s_dim, d), dtype=f64, device=dev_)
    stats = torch.empty((4, c_dim, s_dim), dtype=f64, device=dev_)
    # scratch: the train weights the rows kernel hands the Gram kernel;
    # per-slice partials, H's upper half packed row by row
    w = torch.empty((c_dim, s_dim, n), dtype=f32, device=dev_)
    Hp = torch.empty((c_dim, s_dim, nsl_g, d * (d + 1) // 2), dtype=f32,
                     device=dev_)
    gp = torch.empty((c_dim, s_dim, nsl_r, d), dtype=f64, device=dev_)
    sp = torch.empty((c_dim, s_dim, nsl_r, 4), dtype=f64, device=dev_)
    err = _build.library().repro_k5_fused_irls_cv(
        betas.data_ptr(), X.data_ptr(), Xm.data_ptr(), y.data_ptr(),
        counts.data_ptr(), fold_ids.data_ptr(), fold_of.data_ptr(),
        H.data_ptr(), g.data_ptr(), stats.data_ptr(), w.data_ptr(),
        Hp.data_ptr(), gp.data_ptr(), sp.data_ptr(), s_dim, n, d, c_dim,
        nsl_r, shape["tn_rows"], nsl_g,
        torch.cuda.current_stream(dev_).cuda_stream,
    )
    _build.check(err, "K5 fused_irls_cv")
    fused_irls_cv_kernel.launches += 1
    return (H, g, *stats.unbind(0))


fused_irls_cv_kernel.launches = 0


# -- K6: the weighted Gram for caller-given weights --------------------------

def _check_gram_args(X, w):
    if X.dim() != 2 or w.dim() != 1 or w.shape[0] != X.shape[0]:
        raise ValueError(f"X must be (N, d) and w (N,), got "
                         f"{tuple(X.shape)} and {tuple(w.shape)}")
    if not X.dtype.is_floating_point or not w.dtype.is_floating_point:
        raise TypeError(f"X and w must be floating point, got {X.dtype} "
                        f"and {w.dtype}")
    if X.device != w.device:
        raise ValueError("X and w must be on one device")


def gram_hessian_plain(X, w):
    """Plain PyTorch K6: (d, d) float32 X^T diag(w) X, from X and w cast
    to float32 once, the products (x_i w) x_j summed in float32."""
    _check_gram_args(X, w)
    return gram_hessian(X, w)


@_cost.kernel("K6", lambda X, w: _work.k6_gram_hessian(*X.shape))
@_gate.kernel
def gram_hessian_kernel(X, w):
    """K6 on the tensors' device: the CUDA kernels for CUDA tensors, the
    plain version for CPU tensors, H's shape for ``meta`` tensors.  X (N,
    d) and w (N,) of any float dtype are cast to float32 once; returns H
    (d, d) float32."""
    if _build.plain(X, "K6"):
        return gram_hessian_plain(X, w)
    _check_gram_args(X, w)
    n, d = X.shape
    if d > _MAX_DIM:
        raise ValueError(f"K6 supports d <= {_MAX_DIM}, got {d}")
    if X.device.type == "meta":
        return torch.empty((d, d), dtype=torch.float32, device=X.device)
    Xm = X.to(torch.float32).contiguous()
    w32 = w.to(torch.float32).contiguous()
    plan = irls_plan("k6", d, X.device)
    nsl = _gram_slices(plan["units"], n, plan)
    H = torch.empty((d, d), dtype=torch.float32, device=X.device)
    # scratch: the per-slice partials, H's upper half packed row by row
    Hp = torch.empty((nsl, d * (d + 1) // 2), dtype=torch.float32,
                     device=X.device)
    err = _build.library().repro_k6_gram_hessian(
        Xm.data_ptr(), w32.data_ptr(), H.data_ptr(), Hp.data_ptr(), n, d,
        nsl, torch.cuda.current_stream(X.device).cuda_stream,
    )
    _build.check(err, "K6 gram_hessian")
    gram_hessian_kernel.launches += 1
    return H


gram_hessian_kernel.launches = 0
