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

Each has its plain PyTorch version beside it (``*_plain``) — the CPU path
and the kernel's oracle.  All keep the JAX ``fused_irls_sim`` precision
contract:

* z, p, the residual, g and dev in float64;
* the IRLS weight w = p (1 - p) cast to float32;
* H = Xm^T diag(w) Xm from the float32 operand ``Xm`` with float32
  accumulation (no TF32).

Rows >= counts[s] are masked out of every sum; the kernel never reads
them.  Per the sim, g/dev always accumulate in float64, which is also
what the H100 runs natively.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .ref import gram_hessian, masked_cv_terms, masked_irls_terms

__all__ = ["fused_irls_kernel", "fused_irls_plain", "fused_irls_cv_kernel",
           "fused_irls_cv_plain", "gram_hessian_kernel", "gram_hessian_plain"]

_SMEM_BUDGET = 200 * 1024  # bytes of dynamic shared memory per block
_MAX_TILE_ROWS = 32
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


def launch_shape(s_dim: int, d: int, device) -> tuple[int, int]:
    """(C row slices per institution, TN rows per staged tile)."""
    dpad = -(-d // 128) * 128
    tiles = (dpad // 128) ** 2
    per_row = dpad * 12 + 12  # X f64 + Xm f32 + residual + weight
    tn = min(_MAX_TILE_ROWS, (_SMEM_BUDGET - dpad * 8 - 64) // per_row)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    c = max(1, math.ceil(2 * sms / (s_dim * tiles)))
    return c, tn


def fused_irls_kernel(beta, X, Xm, y, counts):
    """K3 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Returns (H f32, g f64, dev f64)."""
    if X.device.type == "cpu":
        return fused_irls_plain(beta, X, Xm, y, counts)
    if X.device.type != "cuda":
        raise ValueError(f"no K3 for device {X.device}")
    _check_args(beta, X, Xm, y, counts)
    s_dim, n, d = X.shape
    if d > _MAX_DIM:
        raise ValueError(f"K3 supports d <= {_MAX_DIM}, got {d}")
    beta, X, Xm, y, counts = (t.contiguous() for t in (beta, X, Xm, y,
                                                        counts))
    c, tn = launch_shape(s_dim, d, X.device)
    dev_ = X.device
    H = torch.empty((s_dim, d, d), dtype=torch.float32, device=dev_)
    g = torch.empty((s_dim, d), dtype=torch.float64, device=dev_)
    dev = torch.empty((s_dim,), dtype=torch.float64, device=dev_)
    Hp = torch.empty((s_dim, c, d, d), dtype=torch.float32, device=dev_)
    gp = torch.empty((s_dim, c, d), dtype=torch.float64, device=dev_)
    devp = torch.empty((s_dim, c), dtype=torch.float64, device=dev_)
    err = _build.library().repro_k3_fused_irls(
        beta.data_ptr(), X.data_ptr(), Xm.data_ptr(), y.data_ptr(),
        counts.data_ptr(), H.data_ptr(), g.data_ptr(), dev.data_ptr(),
        Hp.data_ptr(), gp.data_ptr(), devp.data_ptr(), s_dim, n, d, c, tn,
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


def cv_launch_shape(pairs: int, d: int, device) -> tuple[int, int]:
    """(row slices per institution, TN rows per staged tile) for K5 over
    ``pairs`` (configuration, institution) pairs.

    One K5 block runs per SM (ptxas gives it 212 registers a thread on
    sm_90a), so the grid runs in waves of ``multi_processor_count`` blocks
    and a partial last wave idles the rest of the card.  Start from K3's
    two blocks per SM and take the first slice count whose waves are at
    least 95% full: at the λ path's 40 pairs, 13 slices (520 blocks, 3.94
    waves of 132) where K3's rule gives 7 (280 blocks, 2.12 waves run as
    3).  On an H100 80GB HBM3 at 700 W that took K5 at the path's shape
    from 4.47 to 3.29 ms (``chip_smoke.py``, both versions in one run).
    """
    nsl, tn = launch_shape(pairs, d, device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_slice = pairs * (-(-d // 128)) ** 2
    for cand in range(nsl, 4 * nsl + 1):
        blocks = cand * per_slice
        if blocks / (-(-blocks // sms) * sms) >= 0.95:
            return cand, tn
    return nsl, tn


def fused_irls_cv_kernel(betas, X, Xm, y, counts, fold_ids, fold_of):
    """K5 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Returns what the plain version does."""
    if X.device.type == "cpu":
        return fused_irls_cv_plain(betas, X, Xm, y, counts, fold_ids,
                                   fold_of)
    if X.device.type != "cuda":
        raise ValueError(f"no K5 for device {X.device}")
    _check_cv_args(betas, X, Xm, y, counts, fold_ids, fold_of)
    c_dim = betas.shape[0]
    s_dim, n, d = X.shape
    if d > _MAX_DIM:
        raise ValueError(f"K5 supports d <= {_MAX_DIM}, got {d}")
    betas, X, Xm, y, counts, fold_ids, fold_of = (
        t.contiguous() for t in (betas, X, Xm, y, counts, fold_ids, fold_of))
    nsl, tn = cv_launch_shape(c_dim * s_dim, d, X.device)
    dev_ = X.device
    f32, f64 = torch.float32, torch.float64
    H = torch.empty((c_dim, s_dim, d, d), dtype=f32, device=dev_)
    g = torch.empty((c_dim, s_dim, d), dtype=f64, device=dev_)
    stats = torch.empty((4, c_dim, s_dim), dtype=f64, device=dev_)
    Hp = torch.empty((c_dim, s_dim, nsl, d, d), dtype=f32, device=dev_)
    gp = torch.empty((c_dim, s_dim, nsl, d), dtype=f64, device=dev_)
    sp = torch.empty((c_dim, s_dim, nsl, 4), dtype=f64, device=dev_)
    err = _build.library().repro_k5_fused_irls_cv(
        betas.data_ptr(), X.data_ptr(), Xm.data_ptr(), y.data_ptr(),
        counts.data_ptr(), fold_ids.data_ptr(), fold_of.data_ptr(),
        H.data_ptr(), g.data_ptr(), stats.data_ptr(), Hp.data_ptr(),
        gp.data_ptr(), sp.data_ptr(), s_dim, n, d, c_dim, nsl, tn,
        torch.cuda.current_stream(dev_).cuda_stream,
    )
    _build.check(err, "K5 fused_irls_cv")
    fused_irls_cv_kernel.launches += 1
    return (H, g, *stats.unbind(0))


fused_irls_cv_kernel.launches = 0


# -- K6: the weighted Gram for caller-given weights --------------------------

_K6_SMEM_BUDGET = 100 * 1024  # two blocks per SM fit in shared memory
_K6_MAX_TILE_ROWS = 64


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


def gram_launch_shape(n: int, d: int, device) -> tuple[int, int]:
    """(C row slices, TN rows per staged tile) for K6: about two blocks
    per SM over the (C, H tiles) grid, and no slice shorter than a tile."""
    dpad = -(-d // 128) * 128
    tn = min(_K6_MAX_TILE_ROWS, _K6_SMEM_BUDGET // ((dpad + 1) * 4))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    c = max(1, min(math.ceil(2 * sms / (dpad // 128) ** 2),
                   math.ceil(n / tn)))
    return c, tn


def gram_hessian_kernel(X, w):
    """K6 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  X (N, d) and w (N,) of any float
    dtype are cast to float32 once; returns H (d, d) float32."""
    if X.device.type == "cpu":
        return gram_hessian_plain(X, w)
    if X.device.type != "cuda":
        raise ValueError(f"no K6 for device {X.device}")
    _check_gram_args(X, w)
    n, d = X.shape
    if d > _MAX_DIM:
        raise ValueError(f"K6 supports d <= {_MAX_DIM}, got {d}")
    Xm = X.to(torch.float32).contiguous()
    w32 = w.to(torch.float32).contiguous()
    c, tn = gram_launch_shape(n, d, X.device)
    H = torch.empty((d, d), dtype=torch.float32, device=X.device)
    Hp = torch.empty((c, d, d), dtype=torch.float32, device=X.device)
    err = _build.library().repro_k6_gram_hessian(
        Xm.data_ptr(), w32.data_ptr(), H.data_ptr(), Hp.data_ptr(), n, d, c,
        tn, torch.cuda.current_stream(X.device).cuda_stream,
    )
    _build.check(err, "K6 gram_hessian")
    gram_hessian_kernel.launches += 1
    return H


gram_hessian_kernel.launches = 0
