"""K3: every institution's IRLS summaries (H_j, g_j, dev_j) in one pass.

The port of the JAX package's ``kernels/fused_irls.py::fused_irls_pallas``.
The CUDA kernel lives in ``csrc/fused_irls.cu``; :func:`fused_irls_plain`
beside it is the same function in plain PyTorch — the CPU path and the
kernel's oracle.  Both keep the JAX ``fused_irls_sim`` precision contract:

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
from .ref import masked_irls_terms

__all__ = ["fused_irls_kernel", "fused_irls_plain"]

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
