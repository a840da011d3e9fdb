"""The plain reference: pooled L2-regularized logistic regression by
Newton's method, its K-fold cross-validated λ path with the 1-SE pick,
and the protocol's wire count, in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
reads the benchmark's own parts, works out the folds again from the
protocol's rule, and sums every institution's rows part by part.  It
runs in float64 with TF32 off; ``dtype=torch.float32`` (TF32 on) is the
control, the same arithmetic one precision below what the configuration
states.

The objective is the program's: deviance + λ ||β||², deviance
= 2 Σ (log(1 + e^η) - y η); the Newton step β + (H + λI)^-1 (g - λβ)
with H = Xᵀ diag(p(1-p)) X and g = Xᵀ (y - p).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import zlib

import numpy as np
import torch
import torch.nn.functional as F

# stop when a Newton step moves no coefficient by more than this share of
# the largest: float64 reaches it in a few quadratic steps; float32 never
# gets below its rounding, so the control stops at its own floor
STEP_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
MAX_ITER = 50


@contextlib.contextmanager
def precision(dtype):
    """TF32 off for the float64 reference, on for the float32 control."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    tf32 = dtype == torch.float32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def as_dtype(parts, dtype):
    """The parts in ``dtype`` (the same tensors where they already are)."""
    return [(X.to(dtype), y.to(dtype)) for X, y in parts]


def summaries(parts, beta, masks=None, hessian=True):
    """(H, g, deviance) summed over the parts' rows (``masks``: one 0/1
    row weight a part, or None for every row)."""
    d = beta.shape[0]
    H = torch.zeros((d, d), dtype=beta.dtype, device=beta.device)
    g = torch.zeros((d,), dtype=beta.dtype, device=beta.device)
    dev = torch.zeros((), dtype=beta.dtype, device=beta.device)
    for j, (X, y) in enumerate(parts):
        eta = X @ beta
        p = torch.sigmoid(eta)
        r, terms = y - p, 2.0 * (F.softplus(eta) - y * eta)
        w = p * (1.0 - p) if hessian else None
        if masks is not None:
            m = masks[j]
            r, terms = r * m, terms * m
            w = w * m if hessian else None
        g += X.T @ r
        dev += terms.sum()
        if hessian:
            H += X.T @ (X * w[:, None])
    return H, g, dev


@dataclasses.dataclass
class Fit:
    beta: torch.Tensor
    objective: float
    iterations: int


def irls(parts, lam: float, masks=None, beta0=None, dtype=torch.float64):
    """Newton's method on deviance + λ ||β||² from ``beta0`` (zeros)."""
    d = parts[0][0].shape[1]
    device = parts[0][0].device
    beta = (torch.zeros((d,), dtype=dtype, device=device) if beta0 is None
            else beta0.to(dtype=dtype, device=device).clone())
    eye = torch.eye(d, dtype=dtype, device=device)
    it = 0
    for it in range(1, MAX_ITER + 1):
        H, g, _ = summaries(parts, beta, masks)
        step = torch.linalg.solve(H + lam * eye, g - lam * beta)
        beta = beta + step
        moved = float(step.abs().max())
        if moved <= STEP_RTOL[dtype] * max(1.0, float(beta.abs().max())):
            break
    _, _, dev = summaries(parts, beta, masks, hessian=False)
    return Fit(beta, float(dev + lam * (beta @ beta)), it)


def fold_ids(num_rows: int, num_folds: int, name, fold_seed: int):
    """The protocol's fold rule, worked out again: a balanced
    ``arange % K`` pattern permuted by a CPU generator seeded from the
    fold seed and the crc32 of the institution's name."""
    crc = zlib.crc32(str(name).encode()) & 0x7FFFFFFF
    gen = torch.Generator()
    gen.manual_seed(((int(fold_seed) & 0xFFFFFFFF) << 31) | crc)
    pattern = torch.arange(num_rows, dtype=torch.int32) % num_folds
    return pattern[torch.randperm(num_rows, generator=gen)]


def one_se_rule(cv_mean, cv_se) -> tuple[int, int]:
    """(best, 1-SE pick) over a descending λ grid: the largest λ whose CV
    mean is within one standard error of the smallest."""
    best = int(np.argmin(cv_mean))
    bar = cv_mean[best] + cv_se[best]
    pick = next(i for i in range(len(cv_mean)) if cv_mean[i] <= bar)
    return best, pick


@dataclasses.dataclass
class CVPath:
    val_deviance: np.ndarray  # (L, K)
    val_count: np.ndarray  # (L, K)
    cv_mean: np.ndarray  # (L,)
    best_index: int
    one_se_index: int


def cv_path(parts, lambdas, num_folds: int, fold_seed: int,
            dtype=torch.float64) -> CVPath:
    """Every (λ, fold) fit on the train folds, its held-out deviance and
    row count, the CV curve and its picks.  Each fold's fit starts from
    its fit at the previous λ (the optimum is the same from anywhere)."""
    device = parts[0][0].device
    folds = [fold_ids(X.shape[0], num_folds, j, fold_seed).to(device)
             for j, (X, _) in enumerate(parts)]
    L, K = len(lambdas), num_folds
    vdev, vcnt = np.zeros((L, K)), np.zeros((L, K))
    train = [[(f != k).to(dtype) for f in folds] for k in range(K)]
    held = [[(f == k).to(dtype) for f in folds] for k in range(K)]
    warm = [None] * K
    for li, lam in enumerate(lambdas):
        for k in range(K):
            fit = irls(parts, lam, train[k], warm[k], dtype)
            warm[k] = fit.beta
            _, _, dev = summaries(parts, fit.beta, held[k], hessian=False)
            vdev[li, k] = float(dev)
            vcnt[li, k] = float(sum(float(h.sum()) for h in held[k]))
    per_row = vdev / np.maximum(vcnt, 1.0)
    cv_mean = per_row.mean(axis=1)
    cv_se = per_row.std(axis=1, ddof=1) / math.sqrt(K)
    best, pick = one_se_rule(cv_mean, cv_se)
    return CVPath(vdev, vcnt, cv_mean, best, pick)


def round_bytes(config: dict, configs: int = 1,
                include_count: bool = False, extra_scalars: int = 0) -> int:
    """The protocol's wire bytes of one round with every summary
    protected ("both"): each institution's gradient (d), Hessian (d x d)
    and scalars go as one flat buffer of 128-wide rows, padded to a
    multiple of 8 rows, sent as int32 shares, one slice a center a CRT
    residue; ``configs`` such buffers an institution a round."""
    if config["protect"] != "both":
        raise ValueError("the wire count is stated for protect='both'")
    d = config["features"]
    n = d + d * d + (2 if include_count else 1) + extra_scalars
    rows = -(-max(1, -(-n // 128)) // 8) * 8
    share = config["centers"] * len(config["moduli"]) * rows * 128 * 4
    return configs * config["institutions"] * share


def wire_elements(config: dict, **kw) -> int:
    """Elements of one institution's flat buffer for one configuration
    (the rows ``round_bytes(config, **kw)`` counts, times 128)."""
    return round_bytes(config, **kw) // (
        config["institutions"] * config["centers"]
        * len(config["moduli"]) * 4)
