"""Plain PyTorch oracles for the port's kernels (the correctness ground
truth the kernel-level plain versions are themselves tested against)."""
from __future__ import annotations

import torch

__all__ = ["cv_masks", "fused_irls", "gram_hessian", "masked_cv_terms",
           "masked_irls_terms", "shamir_shares"]


def gram_hessian(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """X^T diag(w) X with float32 operands and float32 accumulation."""
    Xw = X.to(torch.float32) * w.to(torch.float32)[:, None]
    return Xw.T @ X.to(torch.float32)


def masked_irls_terms(beta: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
                      counts: torch.Tensor):
    """The IRLS terms every summaries path shares, in X's dtype: the
    masked weights w = p (1 - p) (S, N_max), g (S, d) and dev (S,).

    X: (S, N_max, d); rows >= counts[s] are masked out of every sum.
    """
    n = X.shape[1]
    mask = (torch.arange(n, device=X.device)[None, :]
            < counts[:, None]).to(X.dtype)
    z = torch.einsum("snd,d->sn", X, beta.to(X.dtype))
    p = torch.sigmoid(z)
    w = p * (1.0 - p) * mask
    g = torch.einsum("snd,sn->sd", X, (y - p) * mask)
    dev = -2.0 * torch.sum(
        (y * z - torch.logaddexp(torch.zeros_like(z), z)) * mask, dim=1
    )
    return w, g, dev


def fused_irls(beta: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
               counts: torch.Tensor | None = None):
    """Batched masked IRLS summaries oracle: (H (S,d,d), g (S,d), dev (S,)).

    Computed in the input dtype (float64 in tests) — the kernel's float32
    Gram is compared against this at matmul tolerance.  It is also the
    ``"reference"`` summaries rung.
    """
    s_dim, n, _ = X.shape
    if counts is None:
        counts = torch.full((s_dim,), n, dtype=torch.int32, device=X.device)
    w, g, dev = masked_irls_terms(beta, X, y, counts)
    H = torch.einsum("sni,snj->sij", X * w[..., None], X)
    return H, g, dev


def cv_masks(n: int, counts: torch.Tensor, fold_ids: torch.Tensor,
             fold_of: torch.Tensor):
    """(train, hold) bool (C, S, N): the row mask first, then the fold
    compare, so a padding row (fold id -1) never joins a refit
    configuration's (fold_of = -1) held-out set."""
    valid = (torch.arange(n, device=fold_ids.device)[None, :]
             < counts[:, None])  # (S, N)
    hold = valid[None] & (fold_ids[None] == fold_of[:, None, None])
    return valid[None] & ~hold, hold


def masked_cv_terms(betas: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
                    counts: torch.Tensor, fold_ids: torch.Tensor,
                    fold_of: torch.Tensor):
    """The cross-validated terms every path shares, in float64, for C
    configurations (``betas`` (C, d), held-out fold ``fold_of`` (C,)):
    train-fold IRLS weights w (C, S, N), g (C, S, d), dev_train, dev_val,
    correct_val and count_val (C, S).  Only the Gram is left to the
    caller."""
    train, hold = cv_masks(X.shape[1], counts, fold_ids, fold_of)
    tmask, vmask = train.to(torch.float64), hold.to(torch.float64)
    z = torch.einsum("snd,cd->csn", X, betas.to(X.dtype))
    p = torch.sigmoid(z)
    ll = y[None] * z - torch.logaddexp(torch.zeros_like(z), z)
    dev_tr = -2.0 * torch.sum(ll * tmask, dim=2)
    dev_va = -2.0 * torch.sum(ll * vmask, dim=2)
    correct = torch.sum(
        torch.where((z > 0.0) == (y[None] > 0.5), vmask, 0.0), dim=2)
    g = torch.einsum("csn,snd->csd", (y[None] - p) * tmask, X)
    w = p * (1.0 - p) * tmask
    return w, g, dev_tr, dev_va, correct, vmask.sum(dim=2)


def shamir_shares(secret: torch.Tensor, coeffs: torch.Tensor,
                  num_shares: int, modulus: int) -> torch.Tensor:
    """Horner evaluation of q(x) = secret + sum_k coeffs[k] x^(k+1) at
    x = 1..num_shares, all mod ``modulus``, in int64 (products of reduced
    31-bit values fit).  secret: (n,), coeffs: (t-1, n).  Returns
    (num_shares, n) int64.
    """
    out = []
    for x in range(1, num_shares + 1):
        acc = torch.zeros_like(secret)
        for k in range(coeffs.shape[0] - 1, -1, -1):
            acc = (acc * x + coeffs[k]) % modulus
        out.append((acc * x + secret) % modulus)
    return torch.stack(out)
