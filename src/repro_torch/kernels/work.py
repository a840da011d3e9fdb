"""The work each kernel must do, from its shapes: the bytes it moves and
the operations it computes, by type.

One definition for two readers.  ``chip_smoke.py`` turns a kernel's work
into its bound (the least time the H100 could take: the larger of the
bytes over the memory rate and each type's operations over that type's
peak), and the cost counter (``launch/cost_analysis.py``) adds it to a
run's totals, since a ``ctypes`` launch is invisible to a dispatch mode:
each kernel wrapper charges its work through ``obs/cost.py`` on every
device, the ``meta`` device included.

The convention is ``chip_smoke.py``'s: each input read once and each
output written once, whatever the kernel reads again; attention counts
only the causal pairs; the float32 Gram of K3, K5 and K6 is three TF32
products of its upper half, the least work that keeps float32's
precision on the tensor cores.  Where the work depends on the data (K3's
ragged row counts, K5's folds), a caller that can see the data passes
the rows it needs; a wrapper, which reads nothing back from the card,
charges every row its launch covers.
"""
from __future__ import annotations

import dataclasses

__all__ = ["Work", "k1_encode_share", "k2_reconstruct", "k3_fused_irls",
           "k4_share", "k5_fused_irls_cv", "k6_gram_hessian", "k7_flash",
           "k8a_flash_dq", "k8b_flash_dkdv"]


@dataclasses.dataclass(frozen=True)
class Work:
    """Bytes moved and operations by type: ``bf16`` (tensor cores),
    ``tf32`` (tensor cores), ``f32`` (CUDA cores) and ``f64``."""

    bytes: int
    bf16: int = 0
    tf32: int = 0
    f32: int = 0
    f64: int = 0

    @property
    def ops(self) -> int:
        """Every operation, whatever its type."""
        return self.bf16 + self.tf32 + self.f32 + self.f64


def _flash_ops(esize: int, n: int) -> dict:
    """bf16 inputs run on the tensor cores, float32 on the CUDA cores."""
    return {"bf16": n} if esize == 2 else {"f32": n}


def k1_encode_share(n: int, payload_bytes: int, residues: int,
                    t_minus_1: int, points: int) -> Work:
    """K1 over ``n`` elements: the payload and the coefficients read once,
    each point's int32 shares written; one float64 encode an element."""
    return Work(n * (payload_bytes + residues * 4 * t_minus_1
                     + points * residues * 4), f64=n)


def k2_reconstruct(n: int, shares: int, residues: int,
                   decode: bool) -> Work:
    """K2 over ``n`` elements: ``shares`` x ``residues`` int32 shares read
    once, the float64 aggregate (or the int32 residues) written; one
    float64 decode an element."""
    out = 8 if decode else residues * 4
    return Work(n * (shares * residues * 4 + out), f64=n)


def k3_fused_irls(rows: int, d: int, institutions: int) -> Work:
    """K3 over ``rows`` valid rows: X (float64), Xm (float32) and y read
    once, beta read, H, g and dev written; the symmetric Gram as three
    TF32 products, z, p, g and dev in float64."""
    return Work(rows * (d * 12 + 8) + d * 8
                + institutions * (d * d * 4 + d * 8 + 8),
                tf32=3 * rows * d * (d + 1), f64=rows * (4 * d + 30))


def k4_share(n: int, residues: int, t_minus_1: int, shares: int) -> Work:
    """K4 over ``n`` elements a residue: the int64 secret and coefficients
    read once, the int64 shares written.  Its integer multiply-high steps
    have no peak in the float table, so the bytes bound it."""
    return Work(residues * n * 8 * (1 + t_minus_1 + shares))


def k5_fused_irls_cv(rows: int, train_rows: int, d: int, configs: int,
                     institutions: int) -> Work:
    """K5 over ``rows`` valid rows, ``train_rows`` of them in some
    configuration's training folds (summed over configurations): X, Xm, y
    and the fold ids read once, each configuration's beta read and its H,
    g and four statistics written; a symmetric Gram and g over the train
    rows, z and the deviance terms over every valid row."""
    return Work(rows * (d * 12 + 8 + 4) + configs * (d * 8 + 4)
                + configs * institutions * (d * d * 4 + d * 8 + 4 * 8),
                tf32=3 * train_rows * d * (d + 1),
                f64=configs * rows * (2 * d + 30) + train_rows * 2 * d)


def k6_gram_hessian(n: int, d: int) -> Work:
    """K6 over (n, d): X and w (float32) read once, H written; the
    symmetric Gram as three TF32 products."""
    return Work(n * (d + 1) * 4 + d * d * 4, tf32=3 * n * d * (d + 1))


def k7_flash(b: int, s: int, h: int, kvh: int, d: int, esize: int,
             dv: int | None = None) -> Work:
    """K7 on (B, S, H, D) queries over KVH heads: q, k, v read once, o
    written, m and l (float32); each allowed (query, key) pair of the
    causal half 2 D for q.k and 2 Dv for p v.  ``dv`` (default D) counts
    the function's own work where V is zero-padded to D (MLA)."""
    dv = dv or d
    return Work((b * s * h * (d + dv) + b * s * kvh * (d + dv)) * esize
                + 2 * b * h * s * 4,
                **_flash_ops(esize, b * h * s * (s + 1) // 2 * 2 * (d + dv)))


def _k8_inputs(b, s, h, kvh, d, dv, esize) -> int:
    """q, k, v, do (input dtype) and m, linv, delta (float32)."""
    return ((b * s * h * (d + dv) + b * s * kvh * (d + dv)) * esize
            + 3 * b * h * s * 4)


def k8a_flash_dq(b: int, s: int, h: int, kvh: int, d: int, esize: int,
                 dv: int | None = None) -> Work:
    """K8a: its inputs read once, dq written; per allowed pair q.k, do.v
    and ds k: 4 D + 2 Dv."""
    dv = dv or d
    pairs = b * h * s * (s + 1) // 2
    return Work(_k8_inputs(b, s, h, kvh, d, dv, esize) + b * s * h * d * esize,
                **_flash_ops(esize, pairs * (4 * d + 2 * dv)))


def k8b_flash_dkdv(b: int, s: int, h: int, kvh: int, d: int, esize: int,
                   dv: int | None = None) -> Work:
    """K8b: its inputs read once, dk and dv written; per allowed pair
    q.k, do.v, p do and ds q: 4 (D + Dv)."""
    dv = dv or d
    pairs = b * h * s * (s + 1) // 2
    return Work(_k8_inputs(b, s, h, kvh, d, dv, esize)
                + b * s * kvh * (d + dv) * esize,
                **_flash_ops(esize, pairs * 4 * (d + dv)))
