"""The work the program's kernels must do, from the cell's shapes: bytes
moved and operations by type.  A frozen copy of the program's
``repro_torch/kernels/work.py`` for K1, K2, K3 and K5, and for the flash
attention kernels K7, K8a and K8b of a training step, with one change to
K3 and K5:

K3 and K5 read X once **in float64, 8 bytes an element**.  The program
keeps a float32 copy ``Xm`` beside ``X`` and its kernels read both (12
bytes an element); the configuration fixes only the float64 rows (their
z, p, g and deviance are float64) and a float32 Gram, which a kernel can
round from the float64 rows it reads anyway.  The second copy is the
program's choice, not work the summaries need, so it is not counted: a
later program that drops it cannot read above 100%.

Conventions (the program's): each input read once and each output
written once, whatever a kernel reads again; the float32 Gram is three
TF32 products of its upper half; work that depends on the data (the
valid rows, the folds) is counted for the rows these inputs have.
Besides the kernels, ``lu_solve`` counts the float64 Newton solve.
Attention counts only the allowed (causal) pairs; bf16 inputs run on the
tensor cores, float32 on the CUDA cores.
"""
from __future__ import annotations

import dataclasses

from . import peaks


@dataclasses.dataclass(frozen=True)
class Work:
    """Bytes moved and operations by type: ``tf32`` (tensor cores),
    ``f64``, ``f32`` and ``bf16``."""

    bytes: int
    tf32: int = 0
    f64: int = 0
    f32: int = 0
    bf16: int = 0

    def ops_s(self) -> float:
        """The least seconds of its operations: each type at its own peak
        on its own pipe, so the longest of them."""
        return max(getattr(self, k) / rate for k, rate in peaks.RATE.items())

    def least_s(self) -> float:
        """The roofline: the larger of the bytes' and the operations'
        least time."""
        return max(self.bytes / peaks.BYTES, self.ops_s())


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
    """K3 over ``rows`` valid rows: X (float64) and y read once, beta
    read, H (float32), g and dev written; the symmetric Gram as three
    TF32 products, z, p, g and dev in float64."""
    return Work(rows * (d * 8 + 8) + d * 8
                + institutions * (d * d * 4 + d * 8 + 8),
                tf32=3 * rows * d * (d + 1), f64=rows * (4 * d + 30))


def k5_fused_irls_cv(rows: int, train_rows: int, d: int, configs: int,
                     institutions: int) -> Work:
    """K5 over ``rows`` valid rows, ``train_rows`` of them in some
    configuration's training folds (summed over configurations): X
    (float64), y and the fold ids read once, each configuration's beta
    read and its H, g and four statistics written; a symmetric Gram and g
    over the train rows, z and the deviance terms over every valid row."""
    return Work(rows * (d * 8 + 8 + 4) + configs * (d * 8 + 4)
                + configs * institutions * (d * d * 4 + d * 8 + 4 * 8),
                tf32=3 * train_rows * d * (d + 1),
                f64=configs * rows * (2 * d + 30) + train_rows * 2 * d)


def lu_solve(d: int, configs: int = 1) -> Work:
    """The Newton step's float64 solve of (H + lam I) x = r, ``configs``
    times: an LU factorisation (2/3 d^3) and two triangular solves
    (2 d^2); the matrix read and the solution written."""
    return Work(configs * (d * d + 2 * d) * 8,
                f64=configs * (2 * d ** 3 // 3 + 2 * d * d))


def _flash_ops(esize: int, n: int) -> dict:
    """bf16 inputs run on the tensor cores, float32 on the CUDA cores."""
    return {"bf16": n} if esize == 2 else {"f32": n}


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
