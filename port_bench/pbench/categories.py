"""Device-time categories of a secure round, by kernel-name substring,
first hit wins: a frozen copy of ``chip_smoke.py::CATEGORIES`` (the round
categories; the LM categories are for later cells), with the batched LU's
helper kernels (``dgetf2_fused_batched``, ``setup_pivinfo``,
``gemm_template_batched``), which the path's five solves a round launch,
added to "solve"."""
from __future__ import annotations

CATEGORIES = (
    ("K5", ("irls_cv_rows_kernel", "irls_cv_gram_kernel",
            "irls_cv_reduce_kernel")),
    ("K3", ("k3_rows_kernel", "k3_gram_kernel", "k3_reduce_kernel")),
    ("K1", ("encode_share",)),
    ("K2", ("reconstruct_kernel",)),
    ("K4", ("leafwise_share",)),
    ("K6", ("k6_gram_kernel", "k6_reduce_kernel")),
    ("solve", ("getrf", "getrs", "getf2", "laswp", "trsm", "trsv", "ipiv",
               "pivinfo", "lu_", "magma", "solve", "gemv", "batch_",
               "gemm_template_batched")),
    ("memcpy/memset", ("Memcpy", "Memset", "memcpy", "memset")),
)
OTHER = "small ops"


def category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return OTHER
