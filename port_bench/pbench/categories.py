"""Device-time categories by kernel-name substring, first hit wins; an
entry names the table its kernels fall in (its ``CATEGORIES``).

``CATEGORIES``, a secure round's: a frozen copy of
``chip_smoke.py::CATEGORIES``, with the batched LU's helper kernels
(``dgetf2_fused_batched``, ``setup_pivinfo``, ``gemm_template_batched``),
which the path's five solves a round launch, added to "solve".

``TRAIN_CATEGORIES``, a training step's: a frozen copy of
``chip_smoke.py::TRAIN_CATEGORIES`` (K7 and K8 by their kernels' names,
cuBLAS's bf16 matmuls as ``nvjet_*``, the rest by its PyTorch kernel).
"""
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
TRAIN_CATEGORIES = (
    ("K7 flash_attention", ("flash_attention_fwd", "flash_fwd_bf16")),
    ("K8a flash_dq", ("flash_dq_kernel", "flash_dq_bf16")),
    ("K8b flash_dkdv", ("flash_dkdv_kernel", "flash_dkdv_bf16")),
    ("matmul (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass", "sm90_",
                         "splitKreduce")),
    ("softmax / log_softmax", ("softmax",)),
    ("copies and casts", ("direct_copy", "bfloat16_copy", "CatArray")),
    ("memcpy/memset", ("Memcpy", "Memset", "memcpy", "memset")),
)
OTHER = "small ops"


def category(name: str, table=CATEGORIES) -> str:
    for cat, keys in table:
        if any(k in name for k in keys):
            return cat
    return OTHER
