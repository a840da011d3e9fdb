"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every source under ``csrc/`` exposes a plain C interface (pointers, ints,
doubles and the CUDA stream), so the library needs none of PyTorch's
headers and builds in seconds.  The build runs at first use: one ``nvcc
-c`` per source, all started together, then one link into a single
shared library under ``build/`` at the repository root, named by a hash
of the sources and flags, so an edited source rebuilds and an unchanged
one loads at once.  A missing ``nvcc`` raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

__all__ = ["SOURCES", "library", "build", "build_log", "check", "plain"]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
SOURCES = ("shamir_poly.cu", "shamir_share.cu", "shamir_reconstruct.cu",
           "fused_irls.cu", "fused_irls_cv.cu", "gram_hessian.cu",
           "flash_attention.cu", "flash_attention_bwd.cu",
           "kernel_attributes.cu")
# headers the sources include: part of the digest, not compiled alone
HEADERS = ("flash_common.cuh", "tc_common.cuh", "irls_tc.cuh",
           "field_arith.cuh", "kernel_attributes.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp, _i, _ll, _ull, _d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_ulonglong, ctypes.c_double
_pi = ctypes.POINTER(ctypes.c_int)
# C signature of every entry point: (argtypes); each returns cudaError_t
# unless noted
_SIGNATURES = {
    # x, x_is_f64, coeffs, out, n, R, t-1, barrett* ((mu, p) a residue),
    # points* (host), points table* (device, or null), npoints, lim, scale,
    # stream
    "repro_k1_encode_share": (_vp, _i, _vp, _vp, _ll, _i, _i, _vp, _vp, _vp,
                              _i, _d, _d, _vp),
    # secret, coeffs, out, n, R, t-1, barrett* ((mu, p) a residue), w,
    # stream
    "repro_k4_share": (_vp, _vp, _vp, _ll, _i, _i, _vp, _i, _vp),
    # shares, out, n, k, R, lams* (host), lams table* (device, or null),
    # barrett* ((mu, p) a residue), p1^-1 mod p2, decode, 2^-frac_bits,
    # stream
    "repro_k2_reconstruct": (_vp, _vp, _ll, _i, _i, _vp, _vp, _vp, _ull, _i,
                             _d, _vp),
    # beta, X, Xm, y, counts, H, g, dev, w, Hp, gp, sp, S, n_max, d, NSL
    # rows, TN rows, NSL Gram, stream
    "repro_k3_fused_irls": (_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                            _vp, _vp, _vp, _i, _ll, _i, _i, _i, _i, _vp),
    # betas, X, Xm, y, counts, fold_ids, fold_of, H, g, stats, w, Hp, gp,
    # sp, S, n_max, d, Q, NSL rows, TN rows, NSL Gram, stream
    "repro_k5_fused_irls_cv": (_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                               _vp, _vp, _vp, _vp, _vp, _i, _ll, _i, _i, _i,
                               _i, _i, _vp),
    # d, out (5 ints): configurations a rows block, TN rows, TN Gram, Gram
    # units a configuration, Gram blocks an SM; one plan per entry, each
    # asking about its own Gram kernel
    "repro_k3_plan": (_i, _pi),
    "repro_k5_plan": (_i, _pi),
    "repro_k6_plan": (_i, _pi),
    # X, w, H, Hp, n, d, NSL Gram, stream
    "repro_k6_gram_hessian": (_vp, _vp, _vp, _vp, _ll, _i, _i, _vp),
    # q, k, v, o, m, l, B, S, H, KVH, D, is_bf16, scale, stream
    "repro_k7_flash_attention": (_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i,
                                 _i, _i, _i, _d, _vp),
    # q, k, v, do, m, linv, delta, dq, B, S, H, KVH, D, is_bf16, scale,
    # stream
    "repro_k8a_flash_dq": (_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i,
                           _i, _i, _i, _i, _d, _vp),
    # q, k, v, do, m, linv, delta, dk, dv, B, S, H, KVH, D, is_bf16, scale,
    # stream
    "repro_k8b_flash_dkdv": (_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                             _i, _i, _i, _i, _i, _i, _d, _vp),
    # the dynamic shared memory a flash launch asks for: (D, is_bf16) and
    # (0 = K8a or 1 = K8b, D, is_bf16); these return bytes, not an error
    "repro_k7_smem_bytes": (_i, _i),
    "repro_k8_smem_bytes": (_i, _i, _i),
    # out (ReproKernelAttr records), capacity: every instantiation's
    # compiled attributes (kernels/tuning.py); returns the count
    "repro_kernel_attributes": (_vp, _i),
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from "
        "src/repro_torch/csrc/ at first use and need the CUDA toolkit"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_log() -> pathlib.Path:
    """Where the compiler's output (ptxas register/smem report) lands."""
    return BUILD_DIR / f"repro_torch_{_digest()}.log"


def build() -> pathlib.Path:
    """Compile every source (in parallel) and link one shared library."""
    digest = _digest()
    out = BUILD_DIR / f"repro_torch_{digest}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [pathlib.Path(tmp) / (name + ".o") for name in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for name, obj in zip(SOURCES, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        log_text = "".join(
            f"== {name}\n{log}" for name, log in zip(SOURCES, logs)
        )
        build_log().write_text(log_text)
        failed = [n for n, p in zip(SOURCES, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log_text}")
        lib_tmp = pathlib.Path(tmp) / "lib.so"
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(lib_tmp)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        os.replace(lib_tmp, out)  # atomic: concurrent builds agree
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` code from a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def plain(t, what: str) -> bool:
    """Where a kernel wrapper sends ``t``: True for a CPU tensor (the plain
    version), False for a CUDA tensor (the kernel) or a ``meta`` tensor
    (the outputs' shapes, for the dry run); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type not in ("cuda", "meta"):
        raise ValueError(f"no {what} for device {t.device}")
    return False
