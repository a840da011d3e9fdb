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

__all__ = ["SOURCES", "library", "build", "build_log", "check"]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
SOURCES = ("shamir_poly.cu", "shamir_share.cu", "shamir_reconstruct.cu",
           "fused_irls.cu", "fused_irls_cv.cu", "gram_hessian.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp, _i, _ll, _d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
# C signature of every entry point: (argtypes); each returns cudaError_t
_SIGNATURES = {
    # x, x_is_f64, coeffs, out, n, R, t-1, moduli*, points*, npoints,
    # lim, scale, stream
    "repro_k1_encode_share": (_vp, _i, _vp, _vp, _ll, _i, _i, _vp, _vp, _i,
                              _d, _d, _vp),
    # secret, coeffs, out, n, R, t-1, moduli*, w, stream
    "repro_k4_share": (_vp, _vp, _vp, _ll, _i, _i, _vp, _i, _vp),
    # shares, out, n, k, R, lams*, moduli*, decode, scale, stream
    "repro_k2_reconstruct": (_vp, _vp, _ll, _i, _i, _vp, _vp, _i, _d, _vp),
    # beta, X, Xm, y, counts, H, g, dev, Hp, gp, devp, S, n_max, d, C, TN,
    # stream
    "repro_k3_fused_irls": (_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                            _vp, _vp, _i, _ll, _i, _i, _i, _vp),
    # betas, X, Xm, y, counts, fold_ids, fold_of, H, g, stats, Hp, gp, sp,
    # S, n_max, d, Q, NSL, TN, stream
    "repro_k5_fused_irls_cv": (_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                               _vp, _vp, _vp, _vp, _i, _ll, _i, _i, _i, _i,
                               _vp),
    # X, w, H, Hp, n, d, C, TN, stream
    "repro_k6_gram_hessian": (_vp, _vp, _vp, _vp, _ll, _i, _i, _i, _vp),
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
    for name in SOURCES:
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
