"""K8a / K8b: the backward of causal GQA flash attention.

The port of the JAX package's ``kernels/flash_attention_bwd.py``:
``flash_dq_pallas`` (K8a) and ``flash_dkdv_pallas`` (K8b).  The CUDA
kernels in ``csrc/flash_attention_bwd.cu`` recompute each block's scores
from (q, k) and K7's saved statistics, so nothing S x S reaches device
memory; :func:`flash_dq_plain` and :func:`flash_dkdv_plain` are the same
functions in plain PyTorch (materialized scores): the CPU path and the
kernels' oracles.

Inputs, in the port's layouts (see ``flash_attention``): q and do (B, S,
H, D), k and v (B, S, KVH, D), contiguous, one dtype (float32 or
bfloat16); m, linv = 1 / max(l, 1e-30) and delta = sum_d do * o, each (B,
H, S) float32.  dq comes back as (B, S, H, D), dk and dv as (B, S, KVH,
D), in the input dtype.  :func:`flash_attention_backward` is the whole
backward from K7's outputs, as the JAX wrapper (``ops.py:351-352``)
computes delta and linv outside its kernels.

Both kernels take any head_dim up to 256.  In bfloat16 both run on the
tensor cores (mma.sync with cp.async staging), with P and dS multiplied
as two bf16 terms each (hi + lo); in float32 both run on the CUDA cores.
"""
from __future__ import annotations

import torch

from . import _build, work as _work
from ..obs import cost as _cost
from ..obs import gate as _gate
from .flash_attention import _MAX_HEAD_DIM, _check_args
from .ref import causal_p_ds

__all__ = ["flash_attention_backward", "flash_dkdv_kernel",
           "flash_dkdv_plain", "flash_dq_kernel", "flash_dq_plain"]


def _check_bwd_args(q, k, v, do, m, linv, delta):
    _check_args(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must match q {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    B, S, H, _ = q.shape
    for name, t in (("m", m), ("linv", linv), ("delta", delta)):
        if tuple(t.shape) != (B, H, S) or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"{name} must be ({B}, {H}, {S}) float32 on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")


def flash_dq_plain(q, k, v, do, m, linv, delta):
    """Plain PyTorch K8a: dq (B, S, H, D) in q's dtype."""
    _check_bwd_args(q, k, v, do, m, linv, delta)
    B, S, H, D = q.shape
    _, ds = causal_p_ds(q, k, v, do, m, linv, delta)
    dq = torch.einsum("bkgqt,btkd->bqkgd", ds, k.to(torch.float32))
    return (dq * D**-0.5).reshape(B, S, H, D).to(q.dtype)


def flash_dkdv_plain(q, k, v, do, m, linv, delta):
    """Plain PyTorch K8b: (dk, dv) (B, S, KVH, D) in k's and v's dtype,
    each the sum over the G query heads of its group."""
    _check_bwd_args(q, k, v, do, m, linv, delta)
    B, S, H, D = q.shape
    KVH = k.shape[2]
    p, ds = causal_p_ds(q, k, v, do, m, linv, delta)
    qs = q.to(torch.float32).reshape(B, S, KVH, H // KVH, D) * D**-0.5
    dk = torch.einsum("bkgqt,bqkgd->btkd", ds, qs)
    dv = torch.einsum("bkgqt,bqkgd->btkd", p,
                      do.to(torch.float32).reshape(B, S, KVH, H // KVH, D))
    return dk.to(k.dtype), dv.to(v.dtype)


def _check_launch(q, k, v, do, m, linv, delta):
    """The checks the two kernels share (their ``meta`` branches too)."""
    _check_bwd_args(q, k, v, do, m, linv, delta)
    B, S, H, D = q.shape
    if D > _MAX_HEAD_DIM:
        raise ValueError(f"K8 supports head_dim <= {_MAX_HEAD_DIM}, got {D}")
    if S == 0 or B == 0:
        raise ValueError("K8 needs a non-empty batch and sequence")
    if not all(t.is_contiguous() for t in (q, k, v, do, m, linv, delta)):
        raise ValueError("K8 reads its inputs by their strides: pass "
                         "contiguous tensors")


def _launch_args(q, k, v, do, m, linv, delta):
    """The C arguments the two kernels share."""
    B, S, H, D = q.shape
    ptrs = [t.data_ptr() for t in (q, k, v, do, m, linv, delta)]
    dims = [B, S, H, k.shape[2], D, int(q.dtype == torch.bfloat16), D**-0.5,
            torch.cuda.current_stream(q.device).cuda_stream]
    return ptrs, dims


def _dims(q, k):
    B, S, H, D = q.shape
    return B, S, H, k.shape[2], D, q.element_size()


@_cost.kernel("K8a", lambda q, k, *_: _work.k8a_flash_dq(*_dims(q, k)))
@_gate.kernel
def flash_dq_kernel(q, k, v, do, m, linv, delta):
    """K8a on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors, dq's shape for ``meta`` tensors.
    Returns dq (B, S, H, D)."""
    if _build.plain(q, "K8a"):
        return flash_dq_plain(q, k, v, do, m, linv, delta)
    _check_launch(q, k, v, do, m, linv, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.device.type == "meta":
        return dq
    ptrs, dims = _launch_args(q, k, v, do, m, linv, delta)
    err = _build.library().repro_k8a_flash_dq(*ptrs, dq.data_ptr(), *dims)
    _build.check(err, "K8a flash_dq")
    flash_dq_kernel.launches += 1
    return dq


@_cost.kernel("K8b", lambda q, k, *_: _work.k8b_flash_dkdv(*_dims(q, k)))
@_gate.kernel
def flash_dkdv_kernel(q, k, v, do, m, linv, delta):
    """K8b on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors, the shapes of dk and dv for ``meta``
    tensors.  Returns (dk, dv) (B, S, KVH, D)."""
    if _build.plain(q, "K8b"):
        return flash_dkdv_plain(q, k, v, do, m, linv, delta)
    _check_launch(q, k, v, do, m, linv, delta)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if q.device.type == "meta":
        return dk, dv
    ptrs, dims = _launch_args(q, k, v, do, m, linv, delta)
    err = _build.library().repro_k8b_flash_dkdv(*ptrs, dk.data_ptr(),
                                                 dv.data_ptr(), *dims)
    _build.check(err, "K8b flash_dkdv")
    flash_dkdv_kernel.launches += 1
    return dk, dv


flash_dq_kernel.launches = 0
flash_dkdv_kernel.launches = 0


def flash_attention_backward(q, k, v, o, m, l, do):
    """(dq, dk, dv) from K7's (o, m, l) and the output gradient ``do``:
    delta = sum_d do * o in float32, laid out (B, H, S) like m and l,
    linv = 1 / max(l, 1e-30), then K8a and K8b."""
    delta = (do.to(torch.float32) * o.to(torch.float32)).sum(-1)
    delta = delta.transpose(1, 2).contiguous()
    linv = 1.0 / torch.clamp(l, min=1e-30)
    dq = flash_dq_kernel(q, k, v, do, m, linv, delta)
    dk, dv = flash_dkdv_kernel(q, k, v, do, m, linv, delta)
    return dq, dk, dv
