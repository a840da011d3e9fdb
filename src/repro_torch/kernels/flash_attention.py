"""K7: causal GQA flash-attention forward.

The port of the JAX package's ``kernels/flash_attention.py::
flash_attention_pallas``: the CUDA kernel in ``csrc/flash_attention.cu``
returns (o, m, l) — the output and the running softmax max and
denominator each query row ended with — without ever writing the S x S
scores to device memory.  :func:`flash_attention_plain` is the same
function in plain PyTorch (materialized scores): the CPU path and the
kernel's oracle.

Layouts differ from the TPU kernel's and say so: q (B, S, H, D), k/v
(B, S, KVH, D) are read as they lie, with no transpose to (B*H, S, D) and
no padding of S or D; o comes back as (B, S, H, D) in q's dtype and m, l
as (B, H, S) float32, which is the TPU kernel's (B*H, S) reshaped.  The
scale is D**-0.5 with the true D, so m equals the JAX package's m (whose
wrapper pads D to 128 and rescales q to the same effect).

The CUDA kernel has two instantiations: bfloat16 on the tensor cores
(mma.sync with cp.async staging) and float32 on the CUDA cores (tensor
cores would round float32 to TF32).  Both take any head_dim up to 256.

:class:`FlashAttention` makes K7 differentiable: its forward runs K7 and
saves (q, k, v, o, m, l), its backward runs K8a and K8b
(``flash_attention_bwd``).  ``flash_attention_kernel`` itself records no
gradient, so it refuses inputs that require one.

Every wrapper of the port's kernels takes three devices: a CUDA tensor
goes only to the kernel, a CPU tensor only to the plain version, and a
``meta`` tensor (the shape dry run, ``launch/dryrun.py``) gets outputs of
the kernel's shapes and dtypes on ``meta`` and nothing else; any other
device raises.  On each, the call charges the kernel's work
(``kernels/work.py``) to the cost counter when one is installed
(``obs/cost.py``); only a launch counts in ``.launches``.
"""
from __future__ import annotations

import torch

from . import _build, work as _work
from ..obs import cost as _cost
from ..obs import gate as _gate
from .ref import causal_scores

__all__ = ["FlashAttention", "flash_attention_kernel",
           "flash_attention_plain"]

_MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)


def _check_args(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, S, H, D) and k, v (B, S, KVH, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, D) \
            or H % k.shape[2] != 0:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
                         " (same B, S, D; H a multiple of KVH)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {_DTYPES}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def flash_attention_plain(q, k, v):
    """Plain PyTorch K7: (o (B, S, H, D) in q's dtype, m, l (B, H, S)
    float32), from the materialized float32 scores."""
    _check_args(q, k, v)
    B, S, H, D = q.shape
    s = causal_scores(q, k)  # (B, KVH, G, S, S)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, v.to(torch.float32))
    o = o / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return (o.reshape(B, S, H, D).to(q.dtype), m.reshape(B, H, S),
            l.reshape(B, H, S))


def _work_of(q, k, v):
    B, S, H, D = q.shape
    return _work.k7_flash(B, S, H, k.shape[2], D, q.element_size())


@_cost.kernel("K7", _work_of)
@_gate.kernel
def flash_attention_kernel(q, k, v):
    """K7 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors, its outputs' shapes for ``meta``
    tensors.  q (B, S, H, D), k/v (B, S, KVH, D),
    contiguous, float32 or bfloat16, D <= 256.  Returns (o, m, l).

    The outputs carry no gradient: with grad mode on, inputs that require
    one raise (differentiate through :class:`FlashAttention`)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention_kernel records no gradient; call "
            "ops.flash_attention (FlashAttention.apply) to differentiate "
            "through K7")
    if _build.plain(q, "K7"):
        return flash_attention_plain(q, k, v)
    _check_args(q, k, v)
    B, S, H, D = q.shape
    if D > _MAX_HEAD_DIM:
        raise ValueError(f"K7 supports head_dim <= {_MAX_HEAD_DIM}, got {D}")
    if S == 0 or B == 0:
        raise ValueError("K7 needs a non-empty batch and sequence")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("K7 reads q, k, v by their (B, S, heads, D) "
                         "strides: pass contiguous tensors")
    o = torch.empty_like(q)
    m = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if q.device.type == "meta":
        return o, m, l
    err = _build.library().repro_k7_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        m.data_ptr(), l.data_ptr(), B, S, H, k.shape[2], D,
        int(q.dtype == torch.bfloat16), D**-0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "K7 flash_attention")
    flash_attention_kernel.launches += 1
    return o, m, l


flash_attention_kernel.launches = 0


class FlashAttention(torch.autograd.Function):
    """Causal GQA attention o = softmax(q k^T scale) v with K7 forward and
    K8a/K8b backward.  Under ``torch.inference_mode()`` or ``no_grad``
    only K7 runs and nothing is saved."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, m, l = flash_attention_kernel(q, k, v)
        ctx.save_for_backward(q, k, v, o, m, l)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        # imported here: flash_attention_bwd imports this module's checks
        from .flash_attention_bwd import flash_attention_backward

        q, k, v, o, m, l = ctx.saved_tensors
        return flash_attention_backward(q, k, v, o, m, l, do.contiguous())
