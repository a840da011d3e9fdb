"""Attention for training, prefill and decode: causal GQA/MQA, full or
windowed.

The JAX package's ``models/attention.py``.  Full-causal attention (every
query position sees every earlier key) runs ``kernels.ops.flash_attention``:
K7 forward and, when a gradient is taken, K8a/K8b backward — on the card
the CUDA kernels, on CPU tensors their plain versions.  ``ModelConfig.
flash_vjp`` is kept and ignored: in JAX it only picks which backward
computes this same full-causal function, and here that backward is always
K8.  Windowed attention over a prompt longer than
the window keeps the JAX package's banded online-softmax scan, a Python
loop over query blocks whose key span is constant (window + one block),
in plain PyTorch, differentiated by torch autograd as JAX differentiates
``_online_block_scan``; a prompt that is not a multiple of the query
block (which JAX refuses) is padded at its tail.  Decode attends one
token over the cache, in plain PyTorch, as the JAX package does.  The
JAX function's ``q_offset`` (chunked prefill) and ``q_block`` options
come with the first ported caller that needs them.

Under a mesh (``transformer``'s ``rules=``) two more forms run on one
rank's part: :func:`swa_attend_cp`, the context-parallel windowed
prefill (the sequence split over the model axis, a window's halo of K/V
from the left neighbours), and :func:`decode_attend` with
``axis_name``, the decode over a cache whose slots are split over that
axis (each rank's partial softmax, merged by the row max and the
rescaled sums).

V may be narrower than Q and K (MLA: Dk 192, Dv 128).  K7 takes one
head_dim for q, k and v, so full-causal attention zero-pads V's last axis
to Dk, runs K7 and keeps the first Dv columns of its output: exact, since
the padded columns of P V are zero.  The softmax scale stays Dk**-0.5,
as in the JAX package.  No configuration has a V wider than Q and K, and
full-causal attention refuses one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..obs import cost as _cost
from .layers import pad_steps

__all__ = ["attend", "decode_attend", "merged_softmax", "swa_attend_cp"]

NEG_INF = -1e30
Q_BLOCK = 1024  # the banded branch's query block, the JAX default


def _pick_block(T: int) -> int:
    for cand in (512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
        if T % cand == 0:
            return min(T, cand)
    return T


def _online_block_scan(q, k_span, v_span, q_pos, kv_pos, window, scale):
    """Online softmax over KV blocks of a span.

    q: (B, Q, KVH, G, Dk); k_span: (B, T, KVH, Dk); v_span: (B, T, KVH,
    Dv); q_pos: (Q,) absolute positions; kv_pos: (T,) absolute positions
    (entries < 0 are padding and always masked).  Causal + window mask.
    Returns (B, Q, KVH, G, Dv) float32.
    """
    B, Q, KVH, G, Dk = q.shape
    T = k_span.shape[1]
    Dv = v_span.shape[-1]
    bk = _pick_block(T)
    qf = q.to(torch.float32) * scale
    m = torch.full((B, KVH, G, Q), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KVH, G, Q, Dv), dtype=torch.float32,
                      device=q.device)
    for j in range(T // bk):
        ks = k_span[:, j * bk:(j + 1) * bk].to(torch.float32)
        vs = v_span[:, j * bk:(j + 1) * bk].to(torch.float32)
        ps = kv_pos[j * bk:(j + 1) * bk]
        s = torch.einsum("bqkgd,btkd->bkgqt", qf, ks)
        allow = ((ps[None, :] <= q_pos[:, None]) & (ps[None, :] >= 0)
                 & (ps[None, :] > (q_pos[:, None] - window)))
        s = torch.where(allow, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqt,btkd->bkgqd", p,
                                                   vs)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4)  # (B, Q, KVH, G, Dv)


def attend(q, k, v, *, window: int = 0):
    """Causal (optionally windowed) attention for prefill and the
    all-position forward.

    q: (B, S, H, Dk); k: (B, S, KVH, Dk); v: (B, S, KVH, Dv); H a
    multiple of KVH (GQA); Dv <= Dk (MLA; the banded scan takes any Dv).
    Returns (B, S, H, Dv) in q's dtype.
    """
    B, Sq, H, Dk = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    if Sq != Skv:
        raise ValueError(f"q has {Sq} positions, k and v {Skv}")

    if not window or window >= Skv:
        if Dv == Dk:
            return ops.flash_attention(q, k, v)  # K7, backward K8a/K8b
        if Dv > Dk:
            raise ValueError(f"K7 takes V no wider than Q and K: Dv {Dv}, "
                             f"Dk {Dk}")
        return ops.flash_attention(q, k, F.pad(v, (0, Dk - Dv)))[..., :Dv]

    # banded: constant KV span per q block = window rounded up + one block
    G = H // KVH
    dev = q.device
    bq = min(Q_BLOCK, Sq)
    if Sq % bq:
        # JAX asserts S % q_block == 0; the port pads the tail with zero
        # tokens, which causality hides from every real query, and drops
        # their rows
        pad = bq - Sq % bq
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        return attend(q, k, v, window=window)[:, :Sq]
    span = min(Skv, ((window + bq + bq - 1) // bq) * bq)
    qr = q.reshape(B, Sq, KVH, G, Dk)
    kv_pos = torch.arange(Skv, dtype=torch.int32, device=dev)
    outs = []
    # every query block costs alike (one span of keys): a dry run on meta
    # may run a few and scale what they count (obs/cost.py)
    nq = Sq // bq
    steps = _cost.loop_steps(nq, q)
    for i in _cost.probed(range(steps), nq, steps, "banded query blocks"):
        q_pos = i * bq + torch.arange(bq, dtype=torch.int32, device=dev)
        start = min(max((i + 1) * bq - span, 0), Skv - span)
        outs.append(_online_block_scan(
            qr[:, i * bq:(i + 1) * bq], k[:, start:start + span],
            v[:, start:start + span], q_pos, kv_pos[start:start + span],
            window, Dk**-0.5))
    return pad_steps(torch.cat(outs, dim=1), Sq).reshape(
        B, Sq, H, Dv).to(q.dtype)


def swa_attend_cp(q, k, v, *, window: int, rules):
    """Context-parallel sliding-window attention: one rank's part.

    q: (B, S_local, H, Dk), k/v: (B, S_local, KVH, D), this rank's chunk
    of a sequence split over ``rules.tp_axis`` in axis order (call under
    ``compat.use_mesh(rules.mesh)``).  Each rank needs only
    ceil(window / S_local) left-neighbour chunks of K/V, moved by
    ``ppermute`` (a chunk from past the sequence's start arrives from the
    other end and its negative positions mask it out), and runs the
    online-softmax scan on its span.  Equal to :func:`attend` with
    ``window`` on the whole sequence.  The JAX package's function takes
    the global arrays under ``shard_map``; here the caller already holds
    its chunk.
    """
    from ..distributed import compat

    tp = rules.tp_axis
    ntp = compat.axis_size(tp)
    idx = compat.axis_index(tp)
    B, S_local, H, Dk = q.shape
    KVH = k.shape[2]
    G = H // KVH
    n_halo = -(-window // S_local)  # ceil: neighbour chunks covering window
    perm = [(i, (i + 1) % ntp) for i in range(ntp)]
    halos_k, halos_v = [], []
    kk, vv = k, v
    for _ in range(n_halo):
        kk = compat.ppermute(kk, tp, perm)
        vv = compat.ppermute(vv, tp, perm)
        halos_k.insert(0, kk)
        halos_v.insert(0, vv)
    k_span = torch.cat(halos_k + [k], dim=1)
    v_span = torch.cat(halos_v + [v], dim=1)
    dev = q.device
    kv_pos = (idx - n_halo) * S_local + torch.arange(
        (n_halo + 1) * S_local, dtype=torch.int32, device=dev)
    q_pos = idx * S_local + torch.arange(S_local, dtype=torch.int32,
                                         device=dev)
    out = _online_block_scan(q.reshape(B, S_local, KVH, G, Dk), k_span,
                             v_span, q_pos, kv_pos, window, Dk**-0.5)
    return out.reshape(B, S_local, H, -1).to(q.dtype)


def merged_softmax(s, axis_name):
    """(p, l): ``exp(s - m)`` and its sum over the last axis, ``m`` the
    maximum of ``s`` over its last axis on every rank of ``axis_name`` —
    the pieces of a softmax whose last axis is split over that axis:
    ``psum(p @ V) / psum(l)`` is ``softmax(s) @ V`` whole."""
    from ..distributed import compat

    m = compat.pmax(s.amax(dim=-1, keepdim=True), axis_name)
    p = torch.exp(s - m)
    return p, p.sum(dim=-1, keepdim=True)


def decode_attend(q, k_cache, v_cache, cache_pos, pos: int, *,
                  window: int = 0, axis_name=None):
    """Single-token decode attention over a (possibly ring) KV cache.

    q: (B, 1, H, Dk); k_cache: (B, T, KVH, Dk); v_cache: (B, T, KVH, Dv);
    cache_pos: (T,) absolute position held in each cache slot (-1 =
    empty); pos: the current absolute position.  Window semantics match
    :func:`attend`.  With ``axis_name`` the T slots are this rank's part
    of a cache split over that mesh axis: the softmax is merged over it
    (:func:`merged_softmax`, one sum of the outputs and weights).
    """
    B, _, H, Dk = q.shape
    KVH = k_cache.shape[2]
    G = H // KVH
    qf = q.reshape(B, KVH, G, Dk).to(torch.float32) * Dk**-0.5
    s = torch.einsum("bkgd,btkd->bkgt", qf, k_cache.to(torch.float32))
    allow = (cache_pos <= pos) & (cache_pos >= 0)
    if window:
        allow &= cache_pos > (pos - window)
    s = torch.where(allow, s, NEG_INF)
    if axis_name is None:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.to(torch.float32))
    else:
        from ..distributed import compat

        p, l = merged_softmax(s, axis_name)
        acc = torch.einsum("bkgt,btkd->bkgd", p, v_cache.to(torch.float32))
        tot = compat.psum(torch.cat([acc, l], dim=-1), axis_name,
                          donate=True)
        out = tot[..., :-1] / tot[..., -1:]
    return out.reshape(B, 1, H, -1).to(q.dtype)
