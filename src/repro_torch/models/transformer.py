"""Decoder-only LM: the serving and training paths of the JAX package's
``models/transformer.py``.

One parameterized stack.  Layers are grouped into homogeneous segments
(``config.segments``); each segment's parameters are stacked along a
leading layer axis as in JAX, so a JAX parameter tree converts leaf for
leaf (``convert.lm_params_from_jax``), and a Python loop runs a segment's
layers in turn.  Every mixer of the JAX package runs: ``full``, ``swa``
and ``local`` (GQA/MQA), ``mla`` (DeepSeek's multi-head latent
attention, with its compressed cache and the absorbed decode), and the
recurrent ``rwkv6`` and ``rglru`` (``ssm.py``); with dense SwiGLU or GELU
FFNs, the token-choice MoE FFN (``moe.py``) or RWKV6's channel mix, over
the ``tokens`` or the ``embeddings`` frontend (audio frames, image
patches: precomputed (B, S, d_model) embeddings).

Caches are written in place (``kvcache``): a prefill fills each layer's
views of its segment's cache, a decode step writes its token there.  The
recurrent mixers' prefill starts from a zero state, whatever the cache
holds, and leaves the state after its last token: RWKV6's ``state``, its
normed input ``prev_mix`` and its channel mix's ``prev_cm``; RG-LRU's
carry ``h`` and the conv's last inputs ``conv``.  A decode step reads
them and writes the next.

Entry points:
  * ``prefill``      — full-sequence pass filling a decode cache; its
    full-causal attention runs K7 (``attention.attend``);
  * ``decode_step``  — one token against the cache;
  * ``forward``      — logits for every position and the aux loss
    (training); with ``cfg.remat`` each block runs under
    ``torch.utils.checkpoint``, so the backward re-runs its forward (K7
    included) before K8a/K8b;
  * ``loss_fn``      — masked next-token cross-entropy plus the aux loss.

Each takes ``tokens`` (its first argument after the config, or the
cache) or, for the ``embeddings`` frontend, ``embeds=``.

``forward``, ``loss_fn``, ``prefill``, ``decode_step`` and ``init_cache``
take the JAX package's mesh rules as the keyword ``rules=`` (a documented
deviation: JAX's ``rules`` is positional, after the config, and the
port's positional signatures already differ from JAX's).

One program serves both.  What the JAX package leaves to XLA's
partitioner (``rules.constrain`` and the specs of ``param_pspec``), each
rank runs here explicitly on its blocks of the parameters
(``distributed.sharding.shard_params``) through the steps of
``distributed/_tp.py``; without a mesh (``rules=None``) every spec is
replicated and every step is the plain product, and on a mesh of one rank
every collective is skipped, so both give the unsharded result bit for
bit.  Under a larger mesh every rank calls the entry point with the whole
batch:

* it keeps its rows of the dp axes (JAX's ``constrain(x, batch_spec(),
  ...)``); ``embed`` (V, d) is vocab-parallel when V divides tp;
  ``lm_head`` (d, V) is column-parallel, so logits come back (B/dp, ...,
  V/tp) per rank, as JAX constrains them (:func:`gather_logits` puts them
  together);
* GQA runs local heads when H and KVH divide tp; where wq is
  column-parallel and wk/wv fall back to row-parallel (K/V whole on every
  rank), a rank takes the KV heads of its own query heads
  (``global_q_head // G``); K7 runs on the local heads through
  ``attention.attend``;
* decode caches keep JAX's layout: slots over the model axis, (B/dp,
  T/tp, KVH, Dh) per rank (MLA's latent ``ckv``/``krope`` likewise).  A
  decode step writes its token on the rank that owns slot ``length %
  T``; each rank attends every head over its slots and the partial
  softmaxes merge over the model axis.  Where T does not divide tp the
  cache is whole on every rank (:func:`gather_caches` puts a rank's parts
  together);
* windowed prefill under ``seq_parallel_prefill`` shards the block's
  activations over S (``attention.swa_attend_cp``), and the windowed
  cache is written from the gathered K/V;
* the MoE FFN is expert-parallel (``moe.moe_ffn``); RWKV6's projections
  are row-parallel (its recurrence runs on whole activations); RG-LRU's
  ``lru_in``/``lru_gate`` are column-parallel over channels, so a rank
  runs the conv and the scan on its channels (its slice of the
  replicated ``lru_conv`` and per-channel vectors) and ``lru_out`` is
  row-parallel; its recurrent cache is split the same way;
* ``fsdp_only`` blocks and ``rwkv_batch_parallel`` RWKV6 blocks shard the
  batch over every axis with their weights gathered whole
  (``_tp.block_layout``).

The aux loss ``forward`` returns on a rank is its data shard's (JAX's
per-device value).

Gradients flow through the collectives (``compat``'s autograd and
``_tp``'s convention): autograd of ``loss_fn(..., rules=)`` on a rank
gives the gradient of the global loss with respect to that rank's
blocks, the same block of JAX's ``jax.grad`` under ``MeshRules(mesh)``.
The vocab-parallel log-softmax takes its max and log-sum-exp over the
model axis and each label's logit from the rank that owns its column;
the masked mean sums its numerator and count over the dp axes.  The MoE
aux term follows JAX's ``shard_map`` (``moe_ffn``'s aux ``out_specs``
``P()``): its gradient is the mean over the dp shards of each shard's
aux gradient, and its value, as JAX reports it, dp shard 0's.  Under
remat a block's backward re-issues its collectives; every rank remats
the same blocks in the same order (early stop is off under a mesh).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
import torch.utils.checkpoint

from .._device import resolve_device
from ..distributed import compat
from ..distributed._tp import TP, block_layout, cut, gather
from .attention import (NEG_INF, attend, decode_attend, merged_softmax,
                        swa_attend_cp)
from .config import ModelConfig, segments
from .kvcache import (LocalCaches, fill_cache, init_segment_cache,
                      ring_positions, write_token)
from .layers import apply_rope, gelu_mlp, rms_norm, rotary, swiglu
from .moe import LEAVES as MOE_LEAVES, moe_ffn
from .ssm import rglru_block, rwkv6_channelmix, rwkv6_mix

__all__ = ["init_params", "abstract_params", "param_shapes", "count_params",
           "forward", "loss_fn", "prefill", "decode_step", "init_cache",
           "gather_caches", "gather_logits"]

# ============================================================ initialization
def _dense_ffn_shapes(cfg: ModelConfig, ffn_kind: str):
    d = cfg.d_model
    if ffn_kind == "dense_big":
        ff = cfg.moe_dense_d_ff or cfg.d_ff
    else:
        ff = cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {"w1": (d, ff), "w3": (d, ff), "w2": (ff, d)}
    return {"w1": (d, ff), "w2": (ff, d)}


def _block_param_shapes(cfg: ModelConfig, kind) -> dict:
    """Every parameter of one block of ``kind`` = (mixer, ffn): the JAX
    package's table for every kind, so ``count_params`` agrees for every
    architecture, ported family or not."""
    mixer, ffn = kind
    d = cfg.d_model
    Dh = cfg.resolved_head_dim
    H, KVH = cfg.num_heads, cfg.num_kv_heads
    shapes: dict[str, tuple] = {"ln1": (d,), "ln2": (d,)}
    if mixer in ("full", "swa", "local"):
        shapes.update(
            wq=(d, H * Dh), wk=(d, KVH * Dh), wv=(d, KVH * Dh),
            wo=(H * Dh, d),
        )
        if cfg.qkv_bias:
            shapes.update(bq=(H * Dh,), bk=(KVH * Dh,), bv=(KVH * Dh,))
    elif mixer == "mla":
        qk = cfg.mla_nope_dim + cfg.mla_rope_dim
        shapes.update(
            wq_mla=(d, H * qk),
            wkv_a=(d, cfg.mla_kv_lora + cfg.mla_rope_dim),
            ln_kv=(cfg.mla_kv_lora,),
            wk_up=(cfg.mla_kv_lora, H * cfg.mla_nope_dim),
            wv_up=(cfg.mla_kv_lora, H * cfg.mla_v_dim),
            wo=(H * cfg.mla_v_dim, d),
        )
    elif mixer == "rwkv6":
        HD = H * cfg.rwkv_head_dim
        lora = 64
        shapes.update(
            rwkv_mu_r=(d,), rwkv_mu_k=(d,), rwkv_mu_v=(d,), rwkv_mu_g=(d,),
            rwkv_mu_w=(d,),
            rwkv_w_r=(d, HD), rwkv_w_k=(d, HD), rwkv_w_v=(d, HD),
            rwkv_w_g=(d, HD), rwkv_w_o=(HD, d),
            rwkv_w_decay_a=(d, lora), rwkv_w_decay_b=(lora, HD),
            rwkv_w0=(HD,), rwkv_u=(H, cfg.rwkv_head_dim),
        )
    elif mixer == "rglru":
        W = cfg.lru_width
        shapes.update(
            lru_in=(d, W), lru_gate=(d, W),
            lru_conv=(cfg.conv_width, W), lru_conv_bias=(W,),
            lru_wr=(W,), lru_wi=(W,), lru_br=(W,), lru_bi=(W,),
            lru_lambda=(W,), lru_out=(W, d),
        )
    else:
        raise ValueError(mixer)

    if ffn in ("dense", "dense_big"):
        shapes.update(_dense_ffn_shapes(cfg, ffn))
    elif ffn == "moe":
        E, h = cfg.moe_num_experts, cfg.moe_d_ff
        shapes.update(
            router=(cfg.d_model, E),
            experts_w1=(E, d, h), experts_w3=(E, d, h),
            experts_w2=(E, h, d),
        )
        if cfg.moe_num_shared:
            hs = cfg.moe_num_shared * h
            shapes.update(shared_w1=(d, hs), shared_w3=(d, hs),
                          shared_w2=(hs, d))
    elif ffn == "channelmix":
        ff = cfg.d_ff
        shapes.update(
            rwkv_mu_ck=(d,), rwkv_mu_cr=(d,),
            rwkv_w_ck=(d, ff), rwkv_w_cr=(d, d), rwkv_w_cv=(ff, d),
        )
    else:
        raise ValueError(ffn)
    return shapes


def _init_leaf(gen, name, shape, cfg, device):
    """One layer's leaf: zeros for norms, gains and vectors (a linspace for
    ``lru_lambda``), else a truncated normal in (-3, 3) times
    min(0.02, fan_in**-0.5), drawn in float32 and cast."""
    dt = cfg.dtype
    if len(shape) <= 1 or name.startswith(("ln", "rwkv_mu", "lru_w",
                                           "lru_b", "lru_lambda")):
        if name == "lru_lambda":
            return torch.linspace(1.0, 4.0, shape[0], dtype=dt,
                                  device=device)
        return torch.zeros(shape, dtype=dt, device=device)
    fan_in = shape[-2]
    std = 0.02 if fan_in <= 0 else min(0.02, fan_in**-0.5)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (std * w).to(dt)


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (``None``: the CUDA card).  The tree is the JAX package's: ``embed``,
    ``final_norm``, ``lm_head`` and per segment a dict of leaves stacked
    over its layers.  The draws are not JAX's (another generator); tests
    that compare the two packages convert JAX's parameters instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.dtype
    params: dict[str, Any] = {}
    params["embed"] = (0.02 * torch.randn(
        (cfg.vocab_size, cfg.d_model), generator=gen, dtype=torch.float32,
        device=dev)).to(dt)
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=dt, device=dev)
    params["lm_head"] = (0.02 * torch.randn(
        (cfg.d_model, cfg.vocab_size), generator=gen, dtype=torch.float32,
        device=dev)).to(dt)
    seg_params = []
    for kind, n in segments(cfg):
        layer = {}
        for name, shape in sorted(_block_param_shapes(cfg, kind).items()):
            leaf = torch.empty((n, *shape), dtype=dt, device=dev)
            for i in range(n):  # one layer's float32 draw at a time
                leaf[i] = _init_leaf(gen, name, shape, cfg, dev)
            layer[name] = leaf
        seg_params.append(layer)
    params["segments"] = seg_params
    return params


def abstract_params(cfg: ModelConfig):
    """The parameter tree of ``init_params`` on the ``meta`` device: every
    leaf's shape and dtype, no storage (any configuration, Qwen3-MoE-235B
    included)."""
    meta = torch.device("meta")
    params: dict[str, Any] = {
        "embed": torch.empty((cfg.vocab_size, cfg.d_model), dtype=cfg.dtype,
                             device=meta),
        "final_norm": torch.empty((cfg.d_model,), dtype=cfg.dtype,
                                  device=meta),
        "lm_head": torch.empty((cfg.d_model, cfg.vocab_size),
                               dtype=cfg.dtype, device=meta)}
    params["segments"] = [
        {name: torch.empty((n, *shape), dtype=cfg.dtype, device=meta)
         for name, shape in sorted(_block_param_shapes(cfg, kind).items())}
        for kind, n in segments(cfg)]
    return params


def param_shapes(cfg: ModelConfig) -> list:
    """(path, shape) of every leaf of ``init_params``' tree in
    ``core.flatbuf.tree_flatten``'s order (dict keys sorted), without
    making a tensor: what a layout computed inside a counted run (the
    dry run's) reads."""
    d, V = cfg.d_model, cfg.vocab_size
    out = [("embed", (V, d)), ("final_norm", (d,)), ("lm_head", (d, V))]
    for i, (kind, n) in enumerate(segments(cfg)):
        out += [(f"segments/{i}/{name}", (n, *shape)) for name, shape in
                sorted(_block_param_shapes(cfg, kind).items())]
    return out


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    total = cfg.vocab_size * cfg.d_model * 2 + cfg.d_model
    for kind, n in segments(cfg):
        shapes = _block_param_shapes(cfg, kind)
        for name, shape in shapes.items():
            size = 1
            for s in shape:
                size *= s
            if active_only and name.startswith("experts_"):
                size = size * cfg.moe_top_k // cfg.moe_num_experts
            total += n * size
    return total


# ================================================================== blocks
ATTENTION = ("full", "swa", "local", "mla")


def _slots(cfg: ModelConfig, mixer: str, cache_len: int) -> int:
    """T, the slots of a whole attention cache of ``cache_len``."""
    return min(cfg.window, cache_len) if mixer in ("swa", "local") \
        else cache_len


def _num_slots(leaf, cfg: ModelConfig, mixer: str, cache_len) -> int:
    """T of a layer's whole cache: from ``cache_len`` where the caches
    carry it (``LocalCaches``: a rank may hold T / tp of the slots), else
    the cache ``leaf``'s own."""
    return leaf.shape[1] if cache_len is None \
        else _slots(cfg, mixer, cache_len)


def _slot_positions(length: int, T: int, t_loc: int, ctx: TP, dev):
    """(absolute positions of this rank's cache slots, the axis the
    partial softmaxes over them merge across: None when the rank holds
    all T slots)."""
    cpos = ring_positions(length, T, device=dev)
    if t_loc == T:
        return cpos, None
    return cpos[ctx.tp_rank * t_loc:(ctx.tp_rank + 1) * t_loc], ctx.tp


def _kv_for_heads(k, v, q0: int, hq: int, G: int):
    """K/V (all KVH heads) for query heads q0 .. q0 + hq - 1 (global),
    each global head h reading KV head h // G, shaped so ``attend``'s
    grouping (local head i -> KV head i // (hq / kv)) maps them.  The
    local heads never cover whole groups here (then KVH would divide tp
    and K/V would be column-parallel): they read one KV head, or
    (a tp that is no power of two, e.g. 40/8 heads at tp 5) straddle two
    and each gets its own copy."""
    first, last = q0 // G, (q0 + hq - 1) // G
    if first == last:  # every local head reads one KV head
        return k[:, :, first:first + 1], v[:, :, first:first + 1]
    idx = torch.div(q0 + torch.arange(hq, device=k.device), G,
                    rounding_mode="floor")
    return k[:, :, idx], v[:, :, idx]


def _gqa_mixer(p, h, cfg, ctx, specs, layout, window, mode, cache, length,
               cache_len):
    """GQA/MQA attention of one layer on this rank's part.  In ``prefill``
    mode the layer's cache is filled in place (zero-padded to its length,
    or the last T tokens rolled into ring order for a window); in
    ``decode`` mode the token is written at its ring slot in place.

    Under a mesh: local heads where wq (and wk/wv) are column-parallel;
    where wq is column-parallel and wk/wv fall back to row-parallel (K/V
    whole on every rank), a rank takes the KV heads of its own query
    heads.  A decode step attends every head over this rank's slots and
    the partial softmaxes merge over the model axis.  The ``seq`` layout
    (windowed prefill under ``seq_parallel_prefill``) runs
    ``swa_attend_cp`` on this rank's chunk of the sequence."""
    B, S, _ = h.shape
    Dh = cfg.resolved_head_dim
    H, KVH = cfg.num_heads, cfg.num_kv_heads
    whole = layout != "dp"
    q = ctx.linear(h, p["wq"], specs["wq"], whole=whole)
    k = ctx.linear(h, p["wk"], specs["wk"], whole=whole)
    v = ctx.linear(h, p["wv"], specs["wv"], whole=whole)
    tp_split = ctx.ntp > 1 and not whole
    q_sh = tp_split and specs["wq"][1] == ctx.tp  # this rank's heads
    kv_sh = tp_split and specs["wk"][1] == ctx.tp
    hq = H // ctx.ntp if q_sh else H
    hk = KVH // ctx.ntp if kv_sh else KVH
    q0 = ctx.tp_rank * hq if q_sh else 0
    if "bq" in p:  # replicated biases: this rank's columns of them
        q = q + (cut(p["bq"], 0, ctx.tp) if q_sh else p["bq"])
        k = k + (cut(p["bk"], 0, ctx.tp) if kv_sh else p["bk"])
        v = v + (cut(p["bv"], 0, ctx.tp) if kv_sh else p["bv"])
    q = q.reshape(B, S, hq, Dh)
    k = k.reshape(B, S, hk, Dh)
    v = v.reshape(B, S, hk, Dh)
    if mode == "decode":
        offset = length
    else:
        offset = ctx.tp_rank * S if layout == "seq" else 0
    pos = offset + torch.arange(S, dtype=torch.int32, device=h.device)
    cos, sin = rotary(pos, Dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    mixer = "swa" if window else "full"

    if mode == "decode":  # every head, this rank's slots
        if q_sh:
            q = gather(q, 2, ctx.tp)
        if kv_sh:
            k, v = gather(k, 2, ctx.tp), gather(v, 2, ctx.tp)
        T = _num_slots(cache["k"], cfg, mixer, cache_len)
        write_token(cache["k"], k, length, T, ctx.tp_rank)
        write_token(cache["v"], v, length, T, ctx.tp_rank)
        cpos, axis = _slot_positions(length + 1, T, cache["k"].shape[1], ctx,
                                     h.device)
        out = decode_attend(q, cache["k"], cache["v"], cpos, length,
                            window=window, axis_name=axis)
        return ctx.linear(out.reshape(B, S, H * Dh), p["wo"], specs["wo"],
                          gather_out=True)
    if layout == "seq":
        out = swa_attend_cp(q, k, v, window=window, rules=ctx.rules)
    elif q_sh and not kv_sh:  # wq column-, wk/wv row-parallel
        # K/V are whole on every rank and each takes its heads' part
        ka, va = _kv_for_heads(ctx.vary(k), ctx.vary(v), q0, hq, H // KVH)
        out = attend(q, ka, va, window=window)
    else:
        out = attend(q, k, v, window=window)
    if mode == "prefill":
        T = _num_slots(cache["k"], cfg, mixer, cache_len)
        for name, t in (("k", k), ("v", v)):
            t = ctx.relayout(t, layout, "dp")
            if kv_sh:
                t = gather(t, 2, ctx.tp)
            fill_cache(cache[name], t, window, T, ctx.tp_rank)
    return ctx.linear(out.reshape(B, S, hq * Dh), p["wo"], specs["wo"],
                      split_in=q_sh, gather_out=True, whole=whole)


def _mla_mixer(p, h, cfg, ctx, specs, layout, mode, cache, length,
               cache_len):
    """Multi-head latent attention (DeepSeek-V2).  K and V come from a
    compressed latent c (``mla_kv_lora`` wide, RMS-normed) and one rope
    key shared by every head; the cache holds only those two.  Prefill
    and training expand them to per-head K (nope + rope wide) and V
    (``mla_v_dim``) and attend (K7, V zero-padded to K's width); decode
    expands the whole cache each step or, with ``cfg.mla_absorb``, folds
    ``wk_up`` into q and ``wv_up`` into the output and attends in the
    latent space (plain PyTorch, float32, as the JAX package).  Under a
    mesh the latent caches are split by slot as the GQA caches are, and
    prefill expands this rank's heads where ``wk_up``/``wv_up`` are
    column-parallel."""
    B, S, _ = h.shape
    H = cfg.num_heads
    nope, rope_d = cfg.mla_nope_dim, cfg.mla_rope_dim
    vdim, lora = cfg.mla_v_dim, cfg.mla_kv_lora
    whole = layout != "dp"
    q = ctx.linear(h, p["wq_mla"], specs["wq_mla"], whole=whole).reshape(
        B, S, H, nope + rope_d)
    offset = length if mode == "decode" else 0
    pos = offset + torch.arange(S, dtype=torch.int32, device=h.device)
    cos, sin = rotary(pos, rope_d, cfg.rope_theta)
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], cos, sin)
    q = torch.cat([q_nope, q_rope], dim=-1)
    ckv = ctx.linear(h, p["wkv_a"], specs["wkv_a"], whole=whole)
    c = rms_norm(ckv[..., :lora], p["ln_kv"])
    k_rope = apply_rope(ckv[..., None, lora:], cos, sin)  # (B, S, 1, rope)
    up_sh = ctx.ntp > 1 and not whole and specs["wk_up"][1] == ctx.tp
    wk_up = ctx.weight(p["wk_up"], specs["wk_up"], whole)
    wv_up = ctx.weight(p["wv_up"], specs["wv_up"], whole)

    def expand(c_all, kr_all, heads):
        T = c_all.shape[1]
        k_nope = (c_all @ wk_up).reshape(B, T, heads, nope)
        v = (c_all @ wv_up).reshape(B, T, heads, vdim)
        k = torch.cat([k_nope, kr_all.expand(B, T, heads, rope_d)], dim=-1)
        return k, v

    if mode == "decode":  # every head, this rank's slots
        if up_sh:
            wk_up = gather(wk_up, 1, ctx.tp)
            wv_up = gather(wv_up, 1, ctx.tp)
        T = _num_slots(cache["ckv"], cfg, "mla", cache_len)
        cc = write_token(cache["ckv"], c, length, T, ctx.tp_rank)
        krc = write_token(cache["krope"], k_rope[:, :, 0], length, T,
                          ctx.tp_rank)
        cpos, axis = _slot_positions(length + 1, T, cc.shape[1], ctx,
                                     h.device)
        if cfg.mla_absorb:
            f32 = torch.float32
            scale = (nope + rope_d) ** -0.5
            q_c = torch.einsum("bshn,lhn->bshl", q_nope.to(f32),
                               wk_up.reshape(lora, H, nope).to(f32))
            s = torch.einsum("bshl,btl->bhst", q_c, cc.to(f32))[:, :, 0]
            s = s + torch.einsum("bshr,btr->bhst", q_rope.to(f32),
                                 krc.to(f32))[:, :, 0]
            s = s * scale  # (B, H, T)
            allow = (cpos <= length) & (cpos >= 0)
            s = torch.where(allow, s, NEG_INF)
            if axis is None:
                o_c = torch.einsum("bht,btl->bhl", torch.softmax(s, dim=-1),
                                   cc.to(f32))
            else:
                pr, l = merged_softmax(s, axis)
                tot = compat.psum(torch.cat([torch.einsum(
                    "bht,btl->bhl", pr, cc.to(f32)), l], dim=-1), axis,
                    donate=True)
                o_c = tot[..., :-1] / tot[..., -1:]
            out = torch.einsum("bhl,lhn->bhn", o_c,
                               wv_up.reshape(lora, H, vdim).to(f32)
                               ).to(h.dtype)[:, None]  # (B, 1, H, vdim)
        else:
            k_all, v_all = expand(cc, krc[:, :, None, :], H)
            out = decode_attend(q, k_all, v_all, cpos, length,
                                axis_name=axis)
        return ctx.linear(out.reshape(B, S, H * vdim), p["wo"], specs["wo"],
                          gather_out=True)
    hl = H // ctx.ntp if up_sh else H
    if up_sh:  # this rank's heads of the whole q, c and rope key
        q = cut(q, 2, ctx.tp)
        k_all, v_all = expand(ctx.vary(c), ctx.vary(k_rope), hl)
    else:
        k_all, v_all = expand(c, k_rope, hl)
    out = attend(q, k_all, v_all)
    if mode == "prefill":  # the rest of the fresh cache stays zero
        T = _num_slots(cache["ckv"], cfg, "mla", cache_len)
        fill_cache(cache["ckv"], ctx.relayout(c, layout, "dp"), 0, T,
                   ctx.tp_rank)
        fill_cache(cache["krope"], ctx.relayout(k_rope[:, :, 0], layout,
                                                "dp"), 0, T, ctx.tp_rank)
    return ctx.linear(out.reshape(B, S, hl * vdim), p["wo"], specs["wo"],
                      split_in=up_sh, gather_out=True, whole=whole)


def _apply_block(kind, p, x, cfg, ctx, specs, layout, mode, cache, length,
                 cache_len):
    """One residual block on this rank's part: x + mixer(norm(x)), then
    + ffn(norm(x)).  Returns (x, the block's aux loss: the MoE balance
    term, else a float32 zero)."""
    mixer, ffn = kind
    whole = layout != "dp"
    decode = mode == "decode"
    # the MoE leaves enter in moe_ffn, which runs in the dp layout
    p = {**p, **ctx.enter({n: t for n, t in p.items()
                           if not n.startswith(MOE_LEAVES)}, specs, whole)}

    def mm(t, name):
        return ctx.linear(t, p[name], specs[name], whole=whole)

    h = rms_norm(x, p["ln1"])
    if mixer == "mla":
        y = _mla_mixer(p, h, cfg, ctx, specs, layout, mode, cache, length,
                       cache_len)
    elif mixer == "rwkv6":
        y, (st, last) = rwkv6_mix(
            p, h, cfg, state=cache["state"] if decode else None,
            prev_x=cache["prev_mix"] if decode else None, mm=mm)
        if cache is not None:  # last: the normed input h[:, -1]
            cache["state"].copy_(st)
            cache["prev_mix"].copy_(last)
    elif mixer == "rglru":
        pr, mm_r = p, mm
        if not whole and ctx.ntp > 1 and specs["lru_in"][1] == ctx.tp:
            # this rank's channels: its slice of the replicated conv and
            # per-channel leaves; lru_out row-parallel on them
            pr = {n: (cut(t, -1, ctx.tp)
                      if n.startswith("lru_") and n not in (
                          "lru_in", "lru_gate", "lru_out") else t)
                  for n, t in p.items()}

            def mm_r(t, name):
                return ctx.linear(t, p[name], specs[name],
                                  split_in=name == "lru_out")
        y, (hs, conv) = rglru_block(
            pr, h, cfg, state=(cache["h"], cache["conv"]) if decode else None,
            mm=mm_r)
        if cache is not None:
            cache["h"].copy_(hs)
            cache["conv"].copy_(conv)
    else:
        window = cfg.window if mixer in ("swa", "local") else 0
        y = _gqa_mixer(p, h, cfg, ctx, specs, layout, window, mode, cache,
                       length, cache_len)
    x = x + y
    h2 = rms_norm(x, p["ln2"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "moe":  # expert-parallel over the dp layout's rows
        f, aux, _drop = moe_ffn(ctx.relayout(h2, layout, "dp"), p, cfg,
                                rules=ctx.rules)
        f = ctx.relayout(f, "dp", layout)
    elif ffn == "channelmix":
        f, prev_cm = rwkv6_channelmix(
            p, h2, prev_x=cache["prev_cm"] if decode else None, mm=mm)
        if cache is not None:
            cache["prev_cm"].copy_(prev_cm)
    else:
        w = {n: ctx.weight(p[n], specs[n], whole)
             for n in ("w1", "w3", "w2") if n in p}
        split = not whole and specs["w2"][0] == ctx.tp  # column, then row
        if split:
            h2 = ctx.vary(h2)
        if cfg.mlp_type == "swiglu":
            f = swiglu(h2, w["w1"], w["w3"], w["w2"])
        else:
            f = gelu_mlp(h2, w["w1"], w["w2"])
        if split:  # a partial sum
            f = ctx.psum_tp(f)
    return x + f, aux


def _remat_block(rules, *args):
    """``_apply_block`` under ``rules``' mesh: the backward recomputes it
    outside the caller's ``use_mesh``."""
    with _on_mesh(rules):
        return _apply_block(*args)


def _run_segments(params, x, cfg, ctx, mode, caches, length, batch: int,
                  seq: int):
    """Each segment's layers in turn on this rank's part; caches are
    updated in place.  Returns (x in the dp layout, the blocks' aux losses
    summed in float32, in layer order as the JAX package's scan carries
    them).  A segment's blocks run in the layout ``_tp.block_layout``
    gives them.  In ``train`` mode with ``cfg.remat`` every block runs
    under ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``
    per scanned block): its activations are recomputed in the backward,
    and under a mesh its collectives re-issued, the whole block on every
    rank (no early stop)."""
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    cache_len = getattr(caches, "cache_len", None)
    layout = "dp"
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, ((kind, n), p_seg) in enumerate(zip(segments(cfg),
                                                params["segments"])):
        lay = block_layout(cfg, ctx.rules, batch, seq, kind[0], mode)
        x = ctx.relayout(x, layout, lay)
        layout = lay
        specs = ctx.specs(kind)
        for i in range(n):
            p_l = {name: leaf[i] for name, leaf in p_seg.items()}
            c_l = ({name: leaf[i] for name, leaf in caches[si].items()}
                   if caches is not None else None)
            args = (kind, p_l, x, cfg, ctx, specs, lay, mode, c_l, length,
                    cache_len)
            if remat:
                with torch.utils.checkpoint.set_checkpoint_early_stop(
                        not _sharded(ctx.rules)):
                    x, aux = torch.utils.checkpoint.checkpoint(
                        _remat_block, ctx.rules, *args, use_reentrant=False)
            else:
                x, aux = _apply_block(*args)
            aux_total = aux_total + aux
    return ctx.relayout(x, layout, "dp"), aux_total


# ============================================================== entry points
def _sharded(rules) -> bool:
    """True under a mesh of more than one rank."""
    return rules is not None and rules.mesh is not None and rules.size > 1


@contextlib.contextmanager
def _on_mesh(rules):
    """Run the block under ``rules``' mesh, if it has one (``compat``'s
    named axes resolve against it)."""
    if rules is None or rules.mesh is None:
        yield
        return
    with compat.use_mesh(rules.mesh):
        yield


def _embed_in(params, cfg, ctx, tokens=None, embeds=None):
    """This rank's rows (the dp layout) of the (B, S, d) inputs: the token
    embeddings, or for the ``embeddings`` frontend the caller's
    embeddings cast to the model's dtype.  ``embed`` (V, d) is
    vocab-parallel when V divides tp: a rank looks up its rows, zeroes the
    other tokens, and the lookups are summed over the model axis."""
    if cfg.frontend == "embeddings":
        if embeds is None:
            raise ValueError(f"{cfg.name} takes embeddings: pass embeds=")
        return cut(embeds, 0, ctx.rows(embeds.shape[0])).to(cfg.dtype)
    if tokens is None:
        raise ValueError(f"{cfg.name} takes tokens")
    t = cut(tokens, 0, ctx.rows(tokens.shape[0]))
    spec = ctx.spec("embed", (cfg.vocab_size, cfg.d_model))
    table = ctx.weight(ctx.enter({"embed": params["embed"]},
                                 {"embed": spec})["embed"], spec)
    if spec[0] != ctx.tp or ctx.ntp == 1:
        return table[t]
    rows = table.shape[0]  # vocab-parallel: this rank's rows
    lo = ctx.tp_rank * rows
    mine = (t >= lo) & (t < lo + rows)
    x = table[torch.where(mine, t - lo, 0)] * mine[..., None].to(
        table.dtype)
    return ctx.psum_tp(x)


def _head(params, cfg, ctx, x):
    """Logits of this rank: its rows, and its vocabulary columns when V
    divides tp (``lm_head`` column-parallel)."""
    specs = {"final_norm": (None,),
             "lm_head": ctx.spec("lm_head", (cfg.d_model, cfg.vocab_size))}
    p = ctx.enter({n: params[n] for n in specs}, specs)
    h = rms_norm(x, p["final_norm"])
    if specs["lm_head"][1] == ctx.tp:
        h = ctx.vary(h)
    return h @ ctx.weight(p["lm_head"], specs["lm_head"])


def _batch_of(cfg, tokens, embeds) -> int:
    return (embeds if cfg.frontend == "embeddings" else tokens).shape[0]


def gather_logits(logits, cfg: ModelConfig, rules=None, batch=None):
    """The whole (B, ..., V) logits from every rank's (B/dp, ..., V/tp)
    block (a collective; as they are without a mesh of more than one
    rank).  ``batch`` (the whole batch's rows, default: a batch that
    splits over the dp axes) says whether the rows are split."""
    if not _sharded(rules):
        return logits
    with _on_mesh(rules):
        ctx = TP(rules, cfg)
        if ctx.spec("lm_head", (cfg.d_model, cfg.vocab_size))[1] == ctx.tp:
            logits = gather(logits, -1, ctx.tp)
        return gather(logits, 0, ctx.dp if batch is None
                      else ctx.rows(batch))


def gather_caches(caches, cfg: ModelConfig, rules=None):
    """The whole caches, (L, B, ...) leaves as ``init_cache`` lays them
    out without a mesh, from every rank's part (a collective; as they are
    without a mesh of more than one rank)."""
    if not _sharded(rules):
        return caches
    out = []
    with _on_mesh(rules):
        ctx = TP(rules, cfg)
        rows = ctx.rows(caches.batch)
        for (kind, _), seg in zip(segments(cfg), caches):
            mixer = kind[0]
            whole = {}
            for name, leaf in seg.items():
                if mixer in ATTENTION:
                    if leaf.shape[2] != _slots(cfg, mixer, caches.cache_len):
                        leaf = gather(leaf, 2, ctx.tp)
                    leaf = gather(leaf, 1, rows)
                elif block_layout(cfg, rules, caches.batch, 1, mixer,
                                  "decode") == "full":
                    leaf = gather(leaf, 1, ctx.dp + (ctx.tp,))
                else:
                    if mixer == "rglru" and leaf.shape[-1] != cfg.lru_width:
                        leaf = gather(leaf, -1, ctx.tp)
                    leaf = gather(leaf, 1, rows)
                whole[name] = leaf
            out.append(whole)
    return out


def forward(params, cfg: ModelConfig, tokens=None, *, embeds=None,
            rules=None):
    """Training forward: (logits (B, S, V) for every position of
    ``tokens`` (B, S) or ``embeds`` (B, S, d), the aux loss: the MoE
    balance terms summed over blocks, a float32 zero without MoE).  Under
    a mesh of more than one rank, this rank's (B/dp, S, V/tp) block and
    its data shard's aux loss."""
    with _on_mesh(rules):
        ctx = TP(rules, cfg)
        x = _embed_in(params, cfg, ctx, tokens, embeds)
        x, aux = _run_segments(params, x, cfg, ctx, "train", None, None,
                               _batch_of(cfg, tokens, embeds), x.shape[1])
        return _head(params, cfg, ctx, x), aux


def loss_fn(params, batch, cfg: ModelConfig, aux_coef: float = 0.01, *,
            rules=None):
    """(ce + aux_coef * aux, {"ce", "aux"}): next-token cross-entropy in
    float32 over the positions whose label is >= 0, as the JAX package's
    ``loss_fn``.  ``batch``: {"tokens" (B, S) or "embeds" (B, S, d),
    "labels" (B, S)}, the whole batch on every rank under a mesh, where
    ``params`` are this rank's blocks and the loss is the global one (see
    the module's docstring for the aux term)."""
    rows = batch["labels"].shape[0]
    if _sharded(rules) and rules.dp_size > 1:
        with _on_mesh(rules):
            whole = TP(rules, cfg).rows(rows) == ()
        if whole:
            raise ValueError(f"a training batch of {rows} rows must split "
                             f"over the dp axes ({rules.dp_size} ranks)")
    logits, aux = forward(params, cfg, batch.get("tokens"),
                          embeds=batch.get("embeds"), rules=rules)
    with _on_mesh(rules):
        ctx = TP(rules, cfg)
        labels = cut(batch["labels"], 0, ctx.dp)
        lf = logits.to(torch.float32)
        if ctx.spec("lm_head", (cfg.d_model, cfg.vocab_size))[1] == ctx.tp \
                and ctx.ntp > 1:
            ll = _vocab_parallel_ll(lf, labels, ctx)
        else:
            logp = torch.log_softmax(lf, dim=-1)
            # a masked label (< 0) gathers column 0; the mask drops it
            ll = torch.gather(logp, -1, labels.clamp(min=0)[..., None]
                              .long())[..., 0]
        mask = (labels >= 0).to(torch.float32)
        num, cnt = (ll * mask).sum(), mask.sum()
        if ctx.ndp > 1:  # the global batch's masked mean
            num = compat.psum(num, ctx.dp)
            cnt = compat.psum(cnt, ctx.dp)
        if ctx.ndp > 1 and cfg.moe_num_experts:
            # the gradient of the dp shards' mean aux, the value shard 0's
            mean = compat.psum(aux, ctx.dp) / ctx.ndp
            first = compat.psum(aux.detach() if compat.axis_index(ctx.dp)
                                == 0 else torch.zeros_like(aux), ctx.dp)
            aux = mean + (first - mean).detach()
        ce = -num / torch.clamp(cnt, min=1.0)
        return ce + aux_coef * aux, {"ce": ce, "aux": aux}


def _vocab_parallel_ll(lf, labels, ctx):
    """log p(label) from this rank's (B, S, V/tp) float32 logit columns:
    the max and the log-sum-exp over the model axis, the label's logit
    from the rank that owns its column (a masked label, < 0, is owned by
    none)."""
    v_loc = lf.shape[-1]
    m = compat.pmax(lf.detach().amax(dim=-1, keepdim=True), ctx.tp)
    own = labels.long() - ctx.tp_rank * v_loc
    mine = (own >= 0) & (own < v_loc)
    picked = torch.gather(lf, -1, own.clamp(0, v_loc - 1)[..., None])[..., 0]
    tot = compat.psum(torch.stack([torch.exp(lf - m).sum(dim=-1),
                                   picked * mine]), ctx.tp)
    return tot[1] - torch.log(tot[0]) - m[..., 0]


def _init_cache(cfg, ctx, batch: int, cache_len: int, device):
    out = []
    for kind, n in segments(cfg):
        mixer = kind[0]
        if mixer in ATTENTION:  # this rank's rows and slots
            T = _slots(cfg, mixer, cache_len)
            t_loc = T // ctx.ntp if T % ctx.ntp == 0 else T
            layout = "dp"
        else:  # this rank's rows (and RG-LRU's channels)
            t_loc = cache_len
            layout = block_layout(cfg, ctx.rules, batch, 1, mixer, "decode")
        n_ranks = (ctx.ndp if ctx.rows(batch) else 1) * (
            ctx.ntp if layout == "full" else 1)
        if batch % n_ranks:
            raise ValueError(f"a batch of {batch} does not split over "
                             f"{n_ranks} ranks")
        c = cfg
        if mixer == "rglru" and layout == "dp" \
                and cfg.lru_width % ctx.ntp == 0:
            c = dataclasses.replace(cfg, lru_width=cfg.lru_width // ctx.ntp)
        out.append(init_segment_cache(kind, n, batch // n_ranks, t_loc, c,
                                      cfg.dtype, device=device))
    return LocalCaches(out, cache_len, batch)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None,
               *, rules=None):
    """Zero caches, one dict per segment (see ``kvcache``); under a mesh,
    this rank's part: its rows (all of them where the batch does not
    split over the dp axes), its slots of each attention cache (all T
    where T does not divide tp) and its RG-LRU channels."""
    with _on_mesh(rules):
        return _init_cache(cfg, TP(rules, cfg), batch, cache_len, device)


def prefill(params, cfg: ModelConfig, tokens=None,
            cache_len: int | None = None, *, embeds=None, rules=None):
    """Full-sequence pass over ``tokens`` (B, S) or ``embeds`` (B, S, d)
    -> (last-position logits (B, V), caches, length S).  Under a mesh,
    this rank's logits block and caches."""
    with _on_mesh(rules):
        ctx = TP(rules, cfg)
        x = _embed_in(params, cfg, ctx, tokens, embeds)
        B, S = _batch_of(cfg, tokens, embeds), x.shape[1]
        caches = _init_cache(cfg, ctx, B, cache_len or S, x.device)
        x, _ = _run_segments(params, x, cfg, ctx, "prefill", caches, None,
                             B, S)
        return _head(params, cfg, ctx, x[:, -1]), caches, S


def decode_step(params, caches, length: int, cfg: ModelConfig, tokens=None,
                *, embeds=None, rules=None):
    """One-step decode of ``tokens`` (B,) int or ``embeds`` (B, d).
    Writes the step into ``caches`` in place and returns (logits (B, V),
    caches, length + 1).  Under a mesh, this rank's logits block; the
    caches must be the ones ``prefill`` or ``init_cache`` returned under
    the same rules."""
    if _sharded(rules) and not isinstance(caches, LocalCaches):
        raise TypeError("under a mesh, decode_step takes the caches that "
                        "prefill or init_cache(rules=) returned")
    with _on_mesh(rules):
        ctx = TP(rules, cfg)
        x = _embed_in(params, cfg, ctx, tokens, embeds)[:, None, :]
        x, _ = _run_segments(params, x, cfg, ctx, "decode", caches, length,
                             _batch_of(cfg, tokens, embeds), 1)
        return _head(params, cfg, ctx, x[:, 0]), caches, length + 1
