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

``rules`` (the JAX package's mesh sharding rules) is not an argument:
on one device it does nothing, and the multi-device slice brings
``torch.distributed`` in its place.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.utils.checkpoint

from .._device import resolve_device
from .attention import NEG_INF, attend, decode_attend
from .config import ModelConfig, segments
from .kvcache import init_segment_cache, ring_positions, write_token
from .layers import apply_rope, gelu_mlp, rms_norm, rotary, swiglu
from .moe import moe_ffn
from .ssm import rglru_block, rwkv6_channelmix, rwkv6_mix

__all__ = ["init_params", "count_params", "forward", "loss_fn", "prefill",
           "decode_step", "init_cache"]

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
def _gqa_mixer(p, h, cfg, window, mode, cache, length):
    """GQA/MQA attention of one layer.  In ``prefill`` mode the layer's
    cache is filled in place (zero-padded to its length, or the last T
    tokens rolled into ring order for a window); in ``decode`` mode the
    token is written at its ring slot in place."""
    B, S, _ = h.shape
    Dh = cfg.resolved_head_dim
    H, KVH = cfg.num_heads, cfg.num_kv_heads
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, KVH, Dh)
    v = v.reshape(B, S, KVH, Dh)
    offset = length if mode == "decode" else 0
    pos = offset + torch.arange(S, dtype=torch.int32, device=h.device)
    cos, sin = rotary(pos, Dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if mode == "decode":
        kc = write_token(cache["k"], k, length)
        vc = write_token(cache["v"], v, length)
        cpos = ring_positions(length + 1, kc.shape[1], device=h.device)
        out = decode_attend(q, kc, vc, cpos, length, window=window)
    else:
        out = attend(q, k, v, window=window)
        if mode == "prefill":
            T = cache["k"].shape[1]
            if window and S >= T:
                shift = S % T
                cache["k"].copy_(torch.roll(k[:, S - T:], shift, dims=1))
                cache["v"].copy_(torch.roll(v[:, S - T:], shift, dims=1))
            else:  # the rest of the fresh cache stays zero
                cache["k"][:, :S] = k
                cache["v"][:, :S] = v
    return out.reshape(B, S, H * Dh) @ p["wo"]


def _mla_mixer(p, h, cfg, mode, cache, length):
    """Multi-head latent attention (DeepSeek-V2).  K and V come from a
    compressed latent c (``mla_kv_lora`` wide, RMS-normed) and one rope
    key shared by every head; the cache holds only those two.  Prefill
    and training expand them to per-head K (nope + rope wide) and V
    (``mla_v_dim``) and attend (K7, V zero-padded to K's width); decode
    expands the whole cache each step or, with ``cfg.mla_absorb``, folds
    ``wk_up`` into q and ``wv_up`` into the output and attends in the
    latent space (plain PyTorch, float32, as the JAX package)."""
    B, S, _ = h.shape
    H = cfg.num_heads
    nope, rope_d = cfg.mla_nope_dim, cfg.mla_rope_dim
    vdim, lora = cfg.mla_v_dim, cfg.mla_kv_lora
    q = (h @ p["wq_mla"]).reshape(B, S, H, nope + rope_d)
    offset = length if mode == "decode" else 0
    pos = offset + torch.arange(S, dtype=torch.int32, device=h.device)
    cos, sin = rotary(pos, rope_d, cfg.rope_theta)
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], cos, sin)
    q = torch.cat([q_nope, q_rope], dim=-1)

    ckv = h @ p["wkv_a"]  # (B, S, lora + rope_d)
    c = rms_norm(ckv[..., :lora], p["ln_kv"])
    k_rope = apply_rope(ckv[..., None, lora:], cos, sin)  # (B, S, 1, rope)

    def expand(c_all, kr_all):
        T = c_all.shape[1]
        k_nope = (c_all @ p["wk_up"]).reshape(B, T, H, nope)
        v = (c_all @ p["wv_up"]).reshape(B, T, H, vdim)
        k = torch.cat([k_nope, kr_all.expand(B, T, H, rope_d)], dim=-1)
        return k, v

    if mode == "decode":
        cc = write_token(cache["ckv"], c, length)
        krc = write_token(cache["krope"], k_rope[:, :, 0], length)
        cpos = ring_positions(length + 1, cc.shape[1], device=h.device)
        if cfg.mla_absorb:
            f32 = torch.float32
            scale = (nope + rope_d) ** -0.5
            q_c = torch.einsum("bshn,lhn->bshl", q_nope.to(f32),
                               p["wk_up"].reshape(lora, H, nope).to(f32))
            s = torch.einsum("bshl,btl->bhst", q_c, cc.to(f32))[:, :, 0]
            s = s + torch.einsum("bshr,btr->bhst", q_rope.to(f32),
                                 krc.to(f32))[:, :, 0]
            s = s * scale  # (B, H, T)
            allow = (cpos <= length) & (cpos >= 0)
            pr = torch.softmax(torch.where(allow, s, NEG_INF), dim=-1)
            o_c = torch.einsum("bht,btl->bhl", pr, cc.to(f32))
            out = torch.einsum(
                "bhl,lhn->bhn", o_c,
                p["wv_up"].reshape(lora, H, vdim).to(f32),
            ).to(h.dtype)[:, None]  # (B, 1, H, vdim)
        else:
            k_all, v_all = expand(cc, krc[:, :, None, :])
            out = decode_attend(q, k_all, v_all, cpos, length)
    else:
        k_all, v_all = expand(c, k_rope)
        out = attend(q, k_all, v_all)
        if mode == "prefill":  # the rest of the fresh cache stays zero
            cache["ckv"][:, :S] = c
            cache["krope"][:, :S] = k_rope[:, :, 0]
    return out.reshape(B, S, H * vdim) @ p["wo"]


def _apply_block(kind, p, x, cfg, mode, cache, length):
    """One residual block: x + mixer(norm(x)), then + ffn(norm(x)).
    Returns (x, the block's aux loss: the MoE balance term, else a float32
    zero)."""
    mixer, ffn = kind
    decode = mode == "decode"
    h = rms_norm(x, p["ln1"])
    if mixer == "mla":
        x = x + _mla_mixer(p, h, cfg, mode, cache, length)
    elif mixer == "rwkv6":
        y, (st, last) = rwkv6_mix(
            p, h, cfg, state=cache["state"] if decode else None,
            prev_x=cache["prev_mix"] if decode else None)
        if cache is not None:  # last: the normed input h[:, -1]
            cache["state"].copy_(st)
            cache["prev_mix"].copy_(last)
        x = x + y
    elif mixer == "rglru":
        y, (hs, conv) = rglru_block(
            p, h, cfg, state=(cache["h"], cache["conv"]) if decode else None)
        if cache is not None:
            cache["h"].copy_(hs)
            cache["conv"].copy_(conv)
        x = x + y
    else:
        window = cfg.window if mixer in ("swa", "local") else 0
        x = x + _gqa_mixer(p, h, cfg, window, mode, cache, length)
    h2 = rms_norm(x, p["ln2"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "moe":
        f, aux, _drop = moe_ffn(h2, p, cfg)
    elif ffn == "channelmix":
        f, prev_cm = rwkv6_channelmix(
            p, h2, prev_x=cache["prev_cm"] if decode else None)
        if cache is not None:
            cache["prev_cm"].copy_(prev_cm)
    elif cfg.mlp_type == "swiglu":
        f = swiglu(h2, p["w1"], p["w3"], p["w2"])
    else:
        f = gelu_mlp(h2, p["w1"], p["w2"])
    return x + f, aux


def _run_segments(params, x, cfg, mode, caches, length):
    """Each segment's layers in turn; caches are updated in place.
    Returns (x, the blocks' aux losses summed in float32, in layer order
    as the JAX package's scan carries them).  In ``train`` mode with
    ``cfg.remat`` every block runs under ``torch.utils.checkpoint`` (the
    JAX package's ``jax.checkpoint`` per scanned block): its activations
    are recomputed in the backward."""
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, ((kind, n), p_seg) in enumerate(zip(segments(cfg),
                                                params["segments"])):
        for i in range(n):
            p_l = {name: leaf[i] for name, leaf in p_seg.items()}
            c_l = ({name: leaf[i] for name, leaf in caches[si].items()}
                   if caches is not None else None)
            if remat:
                x, aux = torch.utils.checkpoint.checkpoint(
                    _apply_block, kind, p_l, x, cfg, mode, c_l, length,
                    use_reentrant=False)
            else:
                x, aux = _apply_block(kind, p_l, x, cfg, mode, c_l, length)
            aux_total = aux_total + aux
    return x, aux_total


# ============================================================== entry points
def _embed_in(params, cfg, tokens=None, embeds=None):
    """(B, S, d) inputs: the token embeddings, or for the ``embeddings``
    frontend the caller's embeddings cast to the model's dtype."""
    if cfg.frontend == "embeddings":
        if embeds is None:
            raise ValueError(f"{cfg.name} takes embeddings: pass embeds=")
        return embeds.to(cfg.dtype)
    if tokens is None:
        raise ValueError(f"{cfg.name} takes tokens")
    return params["embed"][tokens]


def forward(params, cfg: ModelConfig, tokens=None, *, embeds=None):
    """Training forward: (logits (B, S, V) for every position of
    ``tokens`` (B, S) or ``embeds`` (B, S, d), the aux loss: the MoE
    balance terms summed over blocks, a float32 zero without MoE)."""
    x, aux = _run_segments(params, _embed_in(params, cfg, tokens, embeds),
                           cfg, "train", None, None)
    logits = rms_norm(x, params["final_norm"]) @ params["lm_head"]
    return logits, aux


def loss_fn(params, batch, cfg: ModelConfig, aux_coef: float = 0.01):
    """(ce + aux_coef * aux, {"ce", "aux"}): next-token cross-entropy in
    float32 over the positions whose label is >= 0, as the JAX package's
    ``loss_fn``.  ``batch``: {"tokens" (B, S) or "embeds" (B, S, d),
    "labels" (B, S)}."""
    logits, aux = forward(params, cfg, batch.get("tokens"),
                          embeds=batch.get("embeds"))
    labels = batch["labels"]
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    # a masked label (< 0) gathers column 0; the mask drops it
    ll = torch.gather(logp, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    mask = (labels >= 0).to(torch.float32)
    ce = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce + aux_coef * aux, {"ce": ce, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """Zero caches, one dict per segment (see ``kvcache``)."""
    return [
        init_segment_cache(kind, n, batch, cache_len, cfg, cfg.dtype,
                           device=device)
        for kind, n in segments(cfg)
    ]


def prefill(params, cfg: ModelConfig, tokens=None,
            cache_len: int | None = None, *, embeds=None):
    """Full-sequence pass over ``tokens`` (B, S) or ``embeds`` (B, S, d)
    -> (last-position logits (B, V), caches, length S)."""
    x = _embed_in(params, cfg, tokens, embeds)
    B, S = x.shape[0], x.shape[1]
    caches = init_cache(cfg, B, cache_len or S, device=x.device)
    x, _ = _run_segments(params, x, cfg, "prefill", caches, None)
    logits = rms_norm(x[:, -1], params["final_norm"]) @ params["lm_head"]
    return logits, caches, S


def decode_step(params, caches, length: int, cfg: ModelConfig, tokens=None,
                *, embeds=None):
    """One-step decode of ``tokens`` (B,) int or ``embeds`` (B, d).
    Writes the step into ``caches`` in place and returns (logits (B, V),
    caches, length + 1)."""
    x = _embed_in(params, cfg, tokens, embeds)[:, None, :]
    x, _ = _run_segments(params, x, cfg, "decode", caches, length)
    logits = rms_norm(x[:, 0], params["final_norm"]) @ params["lm_head"]
    return logits, caches, length + 1
