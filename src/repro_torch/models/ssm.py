"""Attention-free mixers: RWKV6 (Finch) and RG-LRU (Griffin/RecurrentGemma).

The JAX package's ``models/ssm.py`` op for op.  Both are linear-recurrence
token mixers with O(1) decode state.  Train and prefill run the
recurrence as a Python loop over time (the port's form of ``lax.scan``;
RWKV6 also has the chunk-parallel form); decode is a single recurrence
step on carried state.  No TPU kernel computes these: JAX runs its scans
outside any Pallas kernel, and the port runs them as plain PyTorch.

RWKV6 (arXiv:2404.05892), simplified faithfully:
  per head h, state S_t in R^{dk x dv}:
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^t v_t)        (u: bonus for current)
  with data-dependent decay w_t = exp(-exp(w0 + tanh(x_t A) B)) and
  token-shift interpolation x'_t = lerp(x_t, x_{t-1}, mu_*).

RG-LRU (arXiv:2402.19427):
    r_t = sigmoid(x_t W_r);  i_t = sigmoid(x_t W_i)
    a_t = a^(c * r_t)  (a = sigmoid(Lambda), c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
  preceded by a short depthwise conv1d (Griffin recurrent block).

Dtypes follow the JAX package cast for cast: the projections run in the
activation dtype; RWKV6's decay is computed in float32 from its logit
and the recurrence runs in float32; RG-LRU's decay exponent is computed
in the activation dtype and cast, its gated input stays in the activation
dtype until the step widens it, its carry is float32 and each step is
emitted in the activation dtype.

Each loop over time asks the cost counter how many of its steps to run
(``obs/cost.loop_steps``): all of them, except in a dry run on ``meta``
tensors that probes loops, where the first steps run, the counter scales
what they count by the trip count, and the last step's output stands in
for the rest (``meta`` tensors hold no values).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..obs import cost as _cost
from .layers import pad_steps

__all__ = ["rwkv6_mix", "rwkv6_channelmix", "rglru_block"]


def _first(t, steps: int):
    """The first ``steps`` entries of ``t``'s leading (time) axis: ``t``
    itself unless a dry run probes its loop."""
    return t if steps == t.shape[0] else t[:steps]


# --------------------------------------------------------------------- RWKV6
def _rwkv6_chunked(r, k, v, w, u, state0, chunk: int = 16):
    """Chunk-parallel (GLA-form) RWKV6 recurrence, equal to the per-token
    one.  With per-channel decay w_t and b_i = sum_{j<=i} log w_j
    (monotone non-increasing within a chunk),

      intra:  o_i += sum_{j<i} (r_i * e^{b_{i-1}-b_j}) . k_j  v_j
              + (r_i . u k_i) v_i                  (diagonal bonus)
      cross:  o_i += (r_i * e^{b_{i-1}}) S_in
      state:  S_out = diag(e^{b_last}) S_in + sum_j (k_j e^{b_last-b_j})^T v_j

    All exponents are <= 0: cross/state by monotonicity, and the intra
    pair term is computed exactly per (i, j, d) as one broadcast multiply
    and reduce, clamped at 0 only for the masked j >= i half.  The
    factored e^{-b_j} form of matmul GLA would overflow for fast decay.

    A ragged tail is padded with r = k = v = 0 (no output or state
    contribution) and w = 1.  When a gradient is being taken each chunk
    step runs under ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``):
    the backward keeps one state per chunk, not per token.
    """
    B, S, H, D = r.shape
    if S % chunk:
        pad = chunk - S % chunk
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    C = chunk
    N = r.shape[1] // C

    def seg(t):  # (B, S, H, D) -> (N, B, C, H, D)
        return t.reshape(B, N, C, H, D).movedim(1, 0)

    rs, ks, vs, ws = seg(r), seg(k), seg(v), seg(w)
    causal = torch.tril(torch.ones((C, C), dtype=torch.float32,
                                   device=r.device), -1)  # strict lower

    def chunk_step(state, r_c, k_c, v_c, w_c):  # (B, C, H, D) each
        # r/k/v may arrive in bf16 (their producing matmuls are bf16); all
        # recurrence math is float32
        r_c, k_c, v_c = (t.to(torch.float32) for t in (r_c, k_c, v_c))
        logw = torch.log(torch.clamp(w_c, min=1e-38))
        b = torch.cumsum(logw, dim=1)            # (B, C, H, D), <= 0
        b_last = b[:, -1:, :, :]
        b_prev = b - logw                        # b_{i-1}
        # intra-chunk, exact pairwise decay: exponent b_{i-1} - b_j <= 0
        # on the causal (j < i) half; the masked half clamped to 0
        expo = torch.clamp(b_prev[:, :, None] - b[:, None], max=0.0)
        att = torch.sum(r_c[:, :, None] * k_c[:, None] * torch.exp(expo),
                        dim=-1)                  # (B, C, C, H)
        att = att * causal[None, :, :, None]
        o = torch.einsum("bijh,bjhd->bihd", att, v_c)
        diag = torch.einsum("bihd,bihd->bih", r_c * u[None, None], k_c)
        o = o + diag[..., None] * v_c
        # cross-chunk from the carried state (exponent <= 0)
        q_in = r_c * torch.exp(b_prev)
        o = o + torch.einsum("bihk,bhkv->bihv", q_in, state)
        # state update (exponents <= 0)
        k_out = k_c * torch.exp(b_last - b)
        state = torch.exp(b_last)[:, 0, :, :, None] * state + torch.einsum(
            "bjhk,bjhv->bhkv", k_out, v_c)
        return state, o

    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (r, k, v, w, u, state0))
    state, outs = state0, []
    steps = _cost.loop_steps(N, r)
    for n in _cost.probed(range(steps), N, steps, "rwkv6 chunks"):
        if remat:
            state, o = torch.utils.checkpoint.checkpoint(
                chunk_step, state, rs[n], ks[n], vs[n], ws[n],
                use_reentrant=False)
        else:
            state, o = chunk_step(state, rs[n], ks[n], vs[n], ws[n])
        outs.append(o)
    out = pad_steps(torch.stack(outs, dim=1), N).reshape(B, N * C, H, D)
    return out[:, :S], state


def _rwkv6_recurrence(r, k, v, w, u, state0):
    """r,k,v: (B, S, H, D); w: (B, S, H, D) decay in (0,1); u: (H, D).

    state: (B, H, D, D) mapping k-dim -> v-dim.  Returns (out, state_final).
    One step per token, in the JAX step's order: kv = k (x) v; out = r .
    (state + u kv); state = w state + kv.
    """
    r, k, v, w = (t.movedim(1, 0).contiguous() for t in (r, k, v, w))
    ub = u[None, :, :, None]
    state, outs = state0, []
    S = r.shape[0]
    steps = _cost.loop_steps(S, r)
    rows = zip(*(_first(t, steps).unbind(0) for t in (r, k, v, w)))
    for r_t, k_t, v_t, w_t in _cost.probed(rows, S, steps, "rwkv6 tokens"):
        kv = k_t[..., :, None] * v_t[..., None, :]  # (B, H, Dk, Dv)
        # einsum("bhk,bhkv->bhv") as one batched product
        outs.append(torch.matmul(r_t[..., None, :], state + ub * kv)[
            ..., 0, :])
        state = w_t[..., :, None] * state + kv
    return pad_steps(torch.stack(outs, dim=1), S), state  # (B, S, H, Dv)


def _matmul(p):
    """The projections' default: ``t @ p[name]``."""
    return lambda t, name: t @ p[name]


def rwkv6_mix(p, x, cfg, state=None, prev_x=None, mm=None):
    """RWKV6 time-mix.  x: (B, S, d).  Returns (y, (state, last_x)).

    ``state`` (B, H, D, D) float32 and ``prev_x`` (B, d), the previous
    token's input, default to zeros (a prefill).  The chunked form runs
    iff ``cfg.rwkv_chunk`` is set and S > 1.  ``mm(t, name)`` computes
    each projection ``t @ p[name]`` (under a mesh, the sharded program's
    linear; every ``rwkv_w_*`` result is whole)."""
    mm = mm or _matmul(p)
    B, S, d = x.shape
    H, D = cfg.num_heads, cfg.rwkv_head_dim
    dt = x.dtype
    f32 = torch.float32
    if prev_x is None:
        prev_x = torch.zeros((B, d), dtype=dt, device=x.device)
    x_shift = torch.cat([prev_x[:, None], x[:, :-1]], dim=1)

    def lerp(mu):
        return x + (x_shift - x) * mu

    def heads(t):
        return t.reshape(B, S, H, D)

    r = heads(mm(lerp(p["rwkv_mu_r"]), "rwkv_w_r"))
    k = heads(mm(lerp(p["rwkv_mu_k"]), "rwkv_w_k"))
    v = heads(mm(lerp(p["rwkv_mu_v"]), "rwkv_w_v"))
    g = F.silu(mm(lerp(p["rwkv_mu_g"]), "rwkv_w_g"))
    # data-dependent decay (low-rank): w = exp(-exp(w0 + tanh(x A) B))
    dd = torch.tanh(mm(lerp(p["rwkv_mu_w"]), "rwkv_w_decay_a"))
    logit = p["rwkv_w0"] + mm(dd, "rwkv_w_decay_b")
    w = heads(torch.exp(-torch.exp(logit.to(f32))))

    if state is None:
        state = torch.zeros((B, H, D, D), dtype=f32, device=x.device)
    u = p["rwkv_u"].to(f32)
    chunk = cfg.rwkv_chunk
    if chunk and S > 1:
        # r/k/v stay in the activation dtype until inside the chunk step
        out, state = _rwkv6_chunked(r, k, v, w, u, state, chunk=chunk)
    else:
        out, state = _rwkv6_recurrence(r.to(f32), k.to(f32), v.to(f32), w,
                                       u, state)
    out = out.reshape(B, S, H * D).to(dt)
    y = mm(out * g, "rwkv_w_o")
    return y, (state, x[:, -1])


def rwkv6_channelmix(p, x, prev_x=None, mm=None):
    """RWKV channel-mix FFN (relu^2), with token shift.  Returns (y, the
    last token's input).  ``mm`` as in :func:`rwkv6_mix`."""
    mm = mm or _matmul(p)
    B, S, d = x.shape
    if prev_x is None:
        prev_x = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    x_shift = torch.cat([prev_x[:, None], x[:, :-1]], dim=1)
    xk = x + (x_shift - x) * p["rwkv_mu_ck"]
    xr = x + (x_shift - x) * p["rwkv_mu_cr"]
    h = torch.square(torch.relu(mm(xk, "rwkv_w_ck")))
    gate = torch.sigmoid(mm(xr, "rwkv_w_cr"))
    return gate * mm(h, "rwkv_w_cv"), x[:, -1]


# -------------------------------------------------------------------- RG-LRU
LRU_C = 8.0


def _rglru_recurrence(a, gated_x, h0, out_dtype=torch.float32):
    """a: (B, S, W) float32 (decay precision near 1 matters); gated_x may
    be bf16; h0: (B, W) float32 carry.  Emits hs in ``out_dtype``.

    The step is JAX's h = a_t h + sqrt(max(1 - a_t^2, 0)) gx_t; its second
    term reads no carry, so it is computed for every step before the loop
    (elementwise, the same values), and the loop runs a multiply and an
    add a step."""
    bx = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * gated_x.to(
        torch.float32)
    a, bx = a.movedim(1, 0).contiguous(), bx.movedim(1, 0).contiguous()
    h, outs = h0, []
    S = a.shape[0]
    steps = _cost.loop_steps(S, a)
    rows = zip(_first(a, steps).unbind(0), _first(bx, steps).unbind(0))
    for a_t, bx_t in _cost.probed(rows, S, steps, "rglru tokens"):
        h = a_t * h + bx_t
        outs.append(h.to(out_dtype))
    return pad_steps(torch.stack(outs, dim=1), S), h


def rglru_block(p, x, cfg, state=None, mm=None):
    """Griffin recurrent block: in-proj + conv1d + RG-LRU + gated out-proj.

    x: (B, S, d).  state = (h (B, W) float32, conv tail (B, cw-1, W)),
    zeros when None (a prefill).  Returns (y, state).  The block runs on
    the W channels ``p``'s per-channel leaves hold: under a mesh, this
    rank's channels, with ``mm`` (as in :func:`rwkv6_mix`) giving this
    rank's channels of ``lru_in``/``lru_gate`` and the whole ``lru_out``
    product.
    """
    mm = mm or _matmul(p)
    B, S, d = x.shape
    W = p["lru_lambda"].shape[-1]
    cw = cfg.conv_width
    dt = x.dtype
    u = mm(x, "lru_in")  # (B, S, W)
    gate_branch = F.gelu(mm(x, "lru_gate"), approximate="tanh")

    if state is None:
        h0 = torch.zeros((B, W), dtype=torch.float32, device=x.device)
        conv_tail = torch.zeros((B, cw - 1, W), dtype=dt, device=x.device)
    else:
        h0, conv_tail = state
    # depthwise causal conv1d over time, width cw: JAX's sum of cw shifted
    # products, then the bias
    u_pad = torch.cat([conv_tail, u], dim=1)  # (B, S+cw-1, W)
    conv = sum(u_pad[:, i:i + S] * p["lru_conv"][i][None, None, :]
               for i in range(cw)) + p["lru_conv_bias"][None, None, :]
    new_tail = u_pad[:, S:, :]

    # per-channel gates (Griffin uses block-diagonal W_a/W_x; the diagonal
    # form keeps the recurrence TP-shardable with zero replicated weight)
    r = torch.sigmoid(conv * p["lru_wr"][None, None, :] + p["lru_br"])
    i_g = torch.sigmoid(conv * p["lru_wi"][None, None, :] + p["lru_bi"])
    # jax.nn.softplus is logaddexp(x, 0) (torch's softplus switches to x
    # past a threshold)
    lam = p["lru_lambda"]
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))
    log_a = -LRU_C * r * softplus[None, None, :]
    a = torch.exp(log_a.to(torch.float32))
    gx = i_g * conv  # the activation dtype; float32 inside the step
    hs, h_last = _rglru_recurrence(a, gx, h0, out_dtype=dt)
    y = mm(hs * gate_branch, "lru_out")
    return y, (h_last, new_tail)
