"""Token-choice top-k MoE FFN: the JAX package's ``models/moe.py``, on
one device (its ``mesh is None`` path, ``inner_local``) and expert-parallel
under a mesh (``rules=``).

Each token's router picks its top-k experts; each expert takes at most
``capacity = max(1, int(T k capacity_factor / E))`` assignments, in token
order, and the rest are dropped (Switch-style).  The kept assignments are
gathered into an (E, capacity, d) buffer, every expert runs its SwiGLU
FFN on its rows as one batched product, and each token sums its k expert
rows weighted by its renormalized gates.  Shared experts (DeepSeek) run
on every token and are added before the return.

Which assignments are dropped follows the JAX package exactly:
  * ``lax.top_k`` puts the lower expert index first among equal
    probabilities; ``torch.topk`` leaves their order unspecified, so the
    top k come from a stable descending sort;
  * an assignment's queue position is its rank among all assignments to
    its expert, by a stable argsort of the flat (T k) expert ids;
  * capacity is computed in Python floats from the static T.

Expert parallelism (``rules=`` with a mesh; JAX's ``inner`` under
``shard_map``): a rank holds E / tp experts (``experts_*`` split over the
model axis; E must divide it, as JAX asserts) and its data shard's
tokens, replicated over the model axis.  It routes its tokens (the
router is replicated), runs its experts at ``e_offset = rank * E / tp``
with the capacity of its own token count (with dp > 1 not the unsharded
capacity, as in JAX), adds its column/row-parallel part of the shared
experts when their width divides tp, and one sum over the model axis
merges everything; the aux loss is averaged and the drop fraction
maximised over the model axis.  Where the shared experts' width does not
divide tp they are replicated, and the port adds them once, after the
sum: JAX adds them inside its ``psum`` and so counts them tp times (no
shipped configuration reaches this; ROADMAP queue 3).

Gradients under a mesh (``_tp``'s convention): the expert-parallel
leaves enter here over the dp axes (each rank routes its own tokens); the
tokens and the router go through ``compat.pvary`` over the model axis
before they reach the routing, this rank's experts and its shared
columns (each rank's gates reach only its experts); and the sum's
cotangent passes to every rank.  The aux loss's gradient is then, as in JAX, the mean over the
model axis of the ranks' equal terms; the drop fraction carries none.

The combine gathers a (T, k, d) tensor of expert rows before the weighted
sum, which XLA fuses away and eager PyTorch does not (537 MB at
Qwen3-MoE's prefill of 8,192 tokens in bf16; ``PERF.md``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["LEAVES", "moe_ffn", "router_aux_loss"]

LEAVES = ("router", "experts_", "shared_")  # a MoE FFN's leaf names


def _route(x, router_w, top_k: int):
    """x: (T, d) -> (gates (T, k) float32, experts (T, k) int64, probs
    (T, E) float32); the gates renormalized to sum to one."""
    logits = x.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    # the top k, the lower index first among equal values (lax.top_k)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :top_k], experts[:, :top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, experts, probs


def router_aux_loss(probs, experts, num_experts: int):
    """Switch-style load-balancing loss: E * sum_e f_e * P_e, with f_e the
    share of assignments to expert e and P_e its mean probability."""
    fe = experts.reshape(-1)
    counts = torch.zeros(num_experts, dtype=torch.float32,
                         device=fe.device).index_add_(
        0, fe, torch.ones(fe.shape, dtype=torch.float32, device=fe.device))
    f = counts / torch.clamp(counts.sum(), min=1.0)
    return num_experts * torch.sum(f * probs.mean(dim=0))


def _dispatch(experts, capacity: int, e_offset: int, e_loc: int,
              num_experts: int):
    """Queue positions and capacity slots of the flat (T k) assignments.

    Returns (pos: each assignment's rank among all assignments to its
    expert, kept: local to experts [e_offset, e_offset + e_loc) and
    within capacity, slot: its row of the (e_loc * capacity) buffer, the
    sentinel e_loc * capacity where not kept, dropped: the count of local
    assignments over capacity), all on ``experts``' device.
    """
    fe = experts.reshape(-1)
    n = fe.numel()
    order = torch.argsort(fe, stable=True)
    fe_sorted = fe[order]
    # assignments per expert (``bincount`` would read its length back
    # from the card), then each expert's first index in the sorted order
    counts = torch.zeros(num_experts, dtype=fe.dtype,
                         device=fe.device).index_add_(0, fe,
                                                      torch.ones_like(fe))
    seg_start = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(n, device=fe.device) - seg_start[fe_sorted]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    local = (fe >= e_offset) & (fe < e_offset + e_loc)
    kept = local & (pos < capacity)
    dropped = (local & (pos >= capacity)).sum()
    slot = torch.where(kept, (fe - e_offset) * capacity + pos,
                       torch.full_like(pos, e_loc * capacity))
    return pos, kept, slot, dropped


def _local_expert_pass(x, gates, experts, w1, w3, w2, capacity: int,
                       e_offset: int, num_experts: int):
    """Dispatch the tokens to the experts held here, run them, combine.

    x: (T, d); gates/experts: (T, k); w1/w3 (E_loc, d, h), w2 (E_loc, h,
    d).  Returns ((T, d) output, zero rows for tokens whose experts are
    all dropped or elsewhere; the count of dropped assignments).
    """
    T, d = x.shape
    k = experts.shape[1]
    e_loc = w1.shape[0]
    _, kept, slot, dropped = _dispatch(experts, capacity, e_offset, e_loc,
                                       num_experts)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    # token ids into the capacity buffer, then x gathered straight into
    # it; unkept assignments all write the sentinel entry, cut off after
    tok_buf = torch.full((e_loc * capacity + 1,), T, dtype=tok.dtype,
                         device=x.device)
    tok_buf.index_put_((slot,), tok)
    x_pad = torch.cat([x, x.new_zeros((1, d))], dim=0)
    buf = x_pad[tok_buf[:-1]].reshape(e_loc, capacity, d)

    h = torch.bmm(buf, w1)
    g = F.silu(torch.bmm(buf, w3))
    out_buf = torch.bmm(h * g, w2)  # (E_loc, C, d)
    del buf, h, g

    # combine: each token's k expert rows, weighted by its gates; dropped
    # assignments point at a zero row
    flat_out = torch.cat([out_buf.reshape(e_loc * capacity, d),
                          out_buf.new_zeros((1, d))], dim=0)
    w_2d = torch.where(kept, gates.reshape(-1), 0.0).reshape(T, k).to(
        x.dtype)
    y = torch.einsum("tkd,tk->td", flat_out[slot.reshape(T, k)], w_2d)
    return y, dropped


def _shared(xt, w1, w3, w2):
    return (xt @ w1 * F.silu(xt @ w3)) @ w2


def moe_ffn(x, params, cfg, *, rules=None):
    """MoE FFN.  x: (B, S, d).  Returns (y (B, S, d), aux loss (float32
    scalar), dropped fraction of the T k assignments (float32 scalar)).

    params: router (d, E); experts_w1/w3 (E, d, h); experts_w2 (E, h, d);
    optional shared_w1/w3 (d, hs), shared_w2 (hs, d).  Under ``rules``
    with a mesh (called under ``compat.use_mesh(rules.mesh)``): x is this
    rank's data shard and ``params`` its blocks
    (``sharding.shard_params``); the expert-parallel path above, whose
    collectives a mesh of one rank skips.
    """
    from ..distributed import compat
    from ..distributed._tp import TP

    ctx = TP(rules, cfg)
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    if E % ctx.ntp:
        raise ValueError(f"{E} experts do not divide the model axis of "
                         f"{ctx.ntp} ranks")
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    specs = ctx.specs(("full", "moe"))
    params = ctx.enter({n: t for n, t in params.items()
                        if n.startswith(LEAVES)}, specs)
    # the tokens and the router, the same on every rank of the model axis,
    # into this rank's gates (which reach only its experts), experts and
    # shared columns
    xe = ctx.vary(xt)
    router = ctx.weight(params["router"], specs["router"])
    gates, experts, probs = _route(xe, ctx.vary(router), k)
    aux = router_aux_loss(probs, experts, E)
    capacity = max(1, int(T * k * cfg.capacity_factor / E))
    w1 = params["experts_w1"]  # (E / tp, d, h): split over the model axis
    y, dropped = _local_expert_pass(
        xe, gates, experts, w1, params["experts_w3"], params["experts_w2"],
        capacity, ctx.tp_rank * w1.shape[0], E)
    shared_after = None
    if "shared_w1" in params:
        hs = cfg.moe_num_shared * cfg.moe_d_ff
        ws = [ctx.weight(params[n], specs[n])
              for n in ("shared_w1", "shared_w3", "shared_w2")]
        if hs % ctx.ntp == 0:  # column/row-parallel: a partial sum
            y = y + _shared(xe, *ws)
        else:  # replicated: added once, after the sum
            shared_after = _shared(xt, *ws)
    # one all-reduce merges the experts' outputs and the shared partials
    y = ctx.psum_tp(y)
    if shared_after is not None:
        y = y + shared_after
    drop = dropped.to(torch.float32) / (T * k)
    if ctx.ntp > 1:
        aux = compat.psum(aux, ctx.tp) / ctx.ntp
        drop = compat.pmax(drop, ctx.tp)
    return y.reshape(B, S, d), aux, drop
