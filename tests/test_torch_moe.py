"""The port's MoE FFN (``models/moe.py``) against the JAX package's
``models/moe.py`` on one device (``mesh=None``), on the CPU.

Mirrors ``tests/test_moe_dispatch.py`` (the dense every-expert oracle
with nothing dropped, and drops over capacity), then holds each piece
against JAX's: ``_route``, ``router_aux_loss``, ``_local_expert_pass``
(also on a slice of the experts, as an expert-parallel shard runs it) and
``moe_ffn`` with and without shared experts and with drops forced by
capacity.  Expert ids, queue positions, the kept mask and the dropped
count must be equal exactly; y, gates and aux within 1e-5 in float32.

Where ids must match exactly, x and the router are drawn on a grid
(multiples of 1/8 and 1/64 in [-1, 1] and [-1/8, 1/8]), so the router
logits are exact in float32 in any summation order: near-equal
probabilities cannot fall apart by rounding, and exactly equal ones (the
grid makes them) test ``lax.top_k``'s lower-index-first order.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import smoke_config as jax_smoke_config
from repro.distributed import MeshRules
from repro.models import moe as jmoe
from repro_torch.configs import smoke_config
from repro_torch.models import moe

RULES = MeshRules(mesh=None)
TOL = 1e-5


def _grid(rng, shape, step):
    return (rng.integers(-8, 9, shape) * step).astype(np.float32)


def _params(rng, cfg, shared: bool, grid_router: bool = True):
    d, E, h = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff
    p = {
        "router": (_grid(rng, (d, E), 1 / 64) if grid_router else
                   rng.standard_normal((d, E)).astype(np.float32)),
        "experts_w1": 0.1 * rng.standard_normal((E, d, h)),
        "experts_w3": 0.1 * rng.standard_normal((E, d, h)),
        "experts_w2": 0.1 * rng.standard_normal((E, h, d)),
    }
    if shared:
        hs = cfg.moe_num_shared * h
        p.update(shared_w1=0.1 * rng.standard_normal((d, hs)),
                 shared_w3=0.1 * rng.standard_normal((d, hs)),
                 shared_w2=0.1 * rng.standard_normal((hs, d)))
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _jax_positions(experts, capacity, e_offset, e_loc, num_experts):
    """The queue positions, kept mask, slots and dropped count exactly as
    the JAX package's ``_local_expert_pass`` computes them
    (``src/repro/models/moe.py:64-88``), which returns only y and the
    count."""
    fe = experts.reshape(-1)
    order = jnp.argsort(fe, stable=True)
    fe_sorted = fe[order]
    seg_start = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32),
         jnp.cumsum(jnp.bincount(fe_sorted, length=num_experts), axis=0)[
             :-1].astype(jnp.int32)])
    pos_sorted = jnp.arange(fe.shape[0], dtype=jnp.int32) \
        - seg_start[fe_sorted]
    pos = jnp.zeros((fe.shape[0],), jnp.int32).at[order].set(pos_sorted)
    local = (fe >= e_offset) & (fe < e_offset + e_loc)
    kept = local & (pos < capacity)
    dropped = jnp.sum(local & (pos >= capacity))
    slot = jnp.where(kept, (fe - e_offset) * capacity + pos,
                     e_loc * capacity)
    return pos, kept, slot, dropped


def _dense_oracle(x, params, cfg):
    """Every expert on every token, mixed by the renormalized top-k gates
    (``tests/test_moe_dispatch.py``'s oracle, in torch)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    gates, experts, _ = moe._route(xt, params["router"], cfg.moe_top_k)
    h = torch.einsum("td,edh->teh", xt, params["experts_w1"])
    g = F.silu(torch.einsum("td,edh->teh", xt, params["experts_w3"]))
    all_out = torch.einsum("teh,ehd->ted", h * g, params["experts_w2"])
    mix = torch.einsum("tke,tk->te", F.one_hot(
        experts, cfg.moe_num_experts).to(torch.float32), gates)
    y = torch.einsum("ted,te->td", all_out, mix)
    if "shared_w1" in params:
        y = y + (xt @ params["shared_w1"]
                 * F.silu(xt @ params["shared_w3"])) @ params["shared_w2"]
    return y.reshape(B, S, d)


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


# --------------------------------------- mirrors of test_moe_dispatch.py
def test_moe_dispatch_matches_dense_oracle():
    cfg = dataclasses.replace(smoke_config("qwen3_moe_235b"),
                              capacity_factor=64.0)  # no drops
    rng = np.random.default_rng(0)
    p = {k: torch.from_numpy(v) for k, v in
         _params(rng, cfg, False, grid_router=False).items()}
    p["router"] *= 0.5
    x = torch.from_numpy(rng.standard_normal((2, 8, cfg.d_model)).astype(
        np.float32))
    y, aux, drop = moe.moe_ffn(x, p, cfg)
    assert float(drop) == 0.0
    torch.testing.assert_close(y, _dense_oracle(x, p, cfg), rtol=2e-4,
                               atol=2e-4)


def test_moe_dispatch_drops_over_capacity():
    cfg = dataclasses.replace(smoke_config("deepseek_v2_lite"),
                              capacity_factor=0.05)
    rng = np.random.default_rng(1)
    p = {k: torch.from_numpy(v) for k, v in
         _params(rng, cfg, True, grid_router=False).items()}
    x = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model)).astype(
        np.float32))
    y, aux, drop = moe.moe_ffn(x, p, cfg)
    assert float(drop) > 0.0  # capacity bound is enforced
    assert bool(torch.isfinite(y).all())


# -------------------------------------------------------- against JAX
@pytest.mark.parametrize("T,E,k,ties", [(32, 8, 2, False), (40, 8, 2, True),
                                        (64, 16, 6, False)])
def test_route_matches_jax(T, E, k, ties):
    rng = np.random.default_rng(T + E)
    x = _grid(rng, (T, 24), 1 / 8)
    w = _grid(rng, (24, E), 1 / 64)
    if ties:  # every probability of some rows equal, pairs equal in others
        x[:5] = 0.0
        w[:, 1] = w[:, 4]
    jg, je, jp = jmoe._route(jnp.asarray(x), jnp.asarray(w), k)
    g, e, p = moe._route(torch.from_numpy(x), torch.from_numpy(w), k)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    _close(g, jg)
    _close(p, jp)
    if ties:
        np.testing.assert_array_equal(e[:5].numpy(),
                                      np.tile(np.arange(k), (5, 1)))
    np.testing.assert_allclose(
        float(moe.router_aux_loss(p, e, E)),
        float(jmoe.router_aux_loss(jp, je, E)), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("capacity,e_offset,e_loc", [
    (20, 0, 8),  # nothing dropped
    (5, 0, 8),   # drops over capacity
    (1, 0, 8),   # a decode step's capacity
    (5, 2, 4),   # one shard's experts, as the expert-parallel path runs it
])
def test_local_expert_pass_matches_jax(capacity, e_offset, e_loc):
    cfg = smoke_config("qwen3_moe_235b")
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    rng = np.random.default_rng(capacity + e_offset)
    p = _params(rng, cfg, False)
    x = _grid(rng, (24, cfg.d_model), 1 / 8)
    jg, je, _ = jmoe._route(jnp.asarray(x), jnp.asarray(p["router"]), k)
    g, e, _ = moe._route(torch.from_numpy(x), torch.from_numpy(p["router"]),
                         k)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    want = _jax_positions(je, capacity, e_offset, e_loc, E)
    got = moe._dispatch(e, capacity, e_offset, e_loc, E)
    for name, a, b in zip(("pos", "kept", "slot", "dropped"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    ws = [p[n][e_offset:e_offset + e_loc]
          for n in ("experts_w1", "experts_w3", "experts_w2")]
    jy, jdrop = jmoe._local_expert_pass(
        jnp.asarray(x), jg, je, *map(jnp.asarray, ws), capacity,
        jnp.int32(e_offset), E)
    y, drop = moe._local_expert_pass(
        torch.from_numpy(x), g, e, *map(torch.from_numpy, ws), capacity,
        e_offset, E)
    assert int(drop) == int(jdrop) == int(want[3])
    _close(y, jy)


@pytest.mark.parametrize("arch,shared,capacity_factor", [
    ("qwen3_moe_235b", False, 1.25),    # no shared experts
    ("deepseek_v2_lite", True, 1.25),   # one shared expert (smoke)
    ("deepseek_v2_lite", True, 0.3),    # drops forced by capacity
    ("qwen3_moe_235b", False, 0.05),    # capacity 1 (max(1, int(...)))
])
def test_moe_ffn_matches_jax(arch, shared, capacity_factor):
    cfg = dataclasses.replace(smoke_config(arch),
                              capacity_factor=capacity_factor)
    jcfg = dataclasses.replace(jax_smoke_config(arch),
                               capacity_factor=capacity_factor)
    assert bool(cfg.moe_num_shared) == shared
    rng = np.random.default_rng(7)
    jp, p = _both(_params(rng, cfg, shared))
    x = _grid(rng, (2, 16, cfg.d_model), 1 / 8)
    jy, jaux, jdrop = jmoe.moe_ffn(jnp.asarray(x), jp, jcfg, RULES)
    y, aux, drop = moe.moe_ffn(torch.from_numpy(x), p, cfg)
    assert y.shape == x.shape and aux.dtype == drop.dtype == torch.float32
    assert float(drop) == float(jdrop)
    if capacity_factor < 1:
        assert float(drop) > 0.0
    _close(y, jy)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=TOL)


def test_moe_ffn_bf16_matches_jax():
    """The served dtype: bf16 weights and activations, y within 2e-2 of
    max|y| (the LM tests' bf16 tolerance), the same drops."""
    cfg = smoke_config("deepseek_v2_lite")
    jcfg = jax_smoke_config("deepseek_v2_lite")
    rng = np.random.default_rng(9)
    p = _params(rng, cfg, True)
    x = _grid(rng, (2, 16, cfg.d_model), 1 / 8)
    jy, _, jdrop = jmoe.moe_ffn(
        jnp.asarray(x, jnp.bfloat16),
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}, jcfg, RULES)
    y, _, drop = moe.moe_ffn(
        torch.from_numpy(x).bfloat16(),
        {k: torch.from_numpy(v).bfloat16() for k, v in p.items()}, cfg)
    assert y.dtype == torch.bfloat16 and float(drop) == float(jdrop)
    want = np.asarray(jy.astype(jnp.float32))
    assert float(np.abs(y.float().numpy() - want).max()) <= \
        2e-2 * float(np.abs(want).max())


def test_capacity_is_computed_as_jax_does():
    """max(1, int(T k cf / E)) in Python floats: Qwen3-MoE's prefill of
    4 x 2048 tokens gets 640 slots an expert, a decode step of 4 one."""
    for (T, k, cf, E), want in (((8192, 8, 1.25, 128), 640),
                                ((4, 6, 1.25, 64), 1),
                                ((4, 6, 64.0, 64), 24)):
        assert max(1, int(T * k * cf / E)) == want
    cfg = dataclasses.replace(smoke_config("qwen3_moe_235b"),
                              capacity_factor=0.05)
    rng = np.random.default_rng(3)
    p = {k: torch.from_numpy(v) for k, v in _params(rng, cfg, False).items()}
    x = torch.from_numpy(_grid(rng, (1, 16, cfg.d_model), 1 / 8))
    _, _, drop = moe.moe_ffn(x, p, cfg)
    # one slot an expert: at most E of the 32 assignments kept
    assert float(drop) >= (32 - cfg.moe_num_experts) / 32
