"""The port's multi-head latent attention (MLA) against the JAX package,
on the CPU.

Mirrors ``tests/test_mla_absorb.py`` (the absorbed decode equals
expand-then-attend), then holds ``transformer._mla_mixer`` in its three
modes (prefill, decode expanding the compressed cache, absorbed decode)
against JAX's at the DeepSeek-V2-Lite smoke widths in float32 within
2e-5, and ``attention.attend`` with V narrower than Q and K (MLA)
against JAX's ``attend`` (full-causal attention refuses a V wider
than K), forward and the gradients of the plain version.  The port's full-causal attention pads V to K's width and runs
K7 (here its plain version); the JAX package runs its plain scan.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.distributed import MeshRules
from repro.models import attention as jatt
from repro.models import transformer as JT
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.distributed._tp import TP
from repro_torch.models import attention
from repro_torch.models import transformer as T

RULES = MeshRules(mesh=None)
ARCH = "deepseek_v2_lite"
TOL = 2e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(absorb=False):
    over = dict(dtype_str="float32", mla_absorb=absorb)
    return (dataclasses.replace(jax_smoke_config(ARCH), **over),
            dataclasses.replace(smoke_config(ARCH), **over))


def _layer(seed=0):
    """One MLA layer's parameters from the JAX package's ``init_params``
    (float32), with a nonzero ``ln_kv`` gain, as numpy."""
    jcfg, _ = _cfgs()
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    layer = {k: np.array(v[0]) for k, v in jparams["segments"][1].items()}
    rng = np.random.default_rng(seed)
    layer["ln_kv"] = (0.1 * rng.standard_normal(layer["ln_kv"].shape)
                      ).astype(np.float32)
    return layer


def _close(got, want, tol=TOL, what=""):
    want = _np(want)
    err = float(np.abs(_np(got) - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


# --------------------------------------------- mirror of test_mla_absorb
def test_mla_absorbed_decode_matches_expand():
    _, cfg32 = _cfgs()
    params = T.init_params(cfg32, seed=0, device="cpu")
    B, P = 2, 12
    toks = torch.randint(0, cfg32.vocab_size, (B, P),
                         generator=torch.Generator().manual_seed(1))
    logits, caches, length = T.prefill(params, cfg32, toks, cache_len=P + 4)
    nxt = torch.argmax(logits, dim=-1)
    copy = [{k: v.clone() for k, v in seg.items()} for seg in caches]
    l_exp, c_exp, _ = T.decode_step(params, caches, length, cfg32, nxt)
    l_abs, c_abs, _ = T.decode_step(params, copy, length,
                                    _cfgs(absorb=True)[1], nxt)
    torch.testing.assert_close(l_abs, l_exp, rtol=2e-4, atol=2e-4)
    for a, b in zip(c_abs, c_exp):
        for name in a:
            torch.testing.assert_close(a[name], b[name], rtol=2e-4,
                                       atol=2e-4)


# ------------------------------------------------------ the mixer vs JAX
@pytest.mark.parametrize("mode,absorb", [("prefill", False),
                                         ("train", False),
                                         ("decode", False),
                                         ("decode", True)])
def test_mla_mixer_matches_jax(mode, absorb):
    jcfg, cfg = _cfgs(absorb)
    layer = _layer()
    jp = {k: jnp.asarray(v) for k, v in layer.items()}
    p = {k: torch.from_numpy(v) for k, v in layer.items()}
    rng = np.random.default_rng(5)
    B, S, T_len, length = 2, 12, 16, 9
    S_in = 1 if mode == "decode" else S
    h = rng.standard_normal((B, S_in, cfg.d_model)).astype(np.float32)
    # a decode cache holding `length` earlier positions (slots past it
    # zero), a prefill cache zero
    ckv = np.zeros((B, T_len, cfg.mla_kv_lora), np.float32)
    krope = np.zeros((B, T_len, cfg.mla_rope_dim), np.float32)
    if mode == "decode":
        ckv[:, :length] = rng.standard_normal((B, length, cfg.mla_kv_lora))
        krope[:, :length] = rng.standard_normal((B, length,
                                                 cfg.mla_rope_dim))
    jcache = {"ckv": jnp.asarray(ckv), "krope": jnp.asarray(krope)}
    cache = {"ckv": torch.from_numpy(ckv.copy()),
             "krope": torch.from_numpy(krope.copy())}
    n = length if mode == "decode" else None
    want, jnew = JT._mla_mixer(jp, jnp.asarray(h), jcfg, RULES, mode,
                               jcache if mode != "train" else None,
                               jnp.int32(length) if n else None)
    ctx = TP(None, cfg)  # one rank holding everything: the plain mixer
    got = T._mla_mixer(p, torch.from_numpy(h), cfg, ctx,
                       ctx.specs(("mla", "dense")), "dp", mode,
                       cache if mode != "train" else None, n, None)
    _close(got, want, what="y")
    if mode != "train":
        for name in ("ckv", "krope"):
            _close(cache[name], jnew[name], what=name)


def test_mla_model_matches_jax():
    """Prefill, 4 expanded and 4 absorbed decode steps of the whole smoke
    model (an MLA + dense layer, an MLA + MoE layer) on JAX's weights,
    within 1e-4 max|logits|, the LM tests' float32 tolerance."""
    jcfg, cfg = _cfgs()
    jparams = JT.init_params(jax.random.PRNGKey(3), jcfg)
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             (2, 20)).astype(np.int32)
    jl, jc, jn = JT.prefill(jparams, jcfg, RULES, tokens=jnp.asarray(toks),
                            cache_len=28)
    logits, caches, n = T.prefill(params, cfg, torch.from_numpy(toks),
                                  cache_len=28)
    _close(logits, jl, 1e-4, "prefill")
    for absorb in (False, True):
        jcfg_d, cfg_d = _cfgs(absorb)
        for step in range(4):
            jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
            jl, jc, jn = JT.decode_step(jparams, jc, jn, jcfg_d, RULES,
                                        tokens=jtok)
            logits, caches, n = T.decode_step(
                params, caches, n, cfg_d, torch.from_numpy(np.array(jtok)))
            _close(logits, jl, 1e-4, f"decode absorb={absorb} {step}")
    for seg, jseg in zip(caches, jc):
        for name in ("ckv", "krope"):
            _close(seg[name], jseg[name], 1e-4, name)


# ---------------------------------------------------- attend with Dv != Dk
@pytest.mark.parametrize("S,Dk,Dv,window", [
    (40, 24, 16, 0),     # MLA's shape at smoke width: V padded to Dk
    (40, 24, 16, 64),    # a window past the prompt: full causal too
    (48, 24, 16, 16),    # banded: the scan carries Dv
])
def test_attend_dv_matches_jax(S, Dk, Dv, window):
    B, H, KVH = 2, 4, 4
    rng = np.random.default_rng(S + Dk + Dv)
    arrays = [rng.standard_normal(shape).astype(np.float32) for shape in
              ((B, S, H, Dk), (B, S, KVH, Dk), (B, S, KVH, Dv),
               (B, S, H, Dv))]
    jq, jk, jv, jdo = map(jnp.asarray, arrays)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays[:3]]
    got = attention.attend(*leaves, window=window)
    want = jatt.attend(jq, jk, jv, window=window)
    assert got.shape == (B, S, H, Dv)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(arrays[3]))
    jgrads = jax.grad(
        lambda a, b, c: jnp.sum(jatt.attend(a, b, c, window=window) * jdo),
        argnums=(0, 1, 2))(jq, jk, jv)
    for g, w in zip(grads, jgrads):
        np.testing.assert_allclose(_np(g), _np(w), rtol=3e-5, atol=3e-5)


def test_full_causal_attend_refuses_a_v_wider_than_k():
    x = torch.randn(1, 16, 2, 8)
    with pytest.raises(ValueError, match="no wider"):
        attention.attend(x, x, torch.randn(1, 16, 2, 12))


def test_mla_prefill_routes_to_k7(monkeypatch):
    """The MLA prefill and training forward reach ``ops.flash_attention``
    once a layer, with V padded to K's width; decode never does."""
    calls = []
    real = attention.ops.flash_attention
    monkeypatch.setattr(attention.ops, "flash_attention",
                        lambda *a: calls.append(a) or real(*a))
    cfg = smoke_config(ARCH)
    params = T.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 10))
    logits, caches, n = T.prefill(params, cfg, toks, cache_len=12)
    assert len(calls) == cfg.num_layers
    qk = cfg.mla_nope_dim + cfg.mla_rope_dim
    for q, k, v in calls:
        assert q.shape[-1] == k.shape[-1] == v.shape[-1] == qk
        assert not v[..., cfg.mla_v_dim:].any()  # the zero padding
    T.decode_step(params, caches, n, cfg, logits.argmax(-1))
    assert len(calls) == cfg.num_layers
    T.forward(params, cfg, toks)
    assert len(calls) == 2 * cfg.num_layers
