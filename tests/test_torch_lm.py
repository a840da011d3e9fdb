"""The port's LM serving path against the JAX package, on the CPU.

Layers, KV caches, attention (full-causal through K7's plain version,
banded, decode), parameter counts, and whole prefill + decode runs of
three smoke configs with the JAX package's own weights carried over by
``convert.lm_params_from_jax``.  Inputs are numpy arrays from a seed.

Tolerances: float32 runs hold logits within 1e-4 max|logits| and pick the
same greedy tokens; bfloat16 runs hold logits within 2e-2 max|logits|
(the two frameworks round bf16 at other places: each matmul's output,
the residual adds).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.distributed import MeshRules
from repro.models import attention as jatt
from repro.models import kvcache as jkv
from repro.models import layers as jlayers
from repro.models import transformer as JT
from repro.models.config import segments as jsegments
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve
from repro_torch.models import attention, kvcache, layers
from repro_torch.models import transformer as T

RULES = MeshRules(mesh=None)
LM_ARCHS = [a for a in ARCH_IDS if a != "logreg_paper"]
SERVED = ("qwen2_5_32b", "deepseek_7b", "h2o_danube3_4b")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a, dtype=torch.float32):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(dtype)


# ------------------------------------------------------------------ configs
def test_registry_matches_jax():
    assert ARCH_IDS == JAX_ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_jax(arch):
    """Every field of the full and the smoke config, dtype by name."""
    for mine, theirs in ((get_config(arch), jax_get_config(arch)),
                         (smoke_config(arch), jax_smoke_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert str(mine.dtype).removeprefix("torch.") == str(
            jnp.dtype(theirs.dtype))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_count_params_matches_jax(arch):
    for fn in (get_config, smoke_config):
        cfg = fn(arch)
        jcfg = (jax_get_config if fn is get_config else
                jax_smoke_config)(arch)
        assert T.count_params(cfg) == JT.count_params(jcfg)
        assert T.count_params(cfg, active_only=True) == JT.count_params(
            jcfg, active_only=True)
    assert get_config(arch).num_params() == jax_get_config(arch).num_params()


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layers_match_jax(dtype):
    rng = np.random.default_rng(0)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    jx, x = _pair(rng.standard_normal((2, 5, 3, 16)).astype(np.float32),
                  dtype)
    js, s = _pair(0.1 * rng.standard_normal(16).astype(np.float32), dtype)
    np.testing.assert_allclose(_np(layers.rms_norm(x, s)),
                               _np(jlayers.rms_norm(jx, js)),
                               rtol=tol, atol=tol)
    pos = np.array([0, 1, 7, 300, 4095], np.int32)
    jc, jsn = jlayers.rotary(jnp.asarray(pos), 16, 1e6)
    c, sn = layers.rotary(torch.from_numpy(pos), 16, 1e6)
    np.testing.assert_allclose(_np(c), _np(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(sn), _np(jsn), rtol=1e-6, atol=1e-6)
    out = layers.apply_rope(x, c, sn)
    assert out.dtype == dtype
    np.testing.assert_allclose(_np(out), _np(jlayers.apply_rope(jx, jc,
                                                                jsn)),
                               rtol=tol, atol=tol)
    jh, h = _pair(rng.standard_normal((2, 5, 16)).astype(np.float32), dtype)
    ws = [rng.standard_normal(sh).astype(np.float32) * 0.3
          for sh in ((16, 24), (16, 24), (24, 16))]
    jw, w = zip(*[_pair(a, dtype) for a in ws])
    np.testing.assert_allclose(_np(layers.swiglu(h, *w)),
                               _np(jlayers.swiglu(jh, *jw)),
                               rtol=5 * tol, atol=5 * tol)
    np.testing.assert_allclose(_np(layers.gelu_mlp(h, w[0], w[2])),
                               _np(jlayers.gelu_mlp(jh, jw[0], jw[2])),
                               rtol=5 * tol, atol=5 * tol)


# ------------------------------------------------------------------ kvcache
def test_kvcache_matches_jax():
    for T_slots in (1, 4, 7):
        for length in range(0, 20):
            np.testing.assert_array_equal(
                kvcache.ring_positions(length, T_slots).numpy(),
                np.asarray(jkv.ring_positions(jnp.int32(length), T_slots)))
    rng = np.random.default_rng(1)
    cache = rng.standard_normal((2, 5, 3, 4)).astype(np.float32)
    for length in (0, 3, 5, 12):
        tok = rng.standard_normal((2, 1, 3, 4)).astype(np.float32)
        want = jkv.write_token(jnp.asarray(cache), jnp.asarray(tok),
                               jnp.int32(length))
        got = kvcache.write_token(torch.from_numpy(cache.copy()),
                                  torch.from_numpy(tok), length)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # MLA's compressed cache; the recurrent states, the same size at 40
    # and at 524,288 tokens (RG-LRU's local layers keep a window's ring)
    for arch in SERVED + ("deepseek_v2_lite", "rwkv6_3b",
                          "recurrentgemma_9b"):
        cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
        long_len = 524_288 if arch in ("rwkv6_3b", "recurrentgemma_9b") \
            else 40
        for kind, n in jsegments(jcfg):
            for cache_len, jdt, dt in ((40, jnp.float32, torch.float32),
                                       (long_len, jnp.bfloat16,
                                        torch.bfloat16)):
                want = jax.eval_shape(lambda: jkv.init_segment_cache(
                    kind, n, 2, cache_len, jcfg, jdt))
                got = kvcache.init_segment_cache(kind, n, 2, cache_len, cfg,
                                                 dt)
                assert {k: (tuple(v.shape), str(v.dtype).removeprefix(
                    "torch.")) for k, v in got.items()} == {
                    k: (v.shape, str(v.dtype)) for k, v in want.items()}
                assert all(not v.any() for v in got.values())


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("S,H,KVH,window", [
    (40, 4, 2, 0),     # full causal: K7's plain version
    (40, 4, 2, 64),    # a window past the prompt: full causal too
    (2048, 4, 1, 16),  # banded: two q blocks of 1024, span 2048
    (48, 4, 2, 32),    # banded: one q block, the h2o prefill shape
])
def test_attend_matches_jax(S, H, KVH, window):
    rng = np.random.default_rng(S + window)
    D = 16
    jq, q = _pair(rng.standard_normal((2, S, H, D)).astype(np.float32))
    jk, k = _pair(rng.standard_normal((2, S, KVH, D)).astype(np.float32))
    jv, v = _pair(rng.standard_normal((2, S, KVH, D)).astype(np.float32))
    got = attention.attend(q, k, v, window=window)
    want = jatt.attend(jq, jk, jv, window=window)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("S,window", [(1100, 64), (2100, 2048)])
def test_attend_pads_a_ragged_banded_prompt(S, window):
    """A prompt past the window that is no multiple of the 1024-query
    block (JAX asserts one): the port's rows equal JAX's over the same
    prompt zero-padded to the block, the padding hidden by causality;
    (2100, 2048) is RecurrentGemma's past-the-window serving case."""
    rng = np.random.default_rng(S)
    Sp = -(-S // attention.Q_BLOCK) * attention.Q_BLOCK
    arrays = [rng.standard_normal((1, S, n, 16)).astype(np.float32)
              for n in (4, 1, 1)]
    got = attention.attend(*(torch.from_numpy(a) for a in arrays),
                           window=window)
    want = jatt.attend(*(jnp.asarray(np.pad(a, ((0, 0), (0, Sp - S), (0, 0),
                                                (0, 0)))) for a in arrays),
                       window=window)[:, :S]
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [100, 2048])
def test_attend_head_dim_256_matches_jax(window):
    """recurrentgemma's local attention: head_dim 256 and a window of at
    least S, which both packages run full-causal (the port through K7 and
    K8, JAX through its plain scan), forward and gradient."""
    B, S, H, KVH, D = 1, 100, 2, 1, 256
    rng = np.random.default_rng(window)
    arrays = [rng.standard_normal((B, S, n, D)).astype(np.float32)
              for n in (H, KVH, KVH, H)]
    (jq, q), (jk, k), (jv, v), (jdo, do) = (_pair(a) for a in arrays)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = attention.attend(*leaves, window=window)
    want = jatt.attend(jq, jk, jv, window=window)
    np.testing.assert_allclose(_np(got.detach()), _np(want), rtol=2e-5,
                               atol=2e-5)
    grads = torch.autograd.grad(got, leaves, do)
    jgrads = jax.grad(
        lambda a, b, c: jnp.sum(jatt.attend(a, b, c, window=window) * jdo),
        argnums=(0, 1, 2))(jq, jk, jv)
    for g, w in zip(grads, jgrads):
        np.testing.assert_allclose(_np(g), _np(w), rtol=3e-5, atol=3e-5)


def test_full_causal_attend_runs_k7(monkeypatch):
    """Full-causal attention goes to ``ops.flash_attention``; banded
    attention does not; Dv < Dk (MLA) goes to it with V zero-padded to
    Dk."""
    calls = []
    real = attention.ops.flash_attention
    monkeypatch.setattr(attention.ops, "flash_attention",
                        lambda *a: calls.append(a) or real(*a))
    x = torch.randn(1, 32, 2, 8)
    attention.attend(x, x, x)
    attention.attend(x, x, x, window=32)
    assert len(calls) == 2
    attention.attend(x, x, x, window=8)
    assert len(calls) == 2
    o = attention.attend(x, x, torch.randn(1, 32, 2, 4))
    assert len(calls) == 3 and o.shape == (1, 32, 2, 4)
    assert calls[-1][2].shape == x.shape and not calls[-1][2][..., 4:].any()


@pytest.mark.parametrize("T_slots,length,window", [
    (40, 17, 0),   # full cache, partly filled
    (8, 29, 8),    # ring, wrapped several times
    (8, 5, 8),     # ring, not yet full
])
def test_decode_attend_matches_jax(T_slots, length, window):
    rng = np.random.default_rng(T_slots + length)
    jq, q = _pair(rng.standard_normal((2, 1, 4, 16)).astype(np.float32))
    jk, k = _pair(rng.standard_normal((2, T_slots, 2, 16)).astype(
        np.float32))
    jv, v = _pair(rng.standard_normal((2, T_slots, 2, 16)).astype(
        np.float32))
    pos = length - 1
    got = attention.decode_attend(
        q, k, v, kvcache.ring_positions(length, T_slots), pos,
        window=window)
    want = jatt.decode_attend(jq, jk, jv,
                              jkv.ring_positions(jnp.int32(length), T_slots),
                              jnp.int32(pos), window=window)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


# ------------------------------------------------------- prefill and decode
def _jax_model(arch, dtype_str):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype_str=dtype_str)
    cfg = dataclasses.replace(smoke_config(arch), dtype_str=dtype_str)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    # nonzero norm gains and biases (both start at zero), so the run shows
    # the conversion carrying them
    rng = np.random.default_rng(2)

    def perturb(path, leaf):
        if path[-1].key not in ("ln1", "ln2", "final_norm", "bq", "bk", "bv"):
            return leaf
        return (leaf + 0.05 * rng.standard_normal(leaf.shape)).astype(
            leaf.dtype)

    jparams = jax.tree_util.tree_map_with_path(perturb, jparams)
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, cfg, jparams, params


@pytest.mark.parametrize("dtype_str", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,prompt", [
    ("qwen2_5_32b", 24),     # GQA, QKV bias
    ("deepseek_7b", 24),     # MHA
    ("h2o_danube3_4b", 48),  # SWA, window 32: banded prefill, ring roll
])
def test_prefill_decode_match_jax(arch, prompt, dtype_str):
    steps = 8
    jcfg, cfg, jparams, params = _jax_model(arch, dtype_str)
    cache_len = prompt + steps
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             (2, prompt)).astype(np.int32)
    jprefill = jax.jit(lambda p, t: JT.prefill(p, jcfg, RULES, tokens=t,
                                               cache_len=cache_len))
    jdecode = jax.jit(lambda p, c, n, t: JT.decode_step(p, c, n, jcfg,
                                                        RULES, tokens=t))
    f32 = dtype_str == "float32"
    rtol = 1e-4 if f32 else 2e-2

    def close(got, want, what):
        want = _np(want)
        err = float(np.abs(_np(got) - want).max())
        assert err <= rtol * float(np.abs(want).max()), (what, err)

    jl, jc, jn = jprefill(jparams, jnp.asarray(toks))
    logits, caches, length = T.prefill(params, cfg, torch.from_numpy(toks),
                                       cache_len=cache_len)
    assert length == int(jn) == prompt
    close(logits, jl, "prefill logits")
    for seg, jseg in zip(caches, jc):
        for name in ("k", "v"):
            close(seg[name], jseg[name], f"prefill cache {name}")
    for step in range(steps):
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        tok = torch.argmax(logits, dim=-1)
        if f32:
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        # both packages continue from the JAX package's tokens
        jl, jc, jn = jdecode(jparams, jc, jn, jtok)
        logits, caches, length = T.decode_step(
            params, caches, length, cfg, torch.from_numpy(np.array(jtok)))
        assert length == int(jn)
        close(logits, jl, f"decode step {step} logits")
    if arch == "h2o_danube3_4b":
        assert caches[0]["k"].shape[2] == cfg.window  # a ring, wrapped
        assert length > prompt > cfg.window


def test_forward_matches_jax():
    jcfg, cfg, jparams, params = _jax_model("qwen2_5_32b", "float32")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             (2, 20)).astype(np.int32)
    want, want_aux = JT.forward(jparams, jcfg, RULES,
                                tokens=jnp.asarray(toks))
    got, aux = T.forward(params, cfg, torch.from_numpy(toks))
    assert got.shape == (2, 20, cfg.vocab_size)
    assert aux.dtype == torch.float32 and float(aux) == float(want_aux)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=1e-4 * float(np.abs(_np(want)).max()))


def test_lm_params_from_jax_keeps_the_bits():
    jcfg = jax_smoke_config("qwen2_5_32b")
    jparams = JT.init_params(jax.random.PRNGKey(1), jcfg)
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    jleaves, jdef = jax.tree.flatten(jparams)
    leaves = jax.tree.leaves(params, is_leaf=lambda x: isinstance(
        x, torch.Tensor))
    assert len(leaves) == len(jleaves)
    assert len(params["segments"]) == len(jparams["segments"])
    for t, a in zip(leaves, jleaves):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(),
            np.asarray(a).view(np.int16))


def test_init_params_shapes_and_seed():
    cfg = smoke_config("qwen2_5_32b")
    a = T.init_params(cfg, seed=0, device="cpu")
    b = T.init_params(cfg, seed=0, device="cpu")
    jshapes = jax.tree.map(lambda x: x.shape, JT.abstract_params(
        jax_smoke_config("qwen2_5_32b")))
    shapes = jax.tree.map(lambda x: tuple(x.shape), a,
                          is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert shapes == jax.tree.map(tuple, jshapes,
                                  is_leaf=lambda x: isinstance(x, tuple))
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert torch.equal(x, y)
    w = a["segments"][0]["w1"].float()
    std = min(0.02, cfg.d_model**-0.5)
    assert float(w.abs().max()) <= 3 * std * 1.01
    # a unit normal cut at +-3 has standard deviation 0.9866
    assert abs(float(w.std()) / std - 0.9866) < 0.02
    assert not a["segments"][0]["ln1"].any()


def test_serve_driver_batched_decode():
    """As ``tests/test_train_serve.py`` checks the JAX driver."""
    rep = serve.main([
        "--arch", "h2o_danube3_4b", "--requests", "5", "--batch", "2",
        "--prompt-len", "16", "--new-tokens", "4", "--device", "cpu",
    ])
    assert rep["tokens_generated"] == 5 * 4
    assert len(rep["sample_output"]) == 4
    assert rep["batches"] == 3 and rep["decode_steps"] == 3 * 3
    assert rep["nonfinite_logits"] == 0
