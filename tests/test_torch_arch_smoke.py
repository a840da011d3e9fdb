"""Per-architecture smoke tests of the port, on the CPU: the mirror of
``tests/test_arch_smoke.py`` for every LM architecture, the recurrent
``rwkv6_3b`` and ``recurrentgemma_9b`` included, plus each one's logits
held against the JAX package's on the same weights.

Mirrored: forward, loss and finite gradients; prefill then a decode step;
decode against the prefill continuation (the JAX test's 5e-2: the smoke
configs are bf16, and a MoE decode step of 2 tokens has capacity 1, so
it may drop what the longer prefill keeps).  Against JAX, in float32 with
JAX's parameters (``convert.lm_params_from_jax``): forward logits,
prefill logits and 3 decode steps within 1e-4 max|logits|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.distributed import MeshRules
from repro.models import transformer as JT
from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import transformer as T

RULES = MeshRules(mesh=None)
LM_ARCHS = [a for a in ARCH_IDS if a != "logreg_paper"]
B, S = 2, 32


def make_batch(cfg, seed=1):
    gen = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    if cfg.frontend == "embeddings":
        return {"embeds": torch.randn((B, S, cfg.d_model), generator=gen),
                "labels": labels}
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                    generator=gen), "labels": labels}


def _inputs(batch):
    return ({"embeds": batch["embeds"]} if "embeds" in batch else
            {"tokens": batch["tokens"]})


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_and_loss(arch):
    cfg = smoke_config(arch)
    params = T.init_params(cfg, seed=0, device="cpu")
    batch = make_batch(cfg)
    logits, aux = T.forward(params, cfg, batch.get("tokens"),
                            embeds=batch.get("embeds"))
    assert logits.shape == (B, S, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all()), arch
    assert (float(aux) > 0) == (cfg.moe_num_experts > 0)
    leaves = jax.tree.leaves(params)
    req = [p.detach().requires_grad_(True) for p in leaves]
    tree = jax.tree.unflatten(jax.tree.structure(params), req)
    loss, metrics = T.loss_fn(tree, batch, cfg)
    assert np.isfinite(float(loss.detach()))
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    assert all(g is None or bool(torch.isfinite(g.float()).all())
               for g in grads), arch
    assert sum(g is not None for g in grads) >= len(req) - 1  # all but embed


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_then_decode(arch):
    cfg = smoke_config(arch)
    params = T.init_params(cfg, seed=0, device="cpu")
    batch = make_batch(cfg)
    logits, cache, length = T.prefill(params, cfg, cache_len=S + 4,
                                      **_inputs(batch))
    assert logits.shape == (B, cfg.vocab_size)
    assert length == S
    if cfg.frontend == "embeddings":
        step_in = {"embeds": torch.ones((B, cfg.d_model))}
    else:
        step_in = {"tokens": torch.zeros((B,), dtype=torch.long)}
    logits2, cache2, length2 = T.decode_step(params, cache, length, cfg,
                                             **step_in)
    assert logits2.shape == (B, cfg.vocab_size)
    assert bool(torch.isfinite(logits2.float()).all()), arch
    assert length2 == S + 1


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_matches_prefill_continuation(arch):
    """KV-cache correctness: decoding token t yields the same logits as a
    fresh prefill over the first t+1 tokens (teacher forcing)."""
    cfg = smoke_config(arch)
    params = T.init_params(cfg, seed=2, device="cpu")
    gen = torch.Generator().manual_seed(3)
    S0 = 8
    if cfg.frontend == "embeddings":
        full = torch.randn((B, S0 + 1, cfg.d_model), generator=gen)
        pre, step, pre2 = ({"embeds": full[:, :S0]},
                           {"embeds": full[:, S0]}, {"embeds": full})
    else:
        full = torch.randint(0, cfg.vocab_size, (B, S0 + 1), generator=gen)
        pre, step, pre2 = ({"tokens": full[:, :S0]},
                           {"tokens": full[:, S0]}, {"tokens": full})
    _, cache, length = T.prefill(params, cfg, cache_len=S0 + 4, **pre)
    dec, _, _ = T.decode_step(params, cache, length, cfg, **step)
    ref, _, _ = T.prefill(params, cfg, cache_len=S0 + 5, **pre2)
    np.testing.assert_allclose(dec.float().numpy(), ref.float().numpy(),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_logits_match_jax(arch):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype_str="float32")
    cfg = dataclasses.replace(smoke_config(arch), dtype_str="float32")
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    batch = make_batch(cfg, seed=4)
    jin = {k: jnp.asarray(v.numpy()) for k, v in _inputs(batch).items()}

    def close(got, want, what):
        want = np.asarray(want, np.float32)
        err = float(np.abs(got.detach().float().numpy() - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), (arch, what, err)

    jl, jaux = JT.forward(jparams, jcfg, RULES, **jin)
    logits, aux = T.forward(params, cfg, batch.get("tokens"),
                            embeds=batch.get("embeds"))
    close(logits, jl, "forward")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-6)
    jl, jc, jn = JT.prefill(jparams, jcfg, RULES, cache_len=S + 3, **jin)
    logits, caches, n = T.prefill(params, cfg, cache_len=S + 3,
                                  **_inputs(batch))
    close(logits, jl, "prefill")
    rng = np.random.default_rng(5)
    for step in range(3):
        if cfg.frontend == "embeddings":
            e = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
            jstep, tstep = {"embeds": jnp.asarray(e)}, \
                {"embeds": torch.from_numpy(e)}
        else:
            t = np.array(jnp.argmax(jl, axis=-1).astype(jnp.int32))
            jstep, tstep = {"tokens": jnp.asarray(t)}, \
                {"tokens": torch.from_numpy(t)}
        jl, jc, jn = JT.decode_step(jparams, jc, jn, jcfg, RULES, **jstep)
        logits, caches, n = T.decode_step(params, caches, n, cfg, **tstep)
        close(logits, jl, f"decode {step}")


FAMILY_LEAVES = {
    "deepseek_v2_lite": {"router", "experts_w1", "experts_w3", "experts_w2",
                         "shared_w1", "shared_w3", "shared_w2", "wq_mla",
                         "wkv_a", "ln_kv", "wk_up", "wv_up"},
    "qwen3_moe_235b": {"router", "experts_w1", "experts_w3", "experts_w2"},
    "rwkv6_3b": {"rwkv_mu_r", "rwkv_mu_k", "rwkv_mu_v", "rwkv_mu_g",
                 "rwkv_mu_w", "rwkv_w_r", "rwkv_w_k", "rwkv_w_v", "rwkv_w_g",
                 "rwkv_w_o", "rwkv_w_decay_a", "rwkv_w_decay_b", "rwkv_w0",
                 "rwkv_u", "rwkv_mu_ck", "rwkv_mu_cr", "rwkv_w_ck",
                 "rwkv_w_cr", "rwkv_w_cv"},
    "recurrentgemma_9b": {"lru_in", "lru_gate", "lru_conv", "lru_conv_bias",
                          "lru_wr", "lru_wi", "lru_br", "lru_bi",
                          "lru_lambda", "lru_out"},
}


@pytest.mark.parametrize("arch", sorted(FAMILY_LEAVES))
def test_lm_params_from_jax_carries_moe_and_mla_leaves(arch):
    """Every leaf of a MoE, MLA, RWKV6 or RG-LRU parameter tree, bit for
    bit in bf16, under the JAX package's names; RG-LRU's ``lru_lambda``
    keeps its linspace."""
    jparams = JT.init_params(jax.random.PRNGKey(1), jax_smoke_config(arch))
    # nonzero stacked vectors (norms, token-shift mixes, gates), so their
    # bits are not all zero; lru_lambda is carried as drawn
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.5 if a.ndim == 2
        and path[-1].key != "lru_lambda" else a, jparams)
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    names = set().union(*(seg.keys() for seg in params["segments"]))
    assert FAMILY_LEAVES[arch] <= names
    for seg in params["segments"]:
        if "lru_lambda" in seg:
            want = np.asarray(jnp.linspace(
                1.0, 4.0, seg["lru_lambda"].shape[-1], dtype=jnp.bfloat16))
            for row in seg["lru_lambda"]:
                np.testing.assert_array_equal(row.view(torch.int16).numpy(),
                                              want.view(np.int16))
    for seg, jseg in zip(params["segments"], jparams["segments"]):
        assert seg.keys() == jseg.keys()
        for name, t in seg.items():
            a = np.asarray(jseg[name])
            assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16), err_msg=name)
