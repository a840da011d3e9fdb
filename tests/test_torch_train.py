"""The port's LM training path and training CLI against the JAX package,
on the CPU.

``loss_fn`` (value, aux loss and every leaf's gradient, through K7/K8's
plain versions on the full-causal layers and autograd of the banded scan
on H2O's) on the smoke configs of the dense, recurrent, MoE, MLA and
embeddings families with JAX's weights; remat; ``train_step``
against the JAX driver's loop (per-institution ``value_and_grad``, the
mean, ``adamw_update``), plain and under Shamir aggregation; the CLI
cases of ``tests/test_train_serve.py``; ``load_study``'s shapes.

Tolerances: in float32 the loss within 1e-5 relative and each leaf's
gradient within 1e-4 max|g| of that leaf; in bf16 2e-2 (the two
frameworks round bf16 at other places).  The recurrent families' bf16
gradients carry more bf16 noise than that on a few leaves: both
packages' bf16 gradients of RG-LRU's ``lru_lambda`` and ``lru_wr`` lie
1.3-2.4% of max|g| from the float32 gradient at the same weights, and so
up to 2.8% from each other; such a leaf is held instead to be no farther
from the float32 gradient than twice the JAX package's bf16 gradient is
(the port's measured at most 1.19 times as far, on every leaf).
Secure mean gradients within S * 2**-28 of the plain mean (fixed-point
quantization of S addends).
Parameters after three ``train_step`` calls within 1e-6 of the JAX loop's
in float32, with AdamW's eps at 1e-3 in both: AdamW with its default eps
(1e-8) divides each first-step gradient by its own magnitude, so float32
summation noise in a tiny gradient becomes a +-lr difference in that
entry (5.4e-4 measured at lr 1e-2); eps 1e-3 keeps the update Lipschitz
in the gradient.  AdamW itself is held to JAX at its defaults on the same
gradients in ``tests/test_torch_optim.py``.
"""
import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.secure_agg import SecureAggregator
from repro.data import datasets as jdatasets
from repro.distributed import MeshRules
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.core.collective import SecureCollective
from repro_torch.core.flatbuf import tree_flatten, tree_unflatten
from repro_torch.data import STUDIES, load_study
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init

RULES = MeshRules(mesh=None)
QUANT = 2.0**-28
# train_step against the JAX loop: an AdamW eps that keeps the update
# Lipschitz in the gradient (see the module docstring)
EPS = 1e-3
RECURRENT = ("rwkv6_3b", "recurrentgemma_9b")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _model(arch, dtype_str, seed=0):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype_str=dtype_str)
    cfg = dataclasses.replace(smoke_config(arch), dtype_str=dtype_str)
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(2)

    def perturb(path, leaf):  # nonzero norm gains and biases
        if path[-1].key not in ("ln1", "ln2", "final_norm", "bq", "bk", "bv"):
            return leaf
        return (leaf + 0.05 * rng.standard_normal(leaf.shape)).astype(
            leaf.dtype)

    jparams = jax.tree_util.tree_map_with_path(perturb, jparams)
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, cfg, jparams, params


def _batch(vocab, B, S, seed, masked=True):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    tokens, labels = toks[:, :-1].astype(np.int32), toks[:, 1:].astype(
        np.int32)
    if masked:
        labels[0, :3] = -1  # the label mask: positions that count nothing
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(tokens).long(),
             "labels": torch.from_numpy(labels).long()})


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(jcfg):
    return jax.jit(lambda p, b: jax.value_and_grad(JT.loss_fn, has_aux=True)(
        p, b, jcfg, RULES))


def _grads(params, batch, cfg):
    leaves, treedef = tree_flatten(params)
    req = [p.detach().requires_grad_(True) for p in leaves]
    loss, aux = T.loss_fn(tree_unflatten(treedef, req), batch, cfg)
    return loss, aux, torch.autograd.grad(loss, req,
                                          materialize_grads=True)


def _frames(batch, d, seed):
    """``batch`` with seeded standard normal frames (B, S, d) in place of
    its tokens (the ``embeddings`` frontend), as (JAX, port) batches."""
    jb, b = batch
    B, S = b["labels"].shape
    e = np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)
    return ({"embeds": jnp.asarray(e), "labels": jb["labels"]},
            {"embeds": torch.from_numpy(e), "labels": b["labels"]})


@pytest.mark.parametrize("dtype_str", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2_5_32b", "deepseek_7b",
                                  "h2o_danube3_4b", "rwkv6_3b",
                                  "recurrentgemma_9b", "deepseek_v2_lite",
                                  "qwen3_moe_235b", "musicgen_medium",
                                  "qwen2_72b", "llava_next_34b"])
def test_loss_fn_matches_jax(arch, dtype_str):
    """48 tokens: past the h2o and recurrentgemma windows (32), so their
    banded scans run; the recurrent mixers' loops run 48 steps.  Every LM
    arch of the registry: the MoE families' aux loss (nonzero) against
    JAX's; the embeddings frontend (MusicGen, LLaVA-NeXT) takes seeded
    frames through ``embeds=`` and its token table gets a zero gradient,
    as ``jax.grad`` gives it."""
    jcfg, cfg, jparams, params = _model(arch, dtype_str)
    jb, b = _batch(cfg.vocab_size, 2, 48, seed=5)
    if cfg.frontend == "embeddings":
        jb, b = _frames((jb, b), cfg.d_model, seed=7)
    (jloss, jaux), jgrads = _jax_value_and_grad(jcfg)(jparams, jb)
    loss, aux, grads = _grads(params, b, cfg)
    f32 = dtype_str == "float32"
    tol = 1e-4 if f32 else 2e-2
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5 if f32 else 2e-2)
    np.testing.assert_allclose(float(aux["ce"].detach()), float(jaux["ce"]),
                               rtol=1e-5 if f32 else 2e-2)
    if cfg.moe_num_experts:
        assert float(jaux["aux"]) > 0.0
        np.testing.assert_allclose(float(aux["aux"].detach()),
                                   float(jaux["aux"]),
                                   rtol=1e-5 if f32 else 2e-2)
    else:
        assert float(aux["aux"]) == float(jaux["aux"]) == 0.0
    if cfg.frontend == "embeddings":
        i = next(i for i, leaf in enumerate(tree_flatten(params)[0])
                 if leaf is params["embed"])
        assert not bool(grads[i].any())
        assert not np.any(_np(jax.tree.leaves(jgrads)[i]))
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    truth = [None] * len(jleaves)
    if not f32 and arch in RECURRENT:
        # the float32 gradient at the same (bf16) weights: the JAX
        # package's own bf16 noise on a leaf
        j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
        _, jg32 = _jax_value_and_grad(dataclasses.replace(
            jcfg, dtype_str="float32"))(j32, jb)
        truth = jax.tree.leaves(jg32)
    for g, jg, t in zip(grads, jleaves, truth):
        assert g.dtype == cfg.dtype and tuple(g.shape) == jg.shape
        want = _np(jg)
        err = float(np.abs(_np(g) - want).max())
        if t is not None and err > tol * float(np.abs(want).max()):
            # a leaf whose two bf16 gradients differ by more than 2e-2:
            # the port's no farther from the float32 gradient than twice
            # the JAX package's bf16 gradient is
            t = _np(t)
            assert float(np.abs(_np(g) - t).max()) <= 2 * float(
                np.abs(want - t).max()), err
            continue
        assert err <= tol * float(np.abs(want).max()) + 1e-12, err
    if arch == "h2o_danube3_4b":
        assert cfg.window < 48


def test_forward_returns_aux_and_remat_changes_nothing():
    """``forward`` returns (logits, aux); with remat on, each block's
    forward re-runs in the backward (K7 twice per layer) and the grads
    equal remat-off's exactly."""
    _, cfg, _, params = _model("qwen2_5_32b", "float32")
    _, b = _batch(cfg.vocab_size, 2, 24, seed=6)
    logits, aux = T.forward(params, cfg, b["tokens"])
    assert logits.shape == (2, 24, cfg.vocab_size) and float(aux) == 0.0
    from repro_torch.kernels import flash_attention as k7

    calls = []
    real = k7.flash_attention_kernel

    def counting(*a):
        calls.append(1)
        return real(*a)

    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        calls.clear()
        k7.flash_attention_kernel = counting
        try:
            out[remat] = _grads(params, b, c)
        finally:
            k7.flash_attention_kernel = real
        assert len(calls) == cfg.num_layers * (2 if remat else 1)
    assert torch.equal(out[True][0], out[False][0])
    for g1, g0 in zip(out[True][2], out[False][2]):
        assert torch.equal(g1, g0)


def _jax_loop(jcfg, jparams, jbatches, steps, secure):
    """The JAX driver's loop body: per-institution grads, the mean (plain
    float32 sum / S, or ``secure_round_batched``), ``adamw_update``."""
    vg = _jax_value_and_grad(jcfg)
    jopt = jadamw.AdamWConfig(lr=1e-2, eps=EPS, warmup_steps=2)
    js = jadamw.adamw_init(jparams)
    agg = SecureAggregator(backend="pallas", overflow_check=True)
    key = jax.random.PRNGKey(0)
    means, losses = [], []
    for step in range(steps):
        per = [vg(jparams, b) for b in jbatches[step]]
        losses.append(sum(float(l) for (l, _), _ in per) / len(per))
        grads = [g for _, g in per]
        if secure:
            key, kk = jax.random.split(key)
            stacked = jax.tree.map(lambda *gs: jnp.stack(gs), *grads)
            summed = agg.secure_round_batched(kk, stacked, dtype=jnp.float32)
            mean = jax.tree.map(lambda x: (x / len(per)).astype(jnp.float32),
                                summed)
        else:
            mean = jax.tree.map(
                lambda *gs: sum(g.astype(jnp.float32) for g in gs)
                / len(per), *grads)
        means.append(mean)
        jparams, js, _ = jadamw.adamw_update(mean, js, jparams, jopt)
    return jparams, means, losses


@pytest.mark.parametrize("arch,secure", [
    ("qwen2_5_32b", False), ("qwen2_5_32b", True),
    ("deepseek_v2_lite", False), ("deepseek_v2_lite", True),
    ("qwen3_moe_235b", False), ("rwkv6_3b", False),
    ("recurrentgemma_9b", False)],
    ids=["plain", "shamir", "deepseek_v2_lite-plain",
         "deepseek_v2_lite-shamir", "qwen3_moe_235b-plain",
         "rwkv6_3b-plain", "recurrentgemma_9b-plain"])
def test_train_step_matches_jax_loop(arch, secure):
    """Three steps of two institutions; DeepSeek-V2-Lite's smoke config
    (MLA, a dense layer, then MoE with a shared expert) and Qwen3-MoE's
    add their aux loss and train through the capacity gather; RWKV6 and
    RecurrentGemma through their recurrences' loops."""
    jcfg, cfg, jparams, params = _model(arch, "float32", seed=1)
    steps, S = 3, 2
    batches = [[_batch(cfg.vocab_size, 1, 16, seed=10 * s + j,
                       masked=False) for j in range(S)]
               for s in range(steps)]
    want_params, want_means, want_losses = _jax_loop(
        jcfg, jparams, [[b[0] for b in bs] for bs in batches], steps, secure)
    agg = SecureCollective(backend="kernel", overflow_check=True) \
        if secure else None
    opt = AdamWConfig(lr=1e-2, eps=EPS, warmup_steps=2)
    st = adamw_init(params)
    for step in range(steps):
        inst = [b[1] for b in batches[step]]
        gen = SecureCollective.round_key(0, step, "cpu") if secure else None
        if step == 0:
            loss, mean, nbytes = train.mean_gradients(params, inst, cfg,
                                                      agg, gen)
            for g, jg in zip(tree_flatten(mean)[0],
                             jax.tree.leaves(want_means[0])):
                assert g.dtype == torch.float32
                want = _np(jg)
                err = float(np.abs(_np(g) - want).max())
                assert err <= 1e-4 * float(np.abs(want).max()) + S * QUANT
            if secure:  # the secure mean vs the port's own plain mean
                _, plain, _ = train.mean_gradients(params, inst, cfg)
                for g, p in zip(tree_flatten(mean)[0],
                                tree_flatten(plain)[0]):
                    assert float((g - p).abs().max()) <= S * QUANT
                n = T.count_params(cfg)
                rows = math.ceil(math.ceil(n / 128) / 8) * 8
                assert nbytes == S * 3 * 2 * rows * 128 * 4
            else:
                assert nbytes == 0
        params, st, m = train.train_step(params, st, inst, cfg, opt, agg,
                                         gen)
        np.testing.assert_allclose(m["loss"], want_losses[step], rtol=1e-5)
    assert int(st.step) == steps
    for got, want in zip(tree_flatten(params)[0],
                         jax.tree.leaves(want_params)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-6)


def test_corpus_is_fixed_and_cycles():
    a = train.corpus_batch(0, 1, 4, 8, 100, "cpu")
    b = train.corpus_batch(0, 5, 4, 8, 100, "cpu")
    c = train.corpus_batch(0, 2, 4, 8, 100, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert int(a["tokens"].max()) < 100 and int(a["tokens"].min()) >= 0


def test_corpus_draws_embeddings_for_the_embeddings_frontend():
    a = train.corpus_batch(0, 1, 4, 8, 100, "cpu", embed_dim=16)
    b = train.corpus_batch(0, 5, 4, 8, 100, "cpu", embed_dim=16)
    assert "tokens" not in a and a["embeds"].shape == (4, 8, 16)
    assert a["embeds"].dtype == torch.bfloat16
    assert torch.equal(a["embeds"], b["embeds"])  # the corpus cycles
    tok = train.corpus_batch(0, 1, 4, 8, 100, "cpu")
    assert torch.equal(a["labels"], tok["labels"])
    assert abs(float(a["embeds"].float().std()) - 1.0) < 0.2


@pytest.mark.parametrize("arch", ["musicgen_medium", "deepseek_v2_lite",
                                  "qwen3_moe_235b", "rwkv6_3b",
                                  "recurrentgemma_9b"])
def test_lm_driver_trains_the_moe_mla_and_embeddings_families(arch):
    """Two steps of the smoke config through the CLI, finite losses (the
    embeddings frontend draws its frames; MoE adds its aux loss; the
    recurrent families backpropagate through their loops)."""
    rep = train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch",
                      "4", "--seq-len", "16", "--device", "cpu"])
    assert rep["steps"] == 2 and len(rep["losses"]) == 2
    assert all(np.isfinite(rep["losses"]))


# ---------------------------------------------------------------------- CLI
@pytest.mark.parametrize("arch", ["qwen2_5_32b", "rwkv6_3b"])
def test_lm_driver_secure_agg_loss_decreases(tmp_path, arch):
    """As the JAX test (which trains rwkv6_3b), and on a GQA arch."""
    out = tmp_path / "m.json"
    train.main([
        "--arch", arch, "--smoke", "--steps", "8",
        "--batch", "4", "--seq-len", "32", "--lr", "1e-2",
        "--secure-agg", "shamir", "--institutions", "2",
        "--out", str(out), "--device", "cpu",
    ])
    m = json.loads(out.read_text())
    assert m["loss_last"] < m["loss_first"]
    assert len(set(m["bytes_per_step"])) == 1 and m["bytes_per_step"][0] > 0


def test_lm_driver_checkpoint_resume(tmp_path):
    ck = tmp_path / "ck"
    args = ["--arch", "deepseek_7b", "--smoke", "--batch", "4",
            "--seq-len", "32", "--checkpoint-dir", str(ck),
            "--checkpoint-every", "3", "--device", "cpu"]
    train.main(args + ["--steps", "6"])
    assert any("0000000006" in s for s in sorted(p.name for p in
                                                  ck.iterdir()))
    out = tmp_path / "m.json"
    train.main(args + ["--steps", "9", "--resume", "--out", str(out)])
    assert json.loads(out.read_text())["steps"] == 3


def test_lm_driver_failure_injection():
    rep = train.main([
        "--arch", "qwen2_5_32b", "--smoke", "--steps", "4", "--batch", "4",
        "--seq-len", "32", "--institutions", "4", "--fail-at", "2",
        "--compress", "--device", "cpu",
    ])
    assert rep["steps"] == 4 and all(np.isfinite(rep["losses"]))


def test_logreg_driver_converges(tmp_path):
    out = tmp_path / "m.json"
    train.main(["--arch", "logreg_paper", "--study", "parkinsons.total",
                "--scale", "0.05", "--out", str(out), "--device", "cpu"])
    m = json.loads(out.read_text())
    assert m["converged"] and m["r2_vs_gold"] > 0.999999
    assert m["iterations"] <= 10


def test_load_study_matches_jax_shapes():
    """Same shapes and institution splits as the JAX package (other
    draws: a torch generator, seeded by crc32 of the name)."""
    assert STUDIES == jdatasets.STUDIES
    for name in STUDIES:
        mine = load_study(name, seed=0, scale=0.01, device="cpu")
        theirs = jdatasets.load_study(name, seed=0, scale=0.01)
        assert [tuple(X.shape) for X, _ in mine.parts] == [
            X.shape for X, _ in theirs.parts]
        assert [tuple(y.shape) for _, y in mine.parts] == [
            y.shape for _, y in theirs.parts]
        assert mine.num_samples == theirs.num_samples
        X, y = mine.pooled()
        assert X.dtype == y.dtype == torch.float64
        assert bool((X[:, 0] == 1.0).all()) and set(y.unique().tolist()) \
            <= {0.0, 1.0}
        again = load_study(name, seed=0, scale=0.01, device="cpu")
        assert torch.equal(again.pooled()[0], X)
    motor = load_study("parkinsons.motor", scale=0.01, device="cpu")
    total = load_study("parkinsons.total", scale=0.01, device="cpu")
    assert torch.equal(motor.pooled()[0], total.pooled()[0])
    assert not torch.equal(motor.pooled()[1], total.pooled()[1])
