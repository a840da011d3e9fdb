"""AdamW, gradient compression and checkpoints on the port against the JAX
package, on the CPU.

Tolerances: AdamW holds float32 parameters within 1e-6 relative and
bfloat16 parameters within one bf16 unit in the last place of JAX's
(both packages run the same float32 operations in the same order; XLA
may fuse some of them); grad norm and lr within 1e-6 relative.
Checkpoints are exact: the npz keys are JAX's, and values survive a round
trip bit for bit (bf16 through float32).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import load_pytree as jload_pytree
from repro.checkpoint import save_pytree as jsave_pytree
from repro.configs import smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.optim import compression as jcompression
from repro_torch.checkpoint import CheckpointManager, load_pytree, \
    save_pytree
from repro_torch.configs import smoke_config
from repro_torch.convert import adamw_state_from_jax, lm_params_from_jax
from repro_torch.core.flatbuf import tree_flatten
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, AdamWState, adamw_init, \
    adamw_update, compression, init_error_feedback


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tree_np(rng, dtype):
    return {"embed": rng.standard_normal((6, 4)).astype(dtype),
            "final_norm": rng.standard_normal(4).astype(dtype),
            "segments": [{"w1": rng.standard_normal((2, 4, 5)).astype(dtype),
                          "ln1": rng.standard_normal((2, 4)).astype(dtype)}]}


def _to_torch(tree, dtype):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)).to(dtype),
                        tree)


def _to_jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_matches_jax(dtype):
    """Three steps on the same gradients: the first clipped (norm > 1),
    the warm-up ramp (2 steps) and the bias corrections in play."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    rng = np.random.default_rng(0)
    p_np = _tree_np(rng, np.float32)
    grads_np = [jax.tree.map(lambda a: (a * s).astype(np.float32),
                             _tree_np(rng, np.float32))
                for s in (3.0, 0.05, 0.2)]
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2)
    jcfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2)
    jp = _to_jax(p_np, jdt)
    js = jadamw.adamw_init(jp)
    p = _to_torch(p_np, dtype)
    st = adamw_init(p)
    for g_np in grads_np:
        jp, js, jm = jadamw.adamw_update(_to_jax(g_np, jnp.float32), js, jp,
                                         jcfg)
        p, st, m = adamw_update(_to_torch(g_np, torch.float32), st, p, cfg)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(st.step) == int(js.step) == 3 and st.step.dtype == torch.int32
    for got, want in zip(tree_flatten(p)[0], jax.tree.leaves(jp)):
        assert got.dtype == dtype
        w = _np(want)
        if dtype == torch.float32:
            np.testing.assert_allclose(_np(got), w, rtol=1e-6, atol=1e-7)
        else:  # one bf16 ulp: 2**(exponent - 7)
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30)))
                          - 7)
            assert bool((np.abs(_np(got) - w) <= ulp).all())
    for got, want in zip(tree_flatten(st.mu)[0] + tree_flatten(st.nu)[0],
                         jax.tree.leaves(js.mu) + jax.tree.leaves(js.nu)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5,
                                   atol=1e-8)


def test_adamw_updates_in_place_and_without_clip():
    rng = np.random.default_rng(1)
    p = _to_torch(_tree_np(rng, np.float32), torch.float32)
    st = adamw_init(p)
    leaf = p["embed"]
    g = _to_torch(_tree_np(rng, np.float32), torch.float32)
    out, st2, m = adamw_update(g, st, p, AdamWConfig(grad_clip=0.0))
    assert out["embed"] is leaf and st2.mu["embed"] is st.mu["embed"]
    assert float(m["grad_norm"]) > 1.0  # not clipped: grad_clip=0
    assert isinstance(st2, AdamWState) and int(st2.step) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_update_in_pieces_is_bit_identical(monkeypatch, dtype):
    """A leaf larger than ``UPDATE_CHUNK`` is updated a slice of its flat
    view at a time (ragged last slice here: 20 and 24 elements in pieces
    of 7); three steps give the parameters and moments of the whole-leaf
    update bit for bit.  A leaf that is not contiguous (a transposed
    view) is updated whole, in place."""
    from repro_torch.optim import adamw as adamw_mod

    rng = np.random.default_rng(3)
    tree = _tree_np(rng, np.float32)
    grads = [_to_torch(_tree_np(rng, np.float32), torch.float32)
             for _ in range(3)]
    out = {}
    for chunk in (adamw_mod.UPDATE_CHUNK, 7):
        monkeypatch.setattr(adamw_mod, "UPDATE_CHUNK", chunk)
        p = _to_torch(tree, dtype)
        p["embed"] = p["embed"].t().contiguous().t()  # (6, 4), strided
        leaf = p["segments"][0]["w1"]
        st = adamw_init(p)
        for g in grads:
            p, st, _ = adamw_update(g, st, p, AdamWConfig(warmup_steps=2))
        assert p["segments"][0]["w1"] is leaf
        assert not p["embed"].is_contiguous()
        out[chunk] = [t.clone() for t in
                      tree_flatten((p, st.mu, st.nu))[0]]
    whole, pieces = out.values()
    for a, b in zip(whole, pieces):
        assert torch.equal(a, b)


def test_compression_matches_jax():
    g = np.random.default_rng(2).standard_normal((7, 5)).astype(np.float32)
    q, scale, resid = compression._quantize(torch.from_numpy(g))
    jq, jscale, jresid = jcompression._quantize(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-7)
    np.testing.assert_allclose(resid.numpy(), np.asarray(jresid), rtol=1e-6,
                               atol=1e-7)
    fb = init_error_feedback({"a": torch.ones(3, dtype=torch.bfloat16),
                              "b": [torch.ones(2, 2)]})
    assert fb["a"].dtype == torch.float32 and not fb["b"][0].any()


# -------------------------------------------------------------- checkpoints
def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 4), generator=g),
            "b": {"c": torch.arange(6, dtype=torch.int32),
                  "d": torch.randn((3,), generator=g).to(torch.bfloat16)}}


def test_save_load_roundtrip_bf16(tmp_path):
    tree = _tree(0)
    path = str(tmp_path / "t.npz")
    save_pytree(tree, path)
    out = load_pytree(tree, path)
    for a, b in zip(tree_flatten(out)[0], tree_flatten(tree)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with np.load(path) as data:
        assert sorted(data.files) == ["a", "b||c", "b||d"]
        assert data["b||d"].dtype == np.float32


def test_checkpoint_manager_retention_and_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), retain=2)
    trees = {}
    for step in (1, 2, 3, 4):
        trees[step] = _tree(step)
        mgr.save(step, trees[step])
    assert mgr.steps() == [3, 4]
    restored, step = mgr.restore(trees[4])
    assert step == 4 and torch.equal(restored["a"], trees[4]["a"])
    assert CheckpointManager(str(tmp_path / "empty")).restore(
        trees[4]) == (None, None)


def test_checkpoint_manager_async_writes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), retain=3, async_writes=True)
    t = _tree(7)
    want = t["a"].clone()
    mgr.save(7, t)
    t["a"].add_(1.0)  # the step goes on in place: the save holds a copy
    mgr.close()
    restored, step = mgr.restore(t)
    assert step == 7 and torch.equal(restored["a"], want)


def _jax_train_state():
    """The smoke config's JAX params and an AdamW state one step in."""
    jcfg = jax_smoke_config("qwen2_5_32b")
    jparams = JT.init_params(jax.random.PRNGKey(3), jcfg)
    js = jadamw.adamw_init(jparams)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, jnp.float32),
                         jparams)
    jparams, js, _ = jadamw.adamw_update(grads, js, jparams,
                                         jadamw.AdamWConfig())
    return jparams, js


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jparams, js = _jax_train_state()
    JCheckpointManager(str(tmp_path)).save(5, {"params": jparams,
                                               "opt": js})
    cfg = smoke_config("qwen2_5_32b")
    params = T.init_params(cfg, seed=0, device="cpu")
    template = {"params": params, "opt": adamw_init(params)}
    state, step = CheckpointManager(str(tmp_path)).restore(template)
    assert step == 5
    want_p = lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    want_s = adamw_state_from_jax(jax.tree.map(np.asarray, tuple(js)),
                                  device="cpu")
    assert isinstance(state["opt"], AdamWState)
    assert int(state["opt"].step) == 1 == int(want_s.step)
    for got, want in zip(tree_flatten(state)[0],
                         tree_flatten({"params": want_p, "opt": want_s})[0]):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_port_checkpoint_restores_into_jax(tmp_path):
    jparams, js = _jax_train_state()
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    opt = adamw_state_from_jax(jax.tree.map(np.asarray, tuple(js)),
                               device="cpu")
    path = str(tmp_path / "p.npz")
    save_pytree({"params": params, "opt": opt}, path)
    jpath = str(tmp_path / "j.npz")
    jsave_pytree({"params": jparams, "opt": js}, jpath)
    with np.load(path) as mine, np.load(jpath) as theirs:
        assert sorted(mine.files) == sorted(theirs.files)
        assert {"params||segments||0||wq", "opt||.mu||embed",
                "opt||.step"} <= set(mine.files)
        for key in theirs.files:
            assert mine[key].dtype == theirs[key].dtype, key
            np.testing.assert_array_equal(mine[key], theirs[key])
    restored = jload_pytree({"params": jparams, "opt": js}, path)
    for got, want in zip(jax.tree.leaves(restored),
                         jax.tree.leaves({"params": jparams, "opt": js})):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert os.path.getsize(path) > 0
