"""Port vs JAX package: the LM's sharding rules (``distributed/sharding.py``).

Pure and fast, no process group: for every LM architecture's full
configuration under every parallelism flag, the port's ``param_pspec`` of
every leaf of its parameter tree (on the ``meta`` device: Qwen3-MoE-235B
cannot be allocated) equals the JAX package's, on a fake 16 x 16
(data, model) rules object both functions accept, as
``tests/test_sharding_rules.py`` builds it, and on a fake (2, 2, 4)
(pod, data, model) one.  Then the mirror of that file's invariants on
the port, ``param_shardings``' placements against the specs, and
``shard_params``' blocks put back together into each leaf.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import param_pspec as jax_param_pspec
from repro.models import transformer as JT
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.distributed.sharding import (
    leaf_spec,
    param_pspec,
    param_shardings,
    placements,
    shard_params,
)
from repro_torch.models import transformer as T
from repro_torch.models.config import segments

LM_ARCHS = [a for a in ARCH_IDS if a != "logreg_paper"]
FLAGS = [{}, {"fsdp_only": True}, {"rwkv_batch_parallel": True},
         {"seq_parallel_prefill": True}]


class _FakeMesh:
    """A mesh's shape and one rank's coordinates on it (default: 0)."""

    def __init__(self, sizes, coords=None):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = tuple(sizes.values())
        self._coords = dict(coords or {})

    def size(self, dim):
        return self._sizes[dim]

    def get_local_rank(self, name):
        return self._coords.get(name, 0)


class _FakeRules:
    """MeshRules stand-in with a fixed shape and no process group; both
    packages' ``param_pspec`` read only these attributes."""

    tp_axis = "model"

    def __init__(self, sizes, coords=None):
        self.sizes = dict(sizes)
        self.mesh = _FakeMesh(self.sizes, coords)
        self.axis_names = tuple(self.sizes)
        self.dp_axes = tuple(n for n in self.sizes if n != "model")
        self.tp_size = self.sizes["model"]
        self.dp_size = int(np.prod([self.sizes[a] for a in self.dp_axes]))

    def fsdp_axes(self):
        return self.dp_axes

    def axis_size(self, name):
        return self.sizes[name]

    def sharding(self, *spec):
        return placements(spec, self.axis_names)


RULES = {"16x16": _FakeRules({"data": 16, "model": 16}),
         "2x2x4": _FakeRules({"pod": 2, "data": 2, "model": 4})}


def _paths(params):
    out = [(k, params[k]) for k in ("embed", "final_norm", "lm_head")]
    for i, seg in enumerate(params["segments"]):
        out += [(f"segments/{i}/{name}", leaf) for name, leaf in seg.items()]
    return out


def _axis_size(axis, sizes):
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return int(np.prod([sizes[a] for a in axis]))
    return sizes[axis]


def _check_spec(spec, shape, sizes):
    used = []
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        assert shape[dim] % _axis_size(axis, sizes) == 0, (spec, shape, dim)
        for a in (axis,) if isinstance(axis, str) else axis:
            assert a not in used, f"axis {a} used twice in {spec}"
            used.append(a)


@pytest.mark.parametrize("mesh", sorted(RULES))
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: next(iter(f), "none"))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_pspec_equals_jax_leaf_for_leaf(arch, flags, mesh):
    """Every leaf of the full config's tree: the port's spec is the JAX
    package's, and the port's tree has JAX's leaves and shapes."""
    rules = RULES[mesh]
    cfg = dataclasses.replace(get_config(arch), **flags)
    jcfg = dataclasses.replace(jax_get_config(arch), **flags)
    params = T.abstract_params(cfg)
    assert params["embed"].is_meta
    for (kind, n), seg in zip(segments(cfg), params["segments"]):
        want = JT._block_param_shapes(jcfg, kind)
        assert {k: tuple(v.shape) for k, v in seg.items()} == \
            {k: (n, *s) for k, s in want.items()}
    for path, leaf in _paths(params):
        shape = tuple(leaf.shape)
        per_layer = shape[1:] if path.startswith("segments") else shape
        got = param_pspec(path, per_layer, rules, cfg)
        want = tuple(jax_param_pspec(path, per_layer, rules, jcfg))
        assert got == want, (path, got, want)


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: next(iter(f), "none"))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_specs_valid_for_all_archs(arch, flags):
    """The mirror of the JAX test: every spec of the full config shards
    only dimensions its axes divide, and no axis twice."""
    for rules in RULES.values():
        cfg = dataclasses.replace(get_config(arch), **flags)
        for path, leaf in _paths(T.abstract_params(cfg)):
            spec = leaf_spec(path, leaf.shape, rules, cfg)
            assert len(spec) == leaf.dim()
            _check_spec(spec, tuple(leaf.shape), rules.sizes)


@given(
    d=st.sampled_from([1024, 2560, 3840, 4096, 5120, 8192]),
    heads=st.sampled_from([8, 16, 24, 32, 40, 56, 64]),
    ff=st.sampled_from([1536, 10240, 11008, 27648, 29568]),
)
@settings(max_examples=40, deadline=None)
def test_attention_mlp_specs_never_overshard(d, heads, ff):
    cfg = dataclasses.replace(get_config("deepseek_7b"), d_model=d,
                              num_heads=heads, num_kv_heads=heads, d_ff=ff)
    rules = RULES["16x16"]
    for name, shape in (("wq", (d, heads * 128)), ("wo", (heads * 128, d)),
                        ("w1", (d, ff)), ("w2", (ff, d))):
        _check_spec(param_pspec(name, shape, rules, cfg), shape, rules.sizes)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_shardings_agree_with_specs(arch):
    """Each leaf's placements: ``Shard(dim)`` on exactly the mesh
    dimensions its spec splits ``dim`` over, ``Replicate()`` elsewhere;
    a segment leaf's layer axis is never split."""
    from torch.distributed.tensor import Replicate, Shard

    cfg = get_config(arch)
    for rules in RULES.values():
        params = T.abstract_params(cfg)
        shardings = param_shardings(params, rules, cfg)
        got = dict(_paths(shardings))
        for path, leaf in _paths(params):
            spec = leaf_spec(path, leaf.shape, rules, cfg)
            pl = got[path]
            assert len(pl) == len(rules.axis_names)
            for name, p in zip(rules.axis_names, pl):
                dims = [d for d, a in enumerate(spec) if a is not None
                        and name in ((a,) if isinstance(a, str) else a)]
                assert p == (Shard(dims[0]) if dims else Replicate())
            if path.startswith("segments"):
                assert Shard(0) not in pl


@pytest.mark.parametrize("mesh", [{"data": 2, "model": 2},
                                  {"data": 1, "model": 4},
                                  {"pod": 2, "data": 1, "model": 2}],
                         ids=["2x2", "1x4", "2x1x2"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_shard_params_blocks_rebuild_each_leaf(arch, mesh):
    """Every rank's blocks of a smoke config (under every flag's specs)
    put back together along the spec's dimensions, row-major over its
    axes, give each leaf back; each rank holds 1/size of each split
    leaf."""
    rules = _FakeRules(mesh)
    names = tuple(mesh)
    coords = [dict(zip(names, c)) for c in np.ndindex(*mesh.values())]
    for flags in FLAGS:
        cfg = dataclasses.replace(smoke_config(arch), **flags)
        params = T.init_params(cfg, seed=1, device="cpu")
        blocks = [dict(_paths(shard_params(params, _FakeRules(mesh, c),
                                           cfg))) for c in coords]
        for path, leaf in _paths(params):
            spec = leaf_spec(path, leaf.shape, rules, cfg)
            rebuilt = np.empty(tuple(leaf.shape), dtype=np.float32)
            for c, blk in zip(coords, blocks):
                idx = []
                for dim, axes in enumerate(spec):
                    if axes is None:
                        idx.append(slice(None))
                        continue
                    i, n = 0, 1
                    for a in (axes,) if isinstance(axes, str) else axes:
                        i, n = i * mesh[a] + c[a], n * mesh[a]
                    step = leaf.shape[dim] // n
                    assert blk[path].shape[dim] == step
                    idx.append(slice(i * step, (i + 1) * step))
                rebuilt[tuple(idx)] = blk[path].float().numpy()
            np.testing.assert_array_equal(rebuilt, leaf.float().numpy(),
                                          err_msg=path)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_state_specs_lay_the_moments_out_like_the_params(arch):
    """``train_state_specs`` (the JAX package's ``launch/specs.py``): the
    abstract parameters and float32 moments on the ``meta`` device, the
    moments' placements the parameters', the step replicated, every
    placement None without a mesh; and ``param_specs`` gives each leaf's
    spec in ``tree_flatten``'s order (sorted keys)."""
    import torch
    from torch.distributed.tensor import Replicate

    from repro_torch.core.flatbuf import tree_flatten
    from repro_torch.distributed.sharding import (MeshRules, param_specs,
                                                  train_state_specs)

    cfg = get_config(arch)
    for rules in RULES.values():
        params_abs, p_sh, opt_abs, opt_sh = train_state_specs(cfg, rules)
        leaves = tree_flatten(params_abs)[0]
        assert all(p.device.type == "meta" for p in leaves)
        for moments in (opt_abs.mu, opt_abs.nu):
            assert [(m.shape, m.dtype) for m in tree_flatten(moments)[0]] \
                == [(p.shape, torch.float32) for p in leaves]
        assert opt_sh.mu == p_sh and opt_sh.nu == p_sh
        assert opt_sh.step == (Replicate(),) * len(rules.axis_names)
        paths = ["embed", "final_norm", "lm_head"] + [
            f"segments/{i}/{name}" for i, seg in
            enumerate(params_abs["segments"]) for name in sorted(seg)]
        assert param_specs(cfg, rules) == [
            leaf_spec(path, leaf.shape, rules, cfg)
            for path, leaf in zip(paths, leaves, strict=True)]
    _, p_sh, _, opt_sh = train_state_specs(cfg, MeshRules())
    assert opt_sh.step is None
    assert all(v is None for v in tree_flatten(p_sh)[0])
