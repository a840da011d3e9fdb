"""Port vs JAX package: the shape dry run (``launch/dryrun.py``,
``launch/specs.py``, ``launch/mesh.py``), its shapes and the perf presets.

The dry run plays rank 0 of a ``fake`` world on ``meta`` tensors.  Held
against the JAX package:

* ``SHAPES``, ``apply_preset`` for every arch x shape (and its purity),
  ``input_specs``' shapes and dtypes, ``batch_shardings`` and
  ``cache_pspecs`` for every smoke arch and shape — exactly;
* the 2 x 2 smoke cells of ``repro.launch.dryrun`` (one JAX subprocess,
  as ``tests/test_dryrun_smoke.py`` runs it, for three cells): argument
  bytes a device equal JAX's ``memory_analysis().argument_size_in_bytes``
  exactly (deepseek_7b train, recurrentgemma_9b decode); FLOPs against
  ``hlo_analysis.flops_per_device``: deepseek_7b's equal once attention
  is taken out of both (JAX's XLA attention multiplies six dense S x S
  products, 2 B H S^2 D each; the port charges K7's and K8's declared
  causal work), rwkv6_3b's within 2.5% (measured 2.06%, 2^32 FLOPs: XLA
  splits the recurrence's heads over the model axis and folds one of its
  backward products into elementwise ops; the port runs every head on
  every rank).

Then the port's own: the mirror of ``tests/test_dryrun_smoke.py``'s five
cells, ``mesh_train_step`` bit for bit the step before it was split into
``mesh_step`` (a copy of that function below), a batch the dp axes do
not divide (long_500k's one sequence) whole on every rank of a (2, 2)
gloo world, its prefill and decode steps equal to JAX's unsharded ones
(one more JAX subprocess) and to the port's, and the CLI.

JAX is imported inside the tests: the spawned gloo ranks import this
module and only torch.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.configs.perf_presets import apply_preset
from repro_torch.launch import dryrun as D
from repro_torch.launch.specs import (batch_shardings, cache_pspecs,
                                      input_specs)
from repro_torch.models.config import SHAPES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHS = [a for a in ARCH_IDS if a != "logreg_paper"]
PRESET_FIELDS = ("flash_vjp", "rwkv_chunk", "rwkv_batch_parallel",
                 "fsdp_only", "train_microbatch", "mla_absorb",
                 "seq_parallel_prefill")
# the JAX cells: (arch, shape); argument bytes are held on the first two
JAX_CELLS = (("deepseek_7b", "train_4k"), ("recurrentgemma_9b", "decode_32k"),
             ("rwkv6_3b", "train_4k"))
RWKV_FLOPS_TOL = 0.025


# -- shapes, presets, specs --------------------------------------------------

def test_shapes_equal_jax():
    from repro.models.config import SHAPES as JSHAPES

    assert list(SHAPES) == list(JSHAPES)
    for name, shape in JSHAPES.items():
        assert dataclasses.asdict(SHAPES[name]) == dataclasses.asdict(shape)


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_apply_preset_matches_jax(arch):
    from repro.configs import get_config as jax_get_config
    from repro.configs.perf_presets import apply_preset as jax_apply_preset
    from repro.models.config import SHAPES as JSHAPES

    for name in SHAPES:
        got = _fields(apply_preset(get_config(arch), SHAPES[name]))
        want = _fields(jax_apply_preset(jax_get_config(arch), JSHAPES[name]))
        assert got == want, (arch, name)


def test_preset_application_is_pure():
    """Mirror of ``tests/test_sharding_rules.py``'s: the name kept, the
    input config never mutated, and only the preset's fields change."""
    for arch in LM_ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            out = apply_preset(cfg, shape)
            assert out.name == cfg.name
            assert get_config(arch) == cfg
            changed = {k for k, v in _fields(out).items()
                       if v != getattr(cfg, k)}
            assert changed <= set(PRESET_FIELDS)


def _jax_leaves(tree, prefix=""):
    """(path, shape, dtype name) of a JAX input tree's leaves."""
    import jax

    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out.append((key, tuple(leaf.shape), str(leaf.dtype)))
    return sorted(out)


def _port_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return sorted(x for k, v in tree.items()
                      for x in _port_leaves(v, f"{prefix}{k}/"))
    if isinstance(tree, list):
        return sorted(x for i, v in enumerate(tree)
                      for x in _port_leaves(v, f"{prefix}{i}/"))
    assert tree.device.type == "meta"
    return [(prefix[:-1], tuple(tree.shape),
             str(tree.dtype).removeprefix("torch."))]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_input_specs_match_jax(arch):
    from repro.configs import smoke_config as jax_smoke_config
    from repro.launch.specs import input_specs as jax_input_specs
    from repro.models.config import SHAPES as JSHAPES

    for name in SHAPES:
        want = _jax_leaves(jax_input_specs(jax_smoke_config(arch),
                                           JSHAPES[name]))
        got = _port_leaves(input_specs(smoke_config(arch), SHAPES[name]))
        assert got == want, (arch, name)


class _FakeRules:
    """A mesh's sizes without a process group: what both packages'
    ``batch_shardings`` and cache specs read."""

    tp_axis = "model"

    def __init__(self, sizes):
        self.sizes = dict(sizes)
        self.mesh = object()
        self.dp_axes = tuple(n for n in sizes if n != "model")
        self.tp_size = self.sizes["model"]
        self.dp_size = 1
        for a in self.dp_axes:
            self.dp_size *= self.sizes[a]

    def sharding(self, *spec):
        return tuple(spec)


RULES = {"2x2": {"data": 2, "model": 2}, "16x16": {"data": 16, "model": 16},
         "2x2x4": {"pod": 2, "data": 2, "model": 4}}


def _norm(spec):
    """A spec with one-axis tuples as the axis (``PartitionSpec``'s form)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


@pytest.mark.parametrize("mesh", sorted(RULES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_batch_and_cache_specs_match_jax(arch, mesh):
    from repro.configs import smoke_config as jax_smoke_config
    from repro.launch import specs as JS
    from repro.models.config import SHAPES as JSHAPES

    rules = _FakeRules(RULES[mesh])
    for name in SHAPES:
        jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
        jin, pin = JS.input_specs(jcfg, JSHAPES[name]), \
            input_specs(cfg, SHAPES[name])
        batch = {k: v for k, v in pin.items() if k != "caches"}
        jb = JS.batch_shardings({k: v for k, v in jin.items()
                                 if k != "caches"}, rules)
        assert {k: _norm(v) for k, v in batch_shardings(batch, rules).items()
                } == {k: _norm(v) for k, v in jb.items()}, (arch, name)
        if "caches" not in pin:
            continue
        got = cache_pspecs(pin["caches"], rules, cfg)
        for i, seg in enumerate(jin["caches"]):
            for leaf_name, leaf in seg.items():
                want = JS._cache_leaf_pspec(f"{i}/{leaf_name}", leaf, rules,
                                            jcfg)
                assert _norm(got[i][leaf_name]) == _norm(tuple(want)), (
                    arch, name, i, leaf_name)


def test_specs_without_a_mesh_are_none():
    class NoMesh:
        mesh = None

    pin = input_specs(smoke_config("deepseek_7b"), SHAPES["decode_32k"])
    assert set(batch_shardings({"tokens": pin["tokens"]},
                               NoMesh()).values()) == {None}
    assert all(v is None for seg in cache_pspecs(pin["caches"], NoMesh())
               for v in seg.values())


# -- the port's smoke dry run (tests/test_dryrun_smoke.py's cells) -----------

def _smoke(arch, shape, *extra):
    args = D.parse_args(["--arch", arch, "--shape", shape, "--smoke",
                         "--mesh-shape", "2,2", *extra])
    return D.run_cell(args, arch, shape)


@pytest.mark.parametrize("arch", ["deepseek_7b", "rwkv6_3b",
                                  "qwen3_moe_235b"])
def test_dryrun_train_smoke(arch):
    rec = _smoke(arch, "train_4k")
    assert rec["cost_analysis"]["flops_per_device"] > 0
    assert rec["memory"]["temp_bytes_per_device"] > 0
    assert rec["mesh"] == "2x2" and rec["devices"] == 4


def test_dryrun_microbatch_and_optimized():
    rec = _smoke("h2o_danube3_4b", "train_4k", "--microbatch", "2",
                 "--optimized", "--variant", "opt")
    assert rec["variant"] == "opt" and rec["n_micro"] == 2
    assert rec["cost_analysis"]["flops_per_device"] > 0


def test_dryrun_decode_smoke():
    rec = _smoke("recurrentgemma_9b", "decode_32k")
    assert rec["cost_analysis"]["bytes_per_device"] > 0


def test_dryrun_skips_dense_attention_at_500k():
    rec = _smoke("qwen2_5_32b", "long_500k")
    assert "skipped" in rec and "memory" not in rec
    assert "memory" in _smoke("h2o_danube3_4b", "long_500k")


def test_dryrun_cli_writes_one_record_a_cell(tmp_path, monkeypatch):
    """``main`` for one cell, and ``--all`` over a cut list of cells (each
    a subprocess, as in the JAX package); an existing record is kept."""
    assert D.main(["--arch", "deepseek_7b", "--shape", "decode_32k",
                   "--smoke", "--mesh-shape", "2,2", "--out",
                   str(tmp_path)]) == 0
    rec = json.load(open(tmp_path / "deepseek_7b__decode_32k__singlepod.json"))
    for key in ("arch", "shape", "mesh", "axes", "devices", "variant",
                "overrides", "smoke", "memory", "model", "cost_analysis",
                "wire_stats", "seconds"):
        assert key in rec
    monkeypatch.setattr(D, "LM_ARCHS", ("deepseek_7b",))
    monkeypatch.setattr(D, "SHAPES", {k: SHAPES[k] for k in
                                      ("decode_32k", "long_500k")})
    monkeypatch.setenv("PYTHONPATH", os.path.join(REPO, "src"))
    assert D.main(["--all", "--smoke", "--mesh-shape", "2,2", "--jobs", "2",
                   "--out", str(tmp_path)]) == 0
    assert "skipped" in json.load(open(
        tmp_path / "deepseek_7b__long_500k__singlepod.json"))


def test_host_devices_must_be_the_meshs():
    args = D.parse_args(["--arch", "deepseek_7b", "--shape", "decode_32k",
                         "--smoke", "--mesh-shape", "2,2",
                         "--host-devices", "8"])
    with pytest.raises(SystemExit, match="4 ranks"):
        D.run_cell(args, "deepseek_7b", "decode_32k")


# -- against the JAX package's dry run ---------------------------------------

@pytest.fixture(scope="module")
def jax_cells(tmp_path_factory):
    """JAX's 2 x 2 smoke records of ``JAX_CELLS`` (one subprocess a
    cell: ``repro.launch.dryrun`` owns XLA_FLAGS)."""
    out = tmp_path_factory.mktemp("jax_dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    procs = {cell: subprocess.Popen(
        [sys.executable, "-m", "repro.launch.dryrun", "--arch", cell[0],
         "--shape", cell[1], "--smoke", "--host-devices", "4",
         "--mesh-shape", "2,2", "--out", str(out / "_".join(cell))],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True) for cell in JAX_CELLS}
    recs = {}
    for (arch, shape), p in procs.items():
        _, err = p.communicate(timeout=420)
        assert p.returncode == 0, err[-2000:]
        recs[arch, shape] = json.load(open(
            out / f"{arch}_{shape}" / f"{arch}__{shape}__singlepod.json"))
    return recs


@pytest.mark.parametrize("cell", JAX_CELLS[:2], ids="_".join)
def test_argument_bytes_match_jax(jax_cells, cell):
    # JAX's record: compiled.memory_analysis().argument_size_in_bytes
    assert _smoke(*cell)["memory"]["argument_bytes_per_device"] == \
        jax_cells[cell]["memory"]["argument_bytes_per_device"]


def test_flops_match_jax_but_attention(jax_cells):
    """deepseek_7b's smoke train cell: the port's FLOPs less its kernels'
    declared work equal JAX's less its dense attention: six S x S products
    (q k^T and p v forward, four in the backward) of 2 B H S^2 D each, a
    rank's rows and heads, every layer."""
    rec = _smoke("deepseek_7b", "train_4k")["cost_analysis"]
    cfg, shape = smoke_config("deepseek_7b"), SHAPES["train_4k"]
    tp = dp = 2
    heads = cfg.num_heads // tp if cfg.num_heads % tp == 0 else cfg.num_heads
    dense = 6 * 2 * (shape.global_batch // dp) * heads * shape.seq_len ** 2 \
        * cfg.resolved_head_dim * cfg.num_layers
    jax_flops = jax_cells["deepseek_7b", "train_4k"]["hlo_analysis"][
        "flops_per_device"]
    assert rec["flops_per_device"] - sum(rec["kernel_flops"].values()) == \
        jax_flops - dense


def test_recurrent_flops_near_jax(jax_cells):
    """rwkv6_3b's smoke train cell, its loops probed (their FLOPs exact:
    ``tests/test_torch_cost_analysis.py``), above JAX's by at most
    ``RWKV_FLOPS_TOL``."""
    got = _smoke("rwkv6_3b", "train_4k")["cost_analysis"]["flops_per_device"]
    want = jax_cells["rwkv6_3b", "train_4k"]["hlo_analysis"][
        "flops_per_device"]
    assert want <= got <= want * (1 + RWKV_FLOPS_TOL)


# -- mesh_train_step, before and after the split ------------------------------

def _mesh_train_step_before_split(params, opt_state, batch, cfg, opt_cfg, *,
                                  rules, n_micro=None):
    """``launch.train.mesh_train_step`` as it was before ``mesh_step``
    was split out of it (verbatim)."""
    from repro_torch.core.flatbuf import tree_flatten, tree_unflatten
    from repro_torch.distributed import compat
    from repro_torch.distributed.sharding import split_axes
    from repro_torch.launch.train import _value_and_grad
    from repro_torch.optim.adamw import adamw_update

    n = max(n_micro or 1, cfg.train_microbatch)
    leaves, treedef = tree_flatten(params)
    if n <= 1:
        loss, metrics, grads = _value_and_grad(params, batch, cfg, rules)
    else:
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split into "
                             f"{n} microbatches")
        per = rows // n
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(n):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            lm, metrics, gm = _value_and_grad(params, mb, cfg, rules)
            for a, g in zip(grads, gm):
                a.add_(g.to(torch.float32))
            loss = loss + lm
            del gm
        for a in grads:
            a.div_(n)
        loss = loss / n
    grads = tree_unflatten(treedef, grads)
    if rules is None or rules.mesh is None:
        params, opt_state, om = adamw_update(grads, opt_state, params,
                                             opt_cfg)
    else:
        with compat.use_mesh(rules.mesh):
            params, opt_state, om = adamw_update(
                grads, opt_state, params, opt_cfg,
                split_axes=split_axes(cfg, rules))
    return params, opt_state, {**{k: float(v) for k, v in metrics.items()},
                               "grad_norm": float(om["grad_norm"]),
                               "lr": float(om["lr"]), "loss": float(loss)}


@pytest.mark.parametrize("n_micro", [1, 2])
def test_mesh_train_step_bit_for_bit_before_the_split(n_micro):
    from repro_torch.core.flatbuf import tree_flatten
    from repro_torch.launch.train import corpus_batch, mesh_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = dataclasses.replace(smoke_config("qwen2_5_32b"), remat=True)
    outs = []
    for step_fn in (_mesh_train_step_before_split, mesh_train_step):
        params = T.init_params(cfg, seed=0, device="cpu")
        state = adamw_init(params)
        ms = []
        for step in range(2):
            params, state, m = step_fn(
                params, state, corpus_batch(0, step, 4, 32, cfg.vocab_size,
                                            "cpu"),
                cfg, AdamWConfig(lr=1e-3), rules=None, n_micro=n_micro)
            ms.append(m)
        outs.append((ms, tree_flatten(params)[0],
                     tree_flatten(state.mu)[0]))
    (ma, pa, ua), (mb, pb, ub) = outs
    assert ma == mb
    assert all(torch.equal(a, b) for a, b in zip(pa + ua, pb + ub))


# -- a batch the dp axes do not divide ------------------------------------

REPLICATED_ARCHS = ("h2o_danube3_4b", "rwkv6_3b", "recurrentgemma_9b")
ROW_PROMPT, ROW_CACHE, ROW_STEPS, ROW_TOL = 36, 40, 3, 1e-5

# JAX's prefill and decode steps of the same sequence, unsharded
# (``MeshRules(mesh=None)``), with the port's parameters; the flag must be
# set before JAX starts
_JAX_ROWS = """
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax.numpy as jnp, numpy as np
from repro.configs import smoke_config
from repro.distributed import MeshRules
from repro.models import transformer as JT

inp, out = dict(np.load(sys.argv[1])), {}
for arch in sys.argv[3:]:
    cfg = dataclasses.replace(smoke_config(arch), dtype_str="float32")
    p = {"segments": []}
    for k, v in inp.items():
        parts = k.split("/")
        if parts[0] != arch or parts[1] == "tokens":
            continue
        if parts[1] == "segments":
            i = int(parts[2])
            while len(p["segments"]) <= i:
                p["segments"].append({})
            p["segments"][i][parts[3]] = jnp.asarray(v)
        else:
            p[parts[1]] = jnp.asarray(v)
    toks = jnp.asarray(inp[f"{arch}/tokens"])
    logits, caches, n = JT.prefill(p, cfg, MeshRules(mesh=None),
                                   tokens=toks[:, :%(prompt)d],
                                   cache_len=%(cache)d)
    outs = [np.asarray(logits)]
    for t in range(%(prompt)d, %(prompt)d + %(steps)d):
        logits, caches, n = JT.decode_step(p, caches, n, cfg,
                                           MeshRules(mesh=None),
                                           tokens=toks[:, t])
        outs.append(np.asarray(logits))
    out[f"{arch}/logits"] = np.stack(outs)
    for si, seg in enumerate(caches):
        for name, leaf in seg.items():
            out[f"{arch}/cache/{si}/{name}"] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
print("JAX_ROWS_OK")
""" % {"prompt": ROW_PROMPT, "cache": ROW_CACHE, "steps": ROW_STEPS}


def _row_case(arch):
    """(float32 smoke config, parameters, the one sequence's tokens) from
    seeds: the same on every rank and for JAX."""
    import numpy as np
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(smoke_config(arch), dtype_str="float32")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, ROW_PROMPT + ROW_STEPS)).astype("int32")
    return cfg, T.init_params(cfg, seed=0, device="cpu"), \
        torch.from_numpy(toks)


def _leaves(tree, prefix):
    """path -> numpy array of a parameter tree."""
    if isinstance(tree, dict):
        return {k: v for n, t in tree.items()
                for k, v in _leaves(t, f"{prefix}/{n}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree)
                for k, v in _leaves(t, f"{prefix}/{i}").items()}
    return {prefix: tree.detach().numpy()}


def _replicated_rows_rank(rank, world, rdzv, out_path, _):
    """A rank of a (2, 2) gloo world: each sub-quadratic smoke arch's
    prefill of one sequence and three decode steps under the mesh (the
    row whole on every rank), the logits and the caches after the steps
    gathered, and the unsharded run's logits; rank 0 saves them."""
    import torch.distributed as dist
    from repro_torch.distributed import compat
    from repro_torch.distributed.sharding import MeshRules, shard_params
    from repro_torch.models import transformer as T

    dist.init_process_group("gloo", init_method=rdzv, rank=rank,
                            world_size=world)
    res = {}
    try:
        rules = MeshRules(compat.make_mesh((2, 2), ("data", "model")))
        for arch in REPLICATED_ARCHS:
            cfg, params, toks = _row_case(arch)
            r = {}
            for name, rl, p in (("unsharded", None, params),
                                ("sharded", rules,
                                 shard_params(params, rules, cfg))):
                with torch.no_grad():
                    logits, caches, n = T.prefill(
                        p, cfg, toks[:, :ROW_PROMPT], cache_len=ROW_CACHE,
                        rules=rl)
                    out = [T.gather_logits(logits, cfg, rl, batch=1)]
                    for t in range(ROW_PROMPT, ROW_PROMPT + ROW_STEPS):
                        logits, caches, n = T.decode_step(
                            p, caches, n, cfg, toks[:, t], rules=rl)
                        out.append(T.gather_logits(logits, cfg, rl,
                                                   batch=1))
                r[name] = torch.stack(out)
            r["caches"] = T.gather_caches(caches, cfg, rules)
            res[arch] = r
        if rank == 0:
            torch.save(res, out_path)
    finally:
        dist.destroy_process_group()


def test_a_batch_of_one_is_whole_on_every_rank(tmp_path):
    """long_500k's batch of one on a mesh whose dp axes it does not
    divide: JAX's batch spec falls back to replication, and so does the
    port's program (``TP.rows``): every rank holds the row.  On a (2, 2)
    gloo world, the gathered logits of the prefill and three decode
    steps, and the gathered caches after them, equal JAX's unsharded
    ``prefill`` and ``decode_step`` on the same parameters and tokens
    (run in a subprocess meanwhile), and the port's unsharded logits,
    within 1e-5 of their largest magnitude (summation order)."""
    import numpy as np
    from repro_torch.distributed.multihost import spawn_ranks

    inp = {}
    for arch in REPLICATED_ARCHS:
        _, params, toks = _row_case(arch)
        inp.update(_leaves(params, arch))
        inp[f"{arch}/tokens"] = toks.numpy()
    np.savez(tmp_path / "in.npz", **inp)
    (tmp_path / "rows.py").write_text(_JAX_ROWS)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, str(tmp_path / "rows.py"), str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz"), *REPLICATED_ARCHS], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        got = spawn_ranks(4, _replicated_rows_rank, None, deadline_s=240)
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0 and "JAX_ROWS_OK" in stdout, stderr[-3000:]
    want = dict(np.load(tmp_path / "out.npz"))

    def close(a, b, what):
        a = a.numpy() if torch.is_tensor(a) else a
        assert a.shape == b.shape, (what, a.shape, b.shape)
        err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
        assert err <= ROW_TOL * scale, (what, err, scale)

    assert set(got) == set(REPLICATED_ARCHS)
    for arch, r in got.items():
        close(r["sharded"], want[f"{arch}/logits"], f"{arch} logits")
        close(r["sharded"], r["unsharded"].numpy(), f"{arch} unsharded")
        for si, seg in enumerate(r["caches"]):
            for name, leaf in seg.items():
                close(leaf.float(), want[f"{arch}/cache/{si}/{name}"],
                      f"{arch} cache {si} {name}")


def test_training_refuses_a_batch_the_dp_axes_do_not_divide():
    from repro_torch.distributed import compat
    from repro_torch.distributed.sharding import MeshRules
    from repro_torch.launch.mesh import fake_world
    from repro_torch.launch.specs import input_specs as specs
    from repro_torch.launch.train import _value_and_grad
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeConfig

    cfg = smoke_config("deepseek_7b")
    with fake_world(4):
        rules = MeshRules(compat.make_mesh((2, 2), ("data", "model")))
        with pytest.raises(ValueError, match="must split over the dp axes"):
            _value_and_grad(T.abstract_params(cfg), specs(
                cfg, ShapeConfig("t", 8, 1, "train")), cfg, rules)
