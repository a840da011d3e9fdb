"""Port vs JAX package: gradients under a mesh on ``torch.distributed``.

Each mesh runs as one spawned gloo world on the CPU (``multihost.
spawn_ranks``; the workers live in this module, which imports JAX only
inside functions, so every rank imports only torch): (1, 2), (1, 4),
(2, 2) and (1, 3) — the last divides none of the smoke configs' head
counts, widths or vocabulary, so every leaf is replicated — plus a
(1, 1) world.  Every rank returns its own gradient blocks and rank 0
saves them all; the test cuts JAX's whole gradient to each rank's block
by the leaf's spec (``sharding.leaf_spec``).

JAX side: one subprocess with ``--xla_force_host_platform_device_count=4``
(the flag must be set before JAX starts) computes, in float32 and on the
same parameters and batches, ``jax.value_and_grad`` of ``loss_fn`` with
``MeshRules(mesh=None)``, two ``adamw_update`` steps, and the
microbatched step of ``launch/dryrun.py`` (``value_and_grad`` of each
microbatch, summed in float32, divided by their count, then
``adamw_update``); and on a real (2, 2) mesh
(``repro.distributed.compat.make_mesh``) ``moe_ffn``'s and a MoE arch's
``loss_fn``'s sharded gradients.  It runs while the worlds do.

Cases: the smoke config of every LM architecture, with remat (a block's
backward re-issues its collectives), batch 4 of 32 tokens (64 for
``seq_parallel_prefill``: past the window of 32), a quarter of the labels
masked; and the flag paths ``fsdp_only``, ``rwkv_batch_parallel``,
``seq_parallel_prefill`` and ``mla_absorb``.  The MoE archs run drop-free
(``capacity_factor`` = E), and raise at (1, 3), where E = 8 does not
divide tp.  Two references:

* every case on every mesh but a MoE arch at dp 2: JAX's unsharded
  ``jax.grad``, which JAX's sharded gradient equals there;
* a MoE arch at dp 2 (the (2, 2) mesh), and ``moe_ffn`` there at its
  default capacity (assignments drop; x and the router on a grid, so
  both packages route alike): JAX's sharded gradient, whose capacity
  comes from each data shard's tokens and whose aux term's gradient is
  the mean over the dp shards of each shard's (its value dp shard 0's).

Tolerance: each rank's block of each leaf within 1e-5 of the leaf's
max|g| (summation order).  ``mesh_train_step`` uses AdamW's eps 1e-3
(``tests/test_torch_train.py``'s reason: the default eps turns float32
noise in a tiny first-step gradient into a +-lr step), its parameters
within 1e-5 of max|p|.  A (1, 1) mesh gives the unsharded gradients and
step bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_DEADLINE_S = 240.0
TOL = 1e-5
B, S, S_CP = 4, 32, 64
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2), "1x3": (1, 3)}
LM_ARCHS = ("qwen2_5_32b", "deepseek_7b", "h2o_danube3_4b", "qwen2_72b",
            "rwkv6_3b", "musicgen_medium", "recurrentgemma_9b",
            "deepseek_v2_lite", "qwen3_moe_235b", "llava_next_34b")
MOE_ARCHS = ("deepseek_v2_lite", "qwen3_moe_235b")
# (case, arch, flags, sequence length); the flags change nothing of
# JAX's unsharded loss, so a flag case shares its arch's reference at
# its length
CASES = tuple((a, a, {}, S) for a in LM_ARCHS) + (
    ("h2o_danube3_4b-seq_parallel", "h2o_danube3_4b",
     {"seq_parallel_prefill": True}, S_CP),
    ("recurrentgemma_9b-seq_parallel", "recurrentgemma_9b",
     {"seq_parallel_prefill": True}, S_CP),
    ("qwen2_5_32b-fsdp_only", "qwen2_5_32b", {"fsdp_only": True}, S),
    ("recurrentgemma_9b-fsdp_only", "recurrentgemma_9b", {"fsdp_only": True},
     S),
    ("deepseek_v2_lite-fsdp_only", "deepseek_v2_lite", {"fsdp_only": True},
     S),
    ("rwkv6_3b-rwkv_batch_parallel", "rwkv6_3b",
     {"rwkv_batch_parallel": True}, S),
    ("deepseek_v2_lite-mla_absorb", "deepseek_v2_lite", {"mla_absorb": True},
     S),
)
# adamw_update(split_axes=): two steps on a seeded gradient tree
ADAM_CASES = ("qwen2_5_32b", "deepseek_v2_lite", "qwen2_5_32b-fsdp_only",
              "rwkv6_3b-rwkv_batch_parallel")
ADAM_CFG = dict(lr=1e-2, warmup_steps=1)
# mesh_train_step with two microbatches of 4 rows (batch 8); the MoE arch
# where dp is 1 (its (2, 2) step is JAX's sharded one)
STEP_CASES = (("qwen2_5_32b", ("1x2", "1x4", "2x2", "1x3")),
              ("recurrentgemma_9b", ("1x2", "1x4", "2x2", "1x3")),
              ("deepseek_v2_lite", ("1x2", "1x4")))
STEP_B, N_MICRO = 8, 2
STEP_CFG = dict(lr=1e-3, eps=1e-3, warmup_steps=1)
# the sharded MoE references on the (2, 2) mesh, at the default capacity
MOE_ARCH, MOE_B, MOE_S = "deepseek_v2_lite", 4, 16
# the differentiable collectives: (op, axes) on the (1, 2) and (2, 2)
# worlds
COLLECTIVES = ("psum", "all_gather", "psum_scatter", "ppermute", "pvary",
               "cut", "gather")


def _case(name):
    return next(c for c in CASES if c[0] == name)


def _ref_key(arch, seq):
    return f"{arch}-{seq}"


def _cfg(arch, flags, moe_cf=None):
    from repro_torch.configs import smoke_config

    cfg = dataclasses.replace(smoke_config(arch), dtype_str="float32",
                              remat=True, **flags)
    if cfg.moe_num_experts:  # drop-free: capacity T k
        cfg = dataclasses.replace(
            cfg, capacity_factor=moe_cf or float(cfg.moe_num_experts))
    return cfg


def _params(cfg):
    from repro_torch.models import transformer as T

    return T.init_params(cfg, seed=0, device="cpu")


def _batch(cfg, seq, rows=B, seed=1):
    """A batch as numpy from a seed: tokens or embeds, labels with about
    a quarter masked (-1)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (rows, seq))
    labels[rng.random((rows, seq)) < 0.25] = -1
    out = {"labels": labels.astype(np.int32)}
    if cfg.frontend == "embeddings":
        out["embeds"] = rng.standard_normal(
            (rows, seq, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (rows, seq)).astype(np.int32)
    return out


def _grad_tree(cfg, seed=7):
    """A seeded gradient tree shaped like the parameters (numpy)."""
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(v.shape).astype(np.float32) * 0.01
            for k, v in _flat(_params(cfg), "").items()}


def _flat(tree, prefix):
    """path -> numpy of a parameter tree."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
    else:
        out[prefix] = np.asarray(tree.detach().float().numpy()
                                 if torch.is_tensor(tree) else tree)
    return out


def _unflat(flat, like):
    """The tree ``like`` with each leaf replaced by ``flat``'s tensor."""
    def go(tree, prefix):
        if isinstance(tree, dict):
            return {k: go(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [go(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
        return torch.as_tensor(flat[prefix])

    return go(like, "")


def _moe_inputs(cfg):
    """x and the router on a grid (their products exact in float32, so
    both packages route alike), the rest of the first MoE layer's leaves,
    and the cotangent weights c of y."""
    rng = np.random.default_rng(4)
    seg = next(s for s in _params(cfg)["segments"] if "router" in s)
    p = {k: v[0].numpy() for k, v in seg.items()
         if k.startswith(("router", "experts_", "shared_"))}
    p["router"] = (rng.integers(-4, 5, p["router"].shape) / 8).astype(
        np.float32)
    x = (rng.integers(-4, 5, (MOE_B, MOE_S, cfg.d_model)) / 4).astype(
        np.float32)
    c = rng.standard_normal(x.shape).astype(np.float32)
    return x, p, c


# -------------------------------------------------------------- the JAX side
_JAX_SCRIPT = textwrap.dedent("""
    import os, sys, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import smoke_config
    from repro.distributed import MeshRules
    from repro.distributed.compat import make_mesh
    from repro.models import transformer as JT
    from repro.models.moe import moe_ffn
    from repro.optim import adamw as JA

    inp = dict(np.load(sys.argv[1]))
    out = {}
    NONE = MeshRules(mesh=None)
    MESH = MeshRules(mesh=make_mesh((2, 2), ("data", "model")))

    def tree(prefix):
        keys = [k for k in inp if k.startswith(prefix + "/")]
        p = {"segments": []}
        for k in keys:
            parts = k[len(prefix) + 1:].split("/")
            if parts[0] == "segments":
                i = int(parts[1])
                while len(p["segments"]) <= i:
                    p["segments"].append({})
                p["segments"][i][parts[2]] = jnp.asarray(inp[k])
            else:
                p[parts[0]] = jnp.asarray(inp[k])
        return p

    def flat(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from flat(v, f"{prefix}/{k}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                yield from flat(v, f"{prefix}/{i}")
        else:
            yield prefix, np.asarray(t)

    def config(ref):
        cfg = dataclasses.replace(smoke_config(str(inp[f"{ref}/arch"])),
                                  dtype_str="float32")
        if cfg.moe_num_experts:
            cfg = dataclasses.replace(
                cfg, capacity_factor=float(inp[f"{ref}/cf"]))
        return cfg

    def batch(prefix):
        return {k.split("/")[-1]: jnp.asarray(inp[k]) for k in inp
                if k.startswith(prefix + "/batch/")}

    def vg(cfg, rules):
        return jax.jit(jax.value_and_grad(
            lambda p, b: JT.loss_fn(p, b, cfg, rules), has_aux=True))

    # loss_fn's gradients: unsharded, and the MoE arch sharded on (2, 2)
    for ref in inp["refs"]:
        ref = str(ref)
        rules = MESH if bool(inp[f"{ref}/sharded"]) else NONE
        (loss, m), g = vg(config(ref), rules)(tree(f"{ref}/params"),
                                              batch(ref))
        out[f"{ref}/loss"] = np.asarray(loss)
        out[f"{ref}/ce"] = np.asarray(m["ce"])
        out[f"{ref}/aux"] = np.asarray(m["aux"])
        out.update(flat(g, f"{ref}/grad"))

    # moe_ffn on the (2, 2) mesh: d/d(x, params) of sum(y c) + aux
    mcfg = config("moe")
    mp = {k.split("/")[-1]: jnp.asarray(inp[k]) for k in inp
          if k.startswith("moe/p/")}

    def moe_obj(x, p):
        y, aux, _ = moe_ffn(x, p, mcfg, MESH)
        return jnp.sum(y * jnp.asarray(inp["moe/c"])) + aux, aux

    (val, aux), (gx, gp) = jax.jit(jax.value_and_grad(
        moe_obj, argnums=(0, 1), has_aux=True))(jnp.asarray(inp["moe/x"]),
                                                mp)
    out["moe/value"], out["moe/aux"] = np.asarray(val), np.asarray(aux)
    out["moe/grad/x"] = np.asarray(gx)
    out.update(flat(gp, "moe/grad/p"))

    # two adamw_update steps on a seeded gradient tree
    for ref in inp["adam_refs"]:
        ref = str(ref)
        params = tree(f"{ref}/params")
        grads = tree(f"{ref}/g")
        cfg = JA.AdamWConfig(lr=float(inp["adam_lr"]),
                             warmup_steps=int(inp["adam_warmup"]))
        state = JA.adamw_init(params)
        for step in range(2):
            params, state, m = JA.adamw_update(grads, state, params, cfg)
            out[f"{ref}/grad_norm/{step}"] = np.asarray(m["grad_norm"])
        out.update(flat(params, f"{ref}/after"))

    # the microbatched step of launch/dryrun.py
    for ref in inp["step_refs"]:
        ref = str(ref)
        cfg = config(ref)
        params = tree(f"{ref}/params")
        b = batch(ref)
        n = int(inp["n_micro"])
        mb = jax.tree_util.tree_map(
            lambda x: x.reshape((n, x.shape[0] // n) + x.shape[1:]), b)
        f = vg(cfg, NONE)
        gacc = jax.tree_util.tree_map(
            lambda p: jnp.zeros(p.shape, jnp.float32), params)
        lsum = jnp.zeros((), jnp.float32)
        for i in range(n):
            (l, m), g = f(params, jax.tree_util.tree_map(lambda x: x[i], mb))
            gacc = jax.tree_util.tree_map(
                lambda a, c: a + c.astype(jnp.float32), gacc, g)
            lsum = lsum + l
        grads = jax.tree_util.tree_map(lambda g: g / n, gacc)
        ocfg = JA.AdamWConfig(lr=float(inp["step_lr"]),
                              eps=float(inp["step_eps"]),
                              warmup_steps=int(inp["step_warmup"]))
        params, _, om = JA.adamw_update(grads, JA.adamw_init(params), params,
                                        ocfg)
        out[f"{ref}/loss"] = np.asarray(lsum / n)
        out[f"{ref}/ce"] = np.asarray(m["ce"])
        out[f"{ref}/grad_norm"] = np.asarray(om["grad_norm"])
        out.update(flat(params, f"{ref}/after"))
    np.savez(sys.argv[2], **out)
    print("JAX_TP_GRAD_OK")
""")


def _jax_inputs():
    """The JAX subprocess's inputs, as one flat dict of numpy."""
    inp = {}
    refs = []

    def add_ref(ref, arch, cfg, seq, sharded=False, rows=B):
        inp.update(_flat(_params(cfg), f"{ref}/params"))
        inp[f"{ref}/arch"] = arch
        inp[f"{ref}/cf"] = cfg.capacity_factor
        inp[f"{ref}/sharded"] = sharded
        inp.update({f"{ref}/batch/{k}": v
                    for k, v in _batch(cfg, seq, rows).items()})

    for _, arch, flags, seq in CASES:
        ref = _ref_key(arch, seq)
        if ref not in refs:
            refs.append(ref)
            add_ref(ref, arch, _cfg(arch, {}), seq)
    mcfg = _cfg(MOE_ARCH, {}, moe_cf=1.25)
    add_ref("moe_loss", MOE_ARCH, mcfg, S, sharded=True)
    refs.append("moe_loss")
    inp["refs"] = np.array(refs)
    x, p, c = _moe_inputs(mcfg)
    inp.update({"moe/arch": MOE_ARCH, "moe/cf": 1.25, "moe/x": x,
                "moe/c": c})
    inp.update({f"moe/p/{k}": v for k, v in p.items()})
    for name in ADAM_CASES:
        _, arch, flags, _ = _case(name)
        cfg = _cfg(arch, flags)
        inp.update(_flat(_params(cfg), f"adam-{name}/params"))
        inp.update({f"adam-{name}/g/{k}": v
                    for k, v in _grad_tree(cfg).items()})
    inp["adam_refs"] = np.array([f"adam-{n}" for n in ADAM_CASES])
    inp.update(adam_lr=ADAM_CFG["lr"], adam_warmup=ADAM_CFG["warmup_steps"])
    for arch, _ in STEP_CASES:
        add_ref(f"step-{arch}", arch, _cfg(arch, {}), S, rows=STEP_B)
    inp["step_refs"] = np.array([f"step-{a}" for a, _ in STEP_CASES])
    inp.update(n_micro=N_MICRO, step_lr=STEP_CFG["lr"],
               step_eps=STEP_CFG["eps"],
               step_warmup=STEP_CFG["warmup_steps"])
    return inp


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """Write the inputs and start the JAX subprocess at once; ``jax_refs``
    collects it, so the worlds run while it does."""
    d = tmp_path_factory.mktemp("jax_tp_grad")
    np.savez(d / "in.npz", **_jax_inputs())
    (d / "tp_grad.py").write_text(_JAX_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, str(d / "tp_grad.py"), str(d / "in.npz"),
         str(d / "out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield proc, d / "out.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_refs(jax_proc, worlds):
    proc, out = jax_proc
    try:
        stdout, stderr = proc.communicate(timeout=420)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, stderr[-3000:]
    assert "JAX_TP_GRAD_OK" in stdout
    return dict(np.load(out))


# ------------------------------------------------------------ the port side
def _tensors(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _grads(params, batch, cfg, rules):
    """(loss, ce, aux, {path: gradient}) of ``loss_fn`` on this rank."""
    from repro_torch.launch.train import _value_and_grad

    loss, m, g = _value_and_grad(params, batch, cfg, rules)
    from repro_torch.core.flatbuf import tree_flatten, tree_unflatten

    tree = tree_unflatten(tree_flatten(params)[1], g)
    return (float(loss), float(m["ce"]), float(m["aux"]),
            {k: torch.from_numpy(v) for k, v in _flat(tree, "").items()})


def _owned(tree):
    if isinstance(tree, dict):
        return {k: _owned(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_owned(v) for v in tree]
    return tree.clone()


def _collective_case(op, shape):
    """(the sharded result's gradient on this rank, the whole function's
    gradient of the same input) for one differentiable collective, on a
    scalar objective; see ``test_collectives_differentiate``."""
    from repro_torch.distributed import _tp, compat

    axes = "model" if op in ("cut", "gather", "pvary") or shape == (1, 2) \
        else ("data", "model")
    n = compat.axis_size(axes)
    me = compat.axis_index(axes)
    rng = np.random.default_rng(11)
    xs = torch.from_numpy(rng.standard_normal((n, 4, 6)).astype(np.float32))
    cs = torch.from_numpy(rng.standard_normal((n, 4 * n, 6)).astype(
        np.float32))
    # the whole function: every rank's input xs[r] (or the one x = xs[0]
    # of a replicated input), cotangent weights cs
    whole = xs.clone().requires_grad_(True)
    if op == "psum":  # partial inputs, the replicated sum
        f = (whole.sum(0) * cs[0, :4]).sum()
    elif op == "all_gather":  # blocks gathered, each rank's own use
        f = sum((whole.reshape(4 * n, 6) * cs[r]).sum() for r in range(n))
    elif op == "psum_scatter":  # rank r keeps block r of the sum
        f = sum((whole.sum(0)[r * 4 // n:(r + 1) * 4 // n]
                 * cs[r, :4 // n]).sum() for r in range(n))
    elif op == "ppermute":  # rank r gets r - 1's input
        f = sum((whole[(r - 1) % n] * cs[r, :4]).sum() for r in range(n))
    elif op == "pvary":  # one input, each rank's own use
        f = sum((whole[0] * cs[r, :4]).sum() for r in range(n))
    elif op == "cut":  # one input, rank r takes its rows
        f = sum((whole[0][r * 4 // n:(r + 1) * 4 // n]
                 * cs[0, r * 4 // n:(r + 1) * 4 // n]).sum()
                for r in range(n))
    else:  # gather: blocks gathered, used alike by every rank
        f = (whole.reshape(4 * n, 6) * cs[0]).sum()
    f.backward()
    want = whole.grad[0 if op in ("pvary", "cut") else me]
    x = (xs[0] if op in ("pvary", "cut") else xs[me]).clone() \
        .requires_grad_(True)
    if op == "psum":
        y = (compat.psum(x, axes) * cs[0, :4]).sum()
    elif op == "all_gather":
        y = compat.psum((compat.all_gather(x, axes) * cs[me]).sum(), axes)
    elif op == "psum_scatter":
        y = compat.psum((compat.psum_scatter(x, axes) * cs[me, :4 // n])
                        .sum(), axes)
    elif op == "ppermute":
        perm = [(r, (r + 1) % n) for r in range(n)]
        y = compat.psum((compat.ppermute(x, axes, perm) * cs[me, :4]).sum(),
                        axes)
    elif op == "pvary":
        y = compat.psum((compat.pvary(x, axes) * cs[me, :4]).sum(), axes)
    elif op == "cut":
        y = compat.psum((_tp.cut(x, 0, axes)
                         * cs[0, me * 4 // n:(me + 1) * 4 // n]).sum(), axes)
    else:
        y = (_tp.gather(x, 0, axes) * cs[0]).sum()
    y.backward()
    return x.grad, want


def _grad_world(rank, world, rdzv, out_path, shape):
    """One mesh's world: every case and check of that mesh; rank 0 saves
    every rank's results."""
    from repro_torch.distributed import compat, multihost
    from repro_torch.distributed._tp import cut
    from repro_torch.distributed.sharding import MeshRules, shard_params, \
        split_axes
    from repro_torch.launch.train import mesh_train_step
    from repro_torch.models.moe import moe_ffn
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, \
        adamw_update

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=rdzv, rank=rank,
                            world_size=world,
                            timeout=multihost.GROUP_TIMEOUT)
    mesh = compat.make_mesh(shape, ("data", "model"))
    rules = MeshRules(mesh)
    res = {"coords": {n: int(mesh.get_local_rank(n))
                      for n in ("data", "model")}}
    tag = f"{shape[0]}x{shape[1]}"
    try:
        for name, arch, flags, seq in CASES:
            cfg = _cfg(arch, flags)
            batch = _tensors(_batch(cfg, seq))
            try:
                res[name] = _grads(shard_params(_params(cfg), rules, cfg),
                                   batch, cfg, rules)
            except ValueError as e:
                res[name] = {"raised": str(e)}
        if shape == (2, 2):  # the MoE references sharded on (2, 2)
            cfg = _cfg(MOE_ARCH, {}, moe_cf=1.25)
            res["moe_loss"] = _grads(shard_params(_params(cfg), rules, cfg),
                                     _tensors(_batch(cfg, S)), cfg, rules)
            x, p, c = _moe_inputs(cfg)
            with compat.use_mesh(mesh):
                local = _layer_blocks(_tensors(p), rules, cfg)
                local = {k: v.clone().requires_grad_(True)
                         for k, v in local.items()}
                xl = cut(torch.from_numpy(x), 0, "data").clone() \
                    .requires_grad_(True)
                y, aux, drop = moe_ffn(xl, local, cfg, rules=rules)
                obj = compat.psum((y * cut(torch.from_numpy(c), 0, "data"))
                                  .sum(), "data") \
                    + compat.psum(aux, "data") / 2
                obj.backward()
            res["moe"] = {"x": xl.grad,
                          **{k: v.grad for k, v in local.items()}}
            res["moe_drop"] = float(drop)
        if shape in ((1, 2), (2, 2)):
            with compat.use_mesh(mesh):
                res["collectives"] = {op: _collective_case(op, shape)
                                      for op in COLLECTIVES}
        for name in ADAM_CASES:
            _, arch, flags, _ = _case(name)
            cfg = _cfg(arch, flags)
            if tag == "1x3" or (cfg.moe_num_experts
                                and cfg.moe_num_experts % shape[1]):
                continue
            params = _owned(shard_params(_params(cfg), rules, cfg))
            grads = shard_params(_unflat(_tensors(_grad_tree(cfg)),
                                         _params(cfg)), rules, cfg)
            state = adamw_init(params)
            norms = []
            for _ in range(2):
                with compat.use_mesh(mesh):
                    params, state, m = adamw_update(
                        grads, state, params, AdamWConfig(**ADAM_CFG),
                        split_axes=split_axes(cfg, rules))
                norms.append(float(m["grad_norm"]))
            res[f"adam-{name}"] = (norms, {
                k: torch.from_numpy(v) for k, v in _flat(params, "").items()})
        for arch, meshes in STEP_CASES:
            if tag not in meshes:
                continue
            cfg = _cfg(arch, {})
            params = _owned(shard_params(_params(cfg), rules, cfg))
            params, _, m = mesh_train_step(
                params, adamw_init(params),
                _tensors(_batch(cfg, S, STEP_B)), cfg,
                AdamWConfig(**STEP_CFG), rules=rules, n_micro=N_MICRO)
            res[f"step-{arch}"] = (m, {
                k: torch.from_numpy(v) for k, v in _flat(params, "").items()})
    finally:
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, res)
        if rank == 0:
            torch.save(gathered, out_path)
        dist.destroy_process_group()


def _layer_blocks(p, rules, cfg):
    """One layer's leaves cut to this rank's blocks by their per-layer
    specs."""
    from repro_torch.distributed.sharding import shard_params

    stacked = shard_params({"segments": [{k: v[None] for k, v in
                                          p.items()}]}, rules, cfg)
    return {k: v[0] for k, v in stacked["segments"][0].items()}


def _one_world(rank, world, rdzv, out_path, _):
    """A (1, 1) mesh: ``loss_fn``'s gradients of every case and
    ``mesh_train_step`` under the mesh (every collective skipped) equal
    the unsharded ones bit for bit."""
    from repro_torch.distributed import compat, multihost
    from repro_torch.distributed.sharding import MeshRules
    from repro_torch.launch.train import mesh_train_step
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=rdzv, rank=rank,
                            world_size=world,
                            timeout=multihost.GROUP_TIMEOUT)
    rules = MeshRules(compat.make_mesh((1, 1), ("data", "model")))
    res = {}
    try:
        for name, arch, flags, seq in CASES:
            cfg = _cfg(arch, flags)
            batch = _tensors(_batch(cfg, seq))
            a, b = (_grads(_params(cfg), batch, cfg, r)
                    for r in (None, rules))
            res[name] = a[:3] == b[:3] and all(
                torch.equal(a[3][k], b[3][k]) for k in a[3])
        for arch, _ in STEP_CASES:
            cfg = _cfg(arch, {})
            outs = []
            for r in (None, rules):
                params = _params(cfg)
                state = adamw_init(params)
                for _ in range(3):
                    params, state, m = mesh_train_step(
                        params, state, _tensors(_batch(cfg, S, STEP_B)), cfg,
                        AdamWConfig(**STEP_CFG), rules=r, n_micro=N_MICRO)
                outs.append((m, _flat(params, "")))
            (ma, pa), (mb, pb) = outs
            res[f"step-{arch}"] = ma == mb and all(
                np.array_equal(pa[k], pb[k]) for k in pa)
    finally:
        torch.save(res, out_path)
        dist.destroy_process_group()


_WORLDS: dict = {}


def _world(mesh: str):
    """Run a mesh's world once per module (every rank's results)."""
    from repro_torch.distributed.multihost import spawn_ranks

    if mesh not in _WORLDS:
        if mesh == "1x1":
            _WORLDS[mesh] = spawn_ranks(1, _one_world, None,
                                        deadline_s=SPAWN_DEADLINE_S)
        else:
            shape = MESHES[mesh]
            _WORLDS[mesh] = spawn_ranks(shape[0] * shape[1], _grad_world,
                                        shape, deadline_s=SPAWN_DEADLINE_S)
    return _WORLDS[mesh]


@pytest.fixture(scope="module")
def worlds(jax_proc):
    """Every world, run while the JAX subprocess computes."""
    return {m: _world(m) for m in ("1x1", *MESHES)}


# ------------------------------------------------------------------- checks
class _Rules:
    """A mesh's sizes, for ``leaf_spec`` without a process group."""

    tp_axis = "model"
    mesh = True

    def __init__(self, shape):
        self.sizes = dict(zip(("data", "model"), shape))
        self.tp_size, self.dp_size = shape[1], shape[0]
        self.dp_axes = ("data",)

    def fsdp_axes(self):
        return self.dp_axes


def _block(arr, path, shape, cfg, coords):
    """This rank's block of JAX's whole leaf ``arr`` by its spec."""
    from repro_torch.distributed.sharding import leaf_spec

    rules = _Rules(shape)
    for dim, axes in enumerate(leaf_spec(path, arr.shape, rules, cfg)):
        if axes is None:
            continue
        idx, n = 0, 1
        for a in ((axes,) if isinstance(axes, str) else axes):
            idx, n = idx * rules.sizes[a] + coords[a], n * rules.sizes[a]
        step = arr.shape[dim] // n
        arr = arr[(slice(None),) * dim + (slice(idx * step,
                                                (idx + 1) * step),)]
    return arr


def _close(got, want, scale, what, tol=TOL):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * max(scale, 1e-30), (what, err, scale)


def _check_blocks(ranks, refs, prefix, cfg, shape, what, grads_of):
    for r in ranks:
        for path, g in grads_of(r).items():
            whole = refs[f"{prefix}/{path}"]
            _close(g, _block(whole, path, shape, cfg, r["coords"]), float(
                np.abs(whole).max()), f"{what} rank {r['coords']} {path}")


@pytest.mark.parametrize("mesh,case", [
    (m, c[0]) for m in sorted(MESHES) for c in CASES
    if not (m == "2x2" and c[1] in MOE_ARCHS)])
def test_loss_fn_gradients_match_jax(worlds, jax_refs, mesh, case):
    """Each rank's gradient block of every leaf, and the loss, against
    JAX's unsharded ``jax.grad`` of ``loss_fn``; at (1, 3) the MoE archs
    raise.  (A MoE arch at dp 2 is held to JAX's sharded gradient:
    ``test_moe_loss_fn_on_a_2x2_mesh``.)"""
    _, arch, flags, seq = _case(case)
    ranks = worlds[mesh]
    if mesh == "1x3" and arch in MOE_ARCHS:
        for r in ranks:
            assert "experts do not divide the model axis" in \
                r[case]["raised"]
        return
    ref = _ref_key(arch, seq)
    cfg = _cfg(arch, flags)
    for r in ranks:
        loss, ce, aux, _ = r[case]
        assert abs(loss - float(jax_refs[f"{ref}/loss"])) <= \
            TOL * abs(float(jax_refs[f"{ref}/loss"])), (mesh, case, loss)
        assert abs(aux - float(jax_refs[f"{ref}/aux"])) <= 1e-6 + TOL * abs(
            float(jax_refs[f"{ref}/aux"]))
    _check_blocks([{"coords": r["coords"], "g": r[case][3]} for r in ranks],
                  jax_refs, f"{ref}/grad", cfg, MESHES[mesh],
                  f"{mesh} {case}", lambda r: r["g"])


def test_moe_loss_fn_on_a_2x2_mesh(worlds, jax_refs):
    """A MoE arch's ``loss_fn`` at dp 2 and the default capacity against
    JAX's sharded ``jax.grad`` on a real (2, 2) mesh: the loss and ce,
    the aux value (dp shard 0's, as JAX reports it) and every rank's
    gradient blocks (the aux term's gradient the dp shards' mean)."""
    cfg = _cfg(MOE_ARCH, {}, moe_cf=1.25)
    ranks = worlds["2x2"]
    for r in ranks:
        loss, ce, aux, _ = r["moe_loss"]
        for name, v in (("loss", loss), ("ce", ce), ("aux", aux)):
            want = float(jax_refs[f"moe_loss/{name}"])
            assert abs(v - want) <= TOL * abs(want), (name, v, want)
    _check_blocks([{"coords": r["coords"], "g": r["moe_loss"][3]}
                   for r in ranks], jax_refs, "moe_loss/grad", cfg, (2, 2),
                  "2x2 moe loss_fn", lambda r: r["g"])


def test_moe_ffn_gradients_on_a_2x2_mesh(worlds, jax_refs):
    """``moe_ffn`` expert-parallel on (data 2, model 2) at its default
    capacity (each data shard's tokens; drops happen): the gradients of
    sum(y c) + aux with respect to x and every leaf, each rank's block
    against JAX's sharded ``jax.grad``."""
    cfg = _cfg(MOE_ARCH, {}, moe_cf=1.25)
    assert max(r["moe_drop"] for r in worlds["2x2"]) > 0  # capacity binds
    for r in worlds["2x2"]:
        g = r["moe"]
        want = jax_refs["moe/grad/x"]
        half = want.shape[0] // 2
        d = r["coords"]["data"]
        _close(g["x"], want[d * half:(d + 1) * half],
               float(np.abs(want).max()), "moe dx")
        for name, grad in g.items():
            if name != "x":
                whole = jax_refs[f"moe/grad/p/{name}"]
                _close(grad, _block(whole, name, (2, 2), cfg, r["coords"]),
                       float(np.abs(whole).max()), f"moe d{name}")


@pytest.mark.parametrize("op", COLLECTIVES)
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_collectives_differentiate(worlds, mesh, op):
    """Each differentiable collective (``compat``'s psum, all_gather,
    psum_scatter, ppermute and pvary; ``_tp``'s cut and activation
    gather) on a scalar objective: every rank's gradient of its input
    equals the gradient of the whole function (all ranks' inputs at
    once) with respect to that rank's.  On (2, 2) over both axes, the
    cut, gather and pvary over the model axis."""
    for r in worlds[mesh]:
        got, want = r["collectives"][op]
        assert torch.allclose(got, want, atol=1e-6, rtol=1e-6), (mesh, op)


@pytest.mark.parametrize("case", ADAM_CASES)
@pytest.mark.parametrize("mesh", ["1x2", "1x4", "2x2"])
def test_adamw_update_sharded(worlds, jax_refs, mesh, case):
    """Two ``adamw_update(split_axes=)`` steps on each rank's blocks of a
    seeded gradient: the global grad norm (each leaf's squares summed
    over the axes it is split across) and every updated block against
    JAX's ``adamw_update`` of the whole tree."""
    _, arch, flags, _ = _case(case)
    cfg = _cfg(arch, flags)
    ref = f"adam-{case}"
    for r in worlds[mesh]:
        norms, after = r[ref]
        for step, got in enumerate(norms):
            want = float(jax_refs[f"{ref}/grad_norm/{step}"])
            assert abs(got - want) <= 1e-6 * want, (mesh, case, step)
    _check_blocks([{"coords": r["coords"], "p": r[ref][1]}
                   for r in worlds[mesh]], jax_refs, f"{ref}/after", cfg,
                  MESHES[mesh], f"{mesh} {case} adamw", lambda r: r["p"])


@pytest.mark.parametrize("arch,mesh", [(a, m) for a, ms in STEP_CASES
                                       for m in ms])
def test_mesh_train_step_microbatches(worlds, jax_refs, arch, mesh):
    """``mesh_train_step`` with ``n_micro`` 2 (float32 accumulation of
    the microbatches' gradients, divided by 2; the loss their mean, ce
    the last one's) then the sharded AdamW, against the same
    accumulation written with JAX's ``value_and_grad``: loss, ce, grad
    norm and every rank's updated blocks."""
    cfg = _cfg(arch, {})
    ref = f"step-{arch}"
    for r in worlds[mesh]:
        m, _ = r[ref]
        for name in ("loss", "ce", "grad_norm"):
            want = float(jax_refs[f"{ref}/{name}"])
            assert abs(m[name] - want) <= TOL * abs(want), (mesh, name)
    _check_blocks([{"coords": r["coords"], "p": r[ref][1]}
                   for r in worlds[mesh]], jax_refs, f"{ref}/after", cfg,
                  MESHES[mesh], f"{mesh} {arch} step", lambda r: r["p"])


@pytest.mark.parametrize("case", [c[0] for c in CASES]
                         + [f"step-{a}" for a, _ in STEP_CASES])
def test_mesh_of_one_is_the_unsharded_program(worlds, case):
    """On a (1, 1) mesh ``loss_fn``'s loss, metrics and gradients, and
    three ``mesh_train_step`` calls' metrics and parameters, equal the
    unsharded ones bit for bit."""
    assert worlds["1x1"][case]
