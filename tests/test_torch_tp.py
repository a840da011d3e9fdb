"""Port vs JAX package: the LM's sharded serving on ``torch.distributed``.

Each mesh runs as one spawned gloo world on the CPU (``multihost.
spawn_ranks``; every rank imports only torch, since the workers live in
this module and it imports JAX only inside functions): (1, 2), (1, 4),
(2, 2) and (1, 3) — the last divides none of the smoke configs' head
counts, widths or vocabulary, so every leaf takes its replicated
fallback — plus a (1, 1) world.  Every check of a mesh runs in its one
world, and rank 0 returns the gathered results.

JAX side: one subprocess with ``--xla_force_host_platform_device_count=4``
(the flag must be set before JAX starts) computes, in float32 and on the
same parameters, JAX's ``prefill`` and three ``decode_step``s with
``MeshRules(mesh=None)``, ``attend(window=)``, ``swa_attend_cp`` on a
(1, 1) mesh, and ``moe_ffn`` on a real (2, 2) mesh — with dp 2 the
capacity comes from each data shard's token count, so that one is held
against JAX's own sharded function.  It runs while the worlds do.

Cases: the smoke config of every LM architecture in float32, batch 4,
prompts of 32 tokens (64 for the context-parallel windowed prefill: past
the window of 32, two halo chunks at tp 4), a cache of 40 slots (split
over tp 2 and 4, whole at tp 3) and three teacher-forced decode steps;
and the flag paths: ``fsdp_only``, ``rwkv_batch_parallel``,
``seq_parallel_prefill`` and ``mla_absorb``.  The MoE archs run
drop-free here (``capacity_factor`` = E): a capacity that depends on
the data shard is what the (2, 2) ``moe_ffn`` case holds against JAX.
Tolerance: 1e-5 of max|logits| (and of max|cache|): the sharded program
sums partial products in another order.
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
B, S, S_CP, CACHE_LEN, STEPS = 4, 32, 64, 40, 3
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2), "1x3": (1, 3)}
LM_ARCHS = ("qwen2_5_32b", "deepseek_7b", "h2o_danube3_4b", "qwen2_72b",
            "rwkv6_3b", "musicgen_medium", "recurrentgemma_9b",
            "deepseek_v2_lite", "qwen3_moe_235b", "llava_next_34b")
MOE_ARCHS = ("deepseek_v2_lite", "qwen3_moe_235b")
# (case, arch, flags, prompt length); a flag case shares its arch's JAX
# reference unless the flag changes what JAX computes (mla_absorb) or the
# prompt differs
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
SWA_B, SWA_S, SWA_H, SWA_KVH, SWA_D, SWA_WINDOWS = 2, 64, 4, 2, 16, (24, 40)
MOE_B, MOE_S = 4, 16


def _ref_key(arch, flags, seq):
    return f"{arch}-{seq}" + ("-absorb" if flags.get("mla_absorb") else "")


def _cfg(arch, flags):
    from repro_torch.configs import smoke_config

    cfg = dataclasses.replace(smoke_config(arch), dtype_str="float32",
                              **flags)
    if cfg.moe_num_experts:  # drop-free: capacity T k
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=float(cfg.moe_num_experts))
    return cfg


def _params(cfg):
    from repro_torch.models import transformer as T

    return T.init_params(cfg, seed=0, device="cpu")


def _inputs(cfg, seq, seed=1):
    """(prefill inputs, the decode steps' inputs) as numpy, from a seed."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "embeddings":
        return ({"embeds": rng.standard_normal((B, seq, cfg.d_model))
                 .astype(np.float32)},
                [{"embeds": rng.standard_normal((B, cfg.d_model))
                  .astype(np.float32)} for _ in range(STEPS)])
    return ({"tokens": rng.integers(0, cfg.vocab_size, (B, seq))
             .astype(np.int32)},
            [{"tokens": rng.integers(0, cfg.vocab_size, (B,))
              .astype(np.int32)} for _ in range(STEPS)])


def _flat(tree, prefix):
    """path -> numpy of a parameter or cache tree."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
    else:
        out[prefix] = np.asarray(tree.detach().float().numpy()
                                 if torch.is_tensor(tree) else tree)
    return out


def _swa_inputs():
    rng = np.random.default_rng(3)
    return tuple(rng.standard_normal((SWA_B, SWA_S, n, SWA_D))
                 .astype(np.float32) for n in (SWA_H, SWA_KVH, SWA_KVH))


def _moe_layer(cfg):
    """The first MoE layer's FFN leaves."""
    seg = next(s for s in _params(cfg)["segments"] if "router" in s)
    return {k: v[0] for k, v in seg.items()
            if k.startswith(("router", "experts_", "shared_"))}


def _moe_inputs(cfg):
    """x and the router on a grid (their products exact in float32, so
    both packages route alike), the rest of the first MoE layer's
    leaves."""
    rng = np.random.default_rng(4)
    p = {k: v.numpy() for k, v in _moe_layer(cfg).items()}
    p["router"] = (rng.integers(-4, 5, p["router"].shape) / 8).astype(
        np.float32)
    x = (rng.integers(-4, 5, (MOE_B, MOE_S, cfg.d_model)) / 4).astype(
        np.float32)
    return x, p


# -------------------------------------------------------------- the JAX side
_JAX_SCRIPT = textwrap.dedent("""
    import os, sys, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import smoke_config
    from repro.distributed import MeshRules
    from repro.models import transformer as JT
    from repro.models.attention import attend, swa_attend_cp
    from repro.models.moe import moe_ffn

    inp = dict(np.load(sys.argv[1]))
    out = {}
    RULES = MeshRules(mesh=None)

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

    for ref in inp["refs"]:
        ref = str(ref)
        arch = str(inp[f"{ref}/arch"])
        cfg = dataclasses.replace(
            smoke_config(arch), dtype_str="float32",
            mla_absorb=bool(inp[f"{ref}/absorb"]))
        if cfg.moe_num_experts:
            cfg = dataclasses.replace(
                cfg, capacity_factor=float(cfg.moe_num_experts))
        params = tree(f"{ref}/params")
        key = "embeds" if cfg.frontend == "embeddings" else "tokens"
        x = jnp.asarray(inp[f"{ref}/in/{key}"])
        logits, caches, n = JT.prefill(params, cfg, RULES,
                                       cache_len=int(inp["cache_len"]),
                                       **{key: x})
        out[f"{ref}/logits/0"] = np.asarray(logits)
        for si, seg in enumerate(caches):
            for name, leaf in seg.items():
                out[f"{ref}/prefill_cache/{si}/{name}"] = np.asarray(leaf)
        for step in range(int(inp["steps"])):
            s = jnp.asarray(inp[f"{ref}/step{step}/{key}"])
            logits, caches, n = JT.decode_step(params, caches, n, cfg, RULES,
                                               **{key: s})
            out[f"{ref}/logits/{step + 1}"] = np.asarray(logits)
        for si, seg in enumerate(caches):
            for name, leaf in seg.items():
                out[f"{ref}/decode_cache/{si}/{name}"] = np.asarray(leaf)

    q, k, v = (jnp.asarray(inp[f"swa/{n}"]) for n in "qkv")
    for w in inp["swa_windows"]:
        out[f"swa/attend/{w}"] = np.asarray(attend(q, k, v, window=int(w)))
        rules1 = MeshRules(mesh=jax.make_mesh((1, 1), ("data", "model")))
        out[f"swa/cp1/{w}"] = np.asarray(
            swa_attend_cp(q, k, v, window=int(w), rules=rules1))

    mcfg = smoke_config(str(inp["moe/arch"]))
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    mp = {k.split("/")[-1]: jnp.asarray(inp[k]) for k in inp
          if k.startswith("moe/p/")}
    y, aux, drop = jax.jit(
        lambda x, p: moe_ffn(x, p, mcfg, MeshRules(mesh=mesh)))(
        jnp.asarray(inp["moe/x"]), mp)
    out["moe/y"] = np.asarray(y)
    order = {d: i for i, d in enumerate(mesh.devices.flat)}
    for name, a in (("aux", aux), ("drop", drop)):
        shards = sorted(a.addressable_shards, key=lambda s: order[s.device])
        out[f"moe/{name}"] = np.array([float(s.data) for s in shards])
    np.savez(sys.argv[2], **out)
    print("JAX_TP_OK")
""")


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """Write the inputs and start the JAX subprocess at once; ``jax_refs``
    collects it, so the worlds run while it does."""
    d = tmp_path_factory.mktemp("jax_tp")
    inp = {"cache_len": CACHE_LEN, "steps": STEPS,
           "swa_windows": np.array(SWA_WINDOWS)}
    refs = {}
    for _, arch, flags, seq in CASES:
        refs.setdefault(_ref_key(arch, flags, seq), (arch, flags, seq))
    for ref, (arch, flags, seq) in refs.items():
        cfg = _cfg(arch, flags)
        pre, steps = _inputs(cfg, seq)
        inp.update(_flat(_params(cfg), f"{ref}/params"))
        inp[f"{ref}/arch"] = arch
        inp[f"{ref}/absorb"] = bool(flags.get("mla_absorb"))
        inp.update({f"{ref}/in/{k}": v for k, v in pre.items()})
        for i, st in enumerate(steps):
            inp.update({f"{ref}/step{i}/{k}": v for k, v in st.items()})
    inp["refs"] = np.array(sorted(refs))
    for n, t in zip("qkv", _swa_inputs()):
        inp[f"swa/{n}"] = t
    x, p = _moe_inputs(_cfg("deepseek_v2_lite", {}))
    inp["moe/arch"], inp["moe/x"] = "deepseek_v2_lite", x
    inp.update({f"moe/p/{k}": v for k, v in p.items()})
    np.savez(d / "in.npz", **inp)
    (d / "tp.py").write_text(_JAX_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, str(d / "tp.py"), str(d / "in.npz"),
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
    assert "JAX_TP_OK" in stdout
    return dict(np.load(out))


# ------------------------------------------------------------ the port side
def _tp_world(rank, world, rdzv, out_path, shape):
    """One mesh's world: every case and check of that mesh; rank 0 saves
    the gathered results."""
    from repro_torch.distributed import compat, multihost
    from repro_torch.distributed._tp import cut, gather
    from repro_torch.distributed.sharding import (MeshRules, shard_params,
                                                  tree_bytes)
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import swa_attend_cp
    from repro_torch.models.moe import moe_ffn

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=rdzv, rank=rank,
                            world_size=world,
                            timeout=multihost.GROUP_TIMEOUT)
    mesh = compat.make_mesh(shape, ("data", "model"))
    rules = MeshRules(mesh)
    res = {}
    try:
        for name, arch, flags, seq in CASES:
            cfg = _cfg(arch, flags)
            params = _params(cfg)
            local = shard_params(params, rules, cfg)
            pre, steps = _inputs(cfg, seq)
            pre = {k: torch.from_numpy(v) for k, v in pre.items()}
            r = {"param_bytes": tree_bytes(local),
                 "param_bytes_whole": tree_bytes(params)}
            try:
                with torch.no_grad():
                    logits, caches, n = T.prefill(
                        local, cfg, cache_len=CACHE_LEN, rules=rules, **pre)
                    r["logits/0"] = T.gather_logits(logits, cfg, rules)
                    r["cache_bytes"] = tree_bytes(list(caches))
                    # a copy: the decode steps write the caches in place
                    r["prefill_cache"] = [
                        {k: v.clone() for k, v in seg.items()}
                        for seg in T.gather_caches(caches, cfg, rules)]
                    for i, st in enumerate(steps):
                        st = {k: torch.from_numpy(v) for k, v in st.items()}
                        logits, caches, n = T.decode_step(
                            local, caches, n, cfg, rules=rules, **st)
                        r[f"logits/{i + 1}"] = T.gather_logits(logits, cfg,
                                                               rules)
                    r["decode_cache"] = T.gather_caches(caches, cfg, rules)
                    if not flags:  # forward without gradients
                        got, _ = T.forward(local, cfg, rules=rules, **pre)
                        want, _ = T.forward(params, cfg, **pre)
                        got = T.gather_logits(got, cfg, rules)
                        r["forward_err"] = float(
                            (got - want).abs().max() / want.abs().max())
            except ValueError as e:
                r = {"raised": str(e)}
            res[name] = r
        if shape in ((1, 2), (1, 4)):  # swa_attend_cp over the model axis
            q, k, v = (torch.from_numpy(t) for t in _swa_inputs())
            with compat.use_mesh(mesh):
                for w in SWA_WINDOWS:
                    out = swa_attend_cp(*(cut(t, 1, "model")
                                          for t in (q, k, v)),
                                        window=w, rules=rules)
                    res[f"swa/{w}"] = gather(out, 1, "model")
        if shape == (2, 2):  # moe_ffn on JAX's (2, 2) mesh
            cfg = dataclasses.replace(_cfg("deepseek_v2_lite", {}),
                                      capacity_factor=1.25)
            x, p = _moe_inputs(cfg)
            p = {k: torch.from_numpy(v) for k, v in p.items()}
            with compat.use_mesh(mesh):
                local = _layer_blocks(p, rules, cfg)
                y, aux, drop = moe_ffn(cut(torch.from_numpy(x), 0, "data"),
                                       local, cfg, rules=rules)
                res["moe/y"] = gather(y, 0, "data")
                for nm, val in (("aux", aux), ("drop", drop)):
                    vals = [None] * dist.get_world_size()
                    dist.all_gather_object(vals, float(val))
                    res[f"moe/{nm}"] = vals
        if shape == (1, 2):
            # shared experts whose width (33) does not divide tp: added
            # once, as the unsharded function does
            cfg = dataclasses.replace(_cfg("deepseek_v2_lite", {}),
                                      moe_d_ff=33, capacity_factor=1.25)
            x = torch.from_numpy(_moe_inputs(cfg)[0])
            p = _moe_layer(cfg)
            with compat.use_mesh(mesh):
                got = moe_ffn(x, _layer_blocks(p, rules, cfg), cfg,
                              rules=rules)
            want = moe_ffn(x, p, cfg)
            res["shared_once"] = {
                "y_err": float((got[0] - want[0]).abs().max()),
                "y_scale": float(want[0].abs().max()),
                "aux_err": float((got[1] - want[1]).abs()),
                "drop": float(got[2]), "drop_unsharded": float(want[2])}
    finally:
        if rank == 0:
            torch.save(res, out_path)
        dist.destroy_process_group()


def _layer_blocks(p, rules, cfg):
    """One layer's leaves cut to this rank's blocks by their per-layer
    specs."""
    from repro_torch.distributed.sharding import shard_params

    stacked = shard_params({"segments": [{k: v[None] for k, v in
                                          p.items()}]}, rules, cfg)
    return {k: v[0] for k, v in stacked["segments"][0].items()}


def _one_world(rank, world, rdzv, out_path, _):
    """A (1, 1) mesh: every case through the program under the mesh (every
    collective skipped) gives the unsharded logits and caches bit for bit;
    and ``swa_attend_cp`` at ntp 1."""
    from repro_torch.distributed import compat, multihost
    from repro_torch.distributed.sharding import MeshRules
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import swa_attend_cp

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=rdzv, rank=rank,
                            world_size=world,
                            timeout=multihost.GROUP_TIMEOUT)
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    rules = MeshRules(mesh)
    res = {}
    try:
        for name, arch, flags, seq in CASES:
            cfg = _cfg(arch, flags)
            params = _params(cfg)
            pre, steps = _inputs(cfg, seq)
            pre = {k: torch.from_numpy(v) for k, v in pre.items()}
            outs = []
            for r in (None, rules):
                with torch.no_grad():
                    logits, caches, n = T.prefill(params, cfg, rules=r,
                                                  cache_len=CACHE_LEN, **pre)
                    got = [logits]
                    for st in steps:
                        st = {k: torch.from_numpy(v) for k, v in st.items()}
                        logits, caches, n = T.decode_step(
                            params, caches, n, cfg, rules=r, **st)
                        got.append(logits)
                outs.append((torch.stack(got), [
                    t for seg in caches for _, t in sorted(seg.items())]))
            (a, ca), (b, cb) = outs
            res[name] = bool(torch.equal(a, b)) and len(ca) == len(cb) \
                and all(torch.equal(x, y) for x, y in zip(ca, cb))
        q, k, v = (torch.from_numpy(t) for t in _swa_inputs())
        with compat.use_mesh(mesh):
            for w in SWA_WINDOWS:
                res[f"swa/{w}"] = swa_attend_cp(q, k, v, window=w,
                                                rules=rules)
    finally:
        torch.save(res, out_path)
        dist.destroy_process_group()


_WORLDS: dict = {}


def _world(mesh: str):
    """Run a mesh's world once per module (rank 0's results)."""
    from repro_torch.distributed.multihost import spawn_ranks

    if mesh not in _WORLDS:
        if mesh == "1x1":
            _WORLDS[mesh] = spawn_ranks(1, _one_world, None,
                                        deadline_s=SPAWN_DEADLINE_S)
        else:
            shape = MESHES[mesh]
            _WORLDS[mesh] = spawn_ranks(shape[0] * shape[1], _tp_world,
                                        shape, deadline_s=SPAWN_DEADLINE_S)
    return _WORLDS[mesh]


@pytest.fixture(scope="module")
def worlds(jax_proc):
    """Every world, run while the JAX subprocess computes."""
    return {m: _world(m) for m in ("1x1", *MESHES)}


# ------------------------------------------------------------------- checks
def _close(got, want, what):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_serving_matches_jax(worlds, jax_refs, mesh, case):
    """Gathered prefill logits and caches, three decode steps' logits and
    the caches after them, against JAX's unsharded functions; the MoE
    archs raise at (1, 3), where E = 8 does not divide tp, as JAX
    asserts."""
    _, arch, flags, seq = next(c for c in CASES if c[0] == case)
    got = worlds[mesh][case]
    if mesh == "1x3" and arch in MOE_ARCHS:
        assert "experts do not divide the model axis" in got["raised"]
        return
    assert "raised" not in got, got
    ref = _ref_key(arch, flags, seq)
    for i in range(STEPS + 1):
        _close(got[f"logits/{i}"], jax_refs[f"{ref}/logits/{i}"],
               f"{mesh} {case} logits {i}")
    for when in ("prefill_cache", "decode_cache"):
        for si, seg in enumerate(got[when]):
            for name, leaf in seg.items():
                _close(leaf, jax_refs[f"{ref}/{when}/{si}/{name}"],
                       f"{mesh} {case} {when} {si} {name}")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_forward_without_gradients(worlds, mesh):
    """``forward`` under the mesh (gradients off), gathered, against the
    port's unsharded ``forward`` (held to JAX's by
    ``test_torch_arch_smoke.py``)."""
    for arch in LM_ARCHS:
        got = worlds[mesh][arch]
        if "raised" in got:
            assert mesh == "1x3" and arch in MOE_ARCHS
            continue
        assert got["forward_err"] <= TOL, (mesh, arch, got["forward_err"])


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_each_rank_holds_its_blocks(worlds, mesh):
    """Per-rank bytes on a 4-rank mesh: the parameters exactly the sum of
    each leaf's size over the ranks its spec splits it across; the caches
    no more than the whole (RWKV6's state is whole over the model axis,
    since its recurrence runs on whole activations), and a quarter of it
    where every layer attends (its slots, and at (2, 2) its rows,
    split)."""
    from repro_torch.distributed.sharding import leaf_spec
    from repro_torch.models import transformer as T

    sizes = dict(zip(("data", "model"), MESHES[mesh]))

    class Rules:  # the mesh's sizes, for the specs
        tp_axis, tp_size, dp_axes = "model", sizes["model"], ("data",)
        dp_size, mesh = sizes["data"], True

        def fsdp_axes(self):
            return self.dp_axes

    for arch in LM_ARCHS:
        got, cfg = worlds[mesh][arch], _cfg(arch, {})
        abstract = T.abstract_params(cfg)
        leaves = [(k, abstract[k]) for k in ("embed", "final_norm",
                                             "lm_head")]
        leaves += [(f"segments/{i}/{k}", v) for i, seg in
                   enumerate(abstract["segments"]) for k, v in seg.items()]
        want = 0
        for path, leaf in leaves:
            split = 1
            for axes in leaf_spec(path, leaf.shape, Rules(), cfg):
                for a in (() if axes is None else (axes,) if isinstance(
                        axes, str) else axes):
                    split *= sizes[a]
            want += leaf.numel() * 4 // split
        assert got["param_bytes"] == want, (mesh, arch)
        assert got["param_bytes"] < got["param_bytes_whole"] / 2
        whole = sum(v.numel() * 4 for seg in got["prefill_cache"]
                    for v in seg.values())
        assert got["cache_bytes"] <= whole, (mesh, arch)
        if cfg.mixer == "attn":
            assert got["cache_bytes"] == whole // 4, (mesh, arch)


@pytest.mark.parametrize("ntp", [1, 2, 4])
def test_swa_attend_cp(worlds, jax_refs, ntp):
    """The context-parallel windowed attention: at ntp 2 and 4 against
    JAX's ``attend(window=)`` (window 40 reaches past the left end at
    ntp 2 and 4, where the wrapped halo must be masked), at ntp 1 against
    JAX's ``swa_attend_cp`` on a (1, 1) mesh."""
    world = worlds[{1: "1x1", 2: "1x2", 4: "1x4"}[ntp]]
    for w in SWA_WINDOWS:
        want = jax_refs[f"swa/{'cp1' if ntp == 1 else 'attend'}/{w}"]
        got = world[f"swa/{w}"]
        assert np.abs(got.numpy() - want).max() <= 2e-5, (ntp, w)


def test_mesh_of_one_changes_nothing(worlds):
    """``rules`` with a (1, 1) mesh, for every case (the flag paths
    included): the same logits after prefill and three decode steps, and
    the same caches, bit for bit."""
    differ = [c[0] for c in CASES if not worlds["1x1"][c[0]]]
    assert not differ, differ


def test_moe_ffn_matches_jax_on_a_2x2_mesh(worlds, jax_refs):
    """``moe_ffn`` expert-parallel on (data 2, model 2) against JAX's
    ``shard_map`` path: the capacity of each data shard's 32 tokens
    (drops happen), the output, and each device's aux loss and drop
    fraction."""
    got = worlds["2x2"]
    _close(got["moe/y"], jax_refs["moe/y"], "moe y")
    np.testing.assert_allclose(got["moe/aux"], jax_refs["moe/aux"],
                               rtol=1e-5)
    np.testing.assert_array_equal(got["moe/drop"], jax_refs["moe/drop"])
    assert max(got["moe/drop"]) > 0  # the capacity binds


def test_shared_experts_added_once(worlds):
    """Shared experts 33 wide at tp 2 are replicated; the port adds them
    once (JAX's psum would count them twice; ROADMAP queue 3): the
    expert-parallel output and aux loss equal the unsharded function's.
    The drop fraction is JAX's maximum over the model axis of each rank's
    own experts' drops, so at most the unsharded total."""
    got = worlds["1x2"]["shared_once"]
    assert got["y_err"] <= TOL * got["y_scale"] and got["aux_err"] <= 1e-6
    assert 0 < got["drop"] <= got["drop_unsharded"]


@pytest.mark.parametrize("H,KVH,tp", [(16, 1, 4), (64, 4, 8), (4, 2, 4),
                                      (40, 8, 5), (12, 4, 6), (56, 8, 7)])
def test_mixed_heads_read_their_own_kv_heads(H, KVH, tp):
    """Where wq is column-parallel and wk/wv fall back to whole K/V (H
    divides tp, KVH does not), each rank's query head h reads KV head
    h // G through ``attend``'s grouping of the K/V it is given."""
    from repro_torch.models.transformer import _kv_for_heads

    G, hq = H // KVH, H // tp
    k = torch.arange(KVH, dtype=torch.float32).reshape(1, 1, KVH, 1)
    for rank in range(tp):
        q0 = rank * hq
        ka, _ = _kv_for_heads(k, k, q0, hq, G)
        kv = ka.shape[2]
        assert hq % kv == 0
        got = [int(ka[0, 0, i // (hq // kv), 0]) for i in range(hq)]
        assert got == [(q0 + i) // G for i in range(hq)], (rank, got)
