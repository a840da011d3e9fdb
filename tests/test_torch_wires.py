"""Port vs JAX package: the secure multi-device wires.

``secure_psum`` (per-leaf oracle, flat replicated, flat sharded, sharded
with ``out="tile"``), ``secure_psum_2d`` on a (pod, share) mesh,
``run_scanned_rounds`` in both reveal modes and ``compressed_psum``, the
ports of what ``tests/test_secure_psum.py`` and ``tests/test_multihost.py``
hold the JAX package to.

JAX side: one subprocess with a forced host device count (it must be set
before jax starts) runs every case and writes an ``.npz``.  Port side:
one spawned gloo world of D = 3 ranks (rows pad to lcm(8, 3) = 24 in the
sharded mode) runs the 1D cases, and one of 6 ranks the 3 x 2 mesh; each
world returns rank 0's outputs after checking every rank got the same.
Every process group has a 120 s timeout and every spawn is joined within
240 s, so a hung collective fails its test instead of the run.

Tolerances: a reveal does not depend on the sharing randomness (Lagrange
reconstruction cancels the polynomials exactly), so every reveal, the
scanned rounds' values and the 2D reveal are bit-identical to the JAX
package's although the two draw their polynomials from different
generators.  ``compressed_psum`` runs the same float32 operations in the
same order: bit-identical too.
"""
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
SEED = 5

_JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=6"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.core.secure_agg import SecureAggregator, secure_psum
    from repro.distributed.compat import shard_map
    from repro.distributed.multihost import (
        pod_mesh, pod_share_mesh, secure_psum_2d, run_scanned_rounds)
    from repro.optim.compression import compressed_psum

    inputs = np.load(sys.argv[1])
    tree = {"g": jnp.asarray(inputs["g"]), "h": jnp.asarray(inputs["h"])}
    mesh = pod_mesh(3)

    def run(fn, m=mesh):
        return shard_map(fn, mesh=m, in_specs=(), out_specs=P(),
                         check_vma=False)()

    out = {}
    for name, backend, reveal in (("reference", "reference", "replicated"),
                                  ("replicated", "pallas", "replicated"),
                                  ("sharded", "pallas", "sharded")):
        agg = SecureAggregator(backend=backend)
        r = run(lambda: secure_psum(tree, "pod", jax.random.PRNGKey(5),
                                    aggregator=agg, reveal=reveal))
        for k in tree:
            out[f"{name}_{k}"] = np.asarray(r[k])
    agg = SecureAggregator(backend="pallas")
    r = run(lambda: secure_psum(tree, "pod", jax.random.PRNGKey(5),
                                aggregator=agg, reveal="sharded",
                                out="tile").gather("pod"))
    for k in tree:
        out[f"tile_{k}"] = np.asarray(r[k])
    r = run(lambda: secure_psum_2d(tree, jax.random.PRNGKey(5),
                                   aggregator=agg), pod_share_mesh(3, 2))
    for k in tree:
        out[f"2d_{k}"] = np.asarray(r[k])
    for reveal in ("replicated", "sharded"):
        final, trace = run_scanned_rounds(3, tree, jax.random.PRNGKey(7), 4,
                                          aggregator=agg, reveal=reveal)
        for k in tree:
            out[f"scan_{reveal}_{k}"] = np.asarray(final[k])
        out[f"scan_{reveal}_trace"] = np.asarray(trace)

    def comp(gs, es):
        m, e = compressed_psum({"w": gs[0]}, "pod", {"w": es[0]})
        return m["w"], e["w"][None]

    m, e = shard_map(comp, mesh=mesh, in_specs=(P("pod"), P("pod")),
                     out_specs=(P(), P("pod")), check_vma=False)(
        jnp.asarray(inputs["grads"]), jnp.asarray(inputs["efb"]))
    out["comp_mean"], out["comp_resid"] = np.asarray(m), np.asarray(e)
    np.savez(sys.argv[2], **out)
    print("JAX_WIRES_OK")
""")


def _inputs():
    """The numpy inputs both packages take, from a seed: the JAX tests'
    tree (300 normals and a 4 x 4 leaf) and three pods' gradients and
    error-feedback residuals."""
    rng = np.random.default_rng(11)
    return {
        "g": (0.5 * rng.normal(size=300)).astype(np.float32),
        "h": np.full((4, 4), 3.25, dtype=np.float32),
        "grads": (rng.normal(size=(3, 300))
                  * np.array([[1.0], [3.0], [0.5]])).astype(np.float32),
        "efb": (rng.normal(size=(3, 300)) * 1e-3).astype(np.float32),
    }


def _tree(inp):
    return {"g": torch.as_tensor(inp["g"]), "h": torch.as_tensor(inp["h"])}


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """Start the JAX subprocess at once; ``jax_wires`` collects it, so the
    port's worlds run while it does."""
    d = tmp_path_factory.mktemp("jax_wires")
    np.savez(d / "in.npz", **_inputs())
    (d / "wires.py").write_text(_JAX_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, str(d / "wires.py"), str(d / "in.npz"),
         str(d / "out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield proc, d / "out.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_wires(jax_proc):
    proc, out = jax_proc
    try:
        stdout, stderr = proc.communicate(timeout=420)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, stderr[-2000:]
    assert "JAX_WIRES_OK" in stdout
    return dict(np.load(out))


def _agree(outs: dict) -> bool:
    """Every rank of the world holds the same outputs as rank 0."""
    flat = {k: v.numpy() for k, v in _flatten(outs)}
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, flat)
    return all(set(g) == set(flat)
               and all(np.array_equal(g[k], flat[k]) for k in flat)
               for g in gathered)


def _flatten(outs, prefix=""):
    for k, v in outs.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}_")
        elif isinstance(v, torch.Tensor):
            yield f"{prefix}{k}", v


def _world_1d(rank, world, rdzv, out_path, inp):
    """D = 3 ranks: every 1D case, the error paths and the guards."""
    from repro_torch.core.collective import SecureCollective, secure_psum
    from repro_torch.core.shamir import ShamirScheme
    from repro_torch.distributed import compat, multihost
    from repro_torch.optim.compression import compressed_psum

    dist.init_process_group("gloo", init_method=rdzv, rank=rank,
                            world_size=world,
                            timeout=multihost.GROUP_TIMEOUT)
    tree, out, raised = _tree(inp), {}, {}
    with compat.use_mesh(multihost.pod_mesh(world)):
        for name, backend, reveal in (
                ("reference", "reference", "replicated"),
                ("replicated", "kernel", "replicated"),
                ("sharded", "kernel", "sharded")):
            out[name] = secure_psum(
                tree, "pod", SEED, reveal=reveal,
                aggregator=SecureCollective(backend=backend))
        agg = SecureCollective(backend="kernel")
        tile = secure_psum(tree, "pod", SEED, aggregator=agg,
                           reveal="sharded", out="tile")
        out["tile"] = tile.gather("pod")
        out["tile_rows"] = torch.tensor(tile.tile.shape)
        out["fragments"] = {str(leaf): frag for leaf, (_, _, frag) in
                            tile.local_fragments(rank).items()}
        # any t-subset of a (2, 5) scheme reveals the same bits
        agg25 = SecureCollective(backend="kernel", scheme=ShamirScheme(
            threshold=2, num_shares=5))
        out["points25"] = secure_psum(tree, "pod", SEED, aggregator=agg25,
                                      reveal="sharded", points=(2, 5))
        for reveal in ("replicated", "sharded"):
            final, trace = multihost.run_scanned_rounds(
                world, tree, 7, 4, reveal=reveal, device="cpu")
            out[f"scan_{reveal}"] = final
            out[f"scan_{reveal}_trace"] = trace
        mean, resid = compressed_psum(
            {"w": torch.as_tensor(inp["grads"][rank])}, "pod",
            {"w": torch.as_tensor(inp["efb"][rank])})
        out["comp_mean"] = mean["w"]
        out["comp_resid"] = compat.all_gather(resid["w"][None], "pod")
        stats = compat.wire_stats()
        out["host_staged"] = torch.tensor(stats.get("host_staged", 0))

        def raises(name, fn, match):
            try:
                fn()
            except ValueError as e:
                raised[name] = match in str(e)
            else:
                raised[name] = False

        agg35 = SecureCollective(backend="kernel", scheme=ShamirScheme(
            threshold=3, num_shares=5))
        raises("below_threshold", lambda: secure_psum(
            tree, "pod", SEED, aggregator=agg35, points=(1, 2)),
            "irrecoverable")
        raises("below_threshold_reference", lambda: secure_psum(
            tree, "pod", SEED, points=(1, 2), aggregator=SecureCollective(
                scheme=ShamirScheme(threshold=3, num_shares=5,
                                    backend="reference"))),
            "irrecoverable")
        raises("tile_without_sharded", lambda: secure_psum(
            tree, "pod", SEED, out="tile"), "sharded")
        raises("sharded_on_reference", lambda: secure_psum(
            tree, "pod", SEED, reveal="sharded",
            aggregator=SecureCollective(backend="reference")), "sharded")
        raises("unknown_reveal", lambda: secure_psum(
            tree, "pod", SEED, reveal="scattered"), "reveal")
        raises("2d_needs_kernel", lambda: multihost.secure_psum_2d(
            tree, SEED, aggregator=SecureCollective(backend="reference")),
            "flat-buffer")
        # the exact-sum bound guards the axis size D: 2**33 pods of 31-bit
        # residues would overflow the int64 accumulator
        real = compat.axis_size
        compat.axis_size = lambda name: 2**33
        try:
            raises("headroom", lambda: secure_psum(tree, "pod", SEED),
                   "cannot aggregate")
        finally:
            compat.axis_size = real
        # every output but this rank's own tile fragments
        out["agree"] = torch.tensor(_agree(
            {k: v for k, v in out.items() if k != "fragments"}))
    if rank == 0:
        torch.save((out, raised), out_path)
    dist.destroy_process_group()


def _world_2d(rank, world, rdzv, out_path, inp):
    """A 3 x 2 (pod, share) mesh: the 2D wire, the 1D wire over its pod
    axis, and a share column seeded differently."""
    from repro_torch.core.collective import SecureCollective, secure_psum
    from repro_torch.core.shamir import ShamirScheme
    from repro_torch.distributed import compat, multihost

    dist.init_process_group("gloo", init_method=rdzv, rank=rank,
                            world_size=world,
                            timeout=multihost.GROUP_TIMEOUT)
    tree, out, raised = _tree(inp), {}, {}
    mesh = multihost.pod_share_mesh(3, 2)
    with compat.use_mesh(mesh):
        out["coords"] = torch.tensor([compat.axis_index("pod"),
                                      compat.axis_index("share"),
                                      compat.axis_size("pod"),
                                      compat.axis_size("share")])
        out["2d"] = multihost.secure_psum_2d(tree, SEED)
        out["1d"] = secure_psum(tree, "pod", SEED)
        # share column 1 draws pod i's polynomial from another seed: its
        # slices no longer lie on the polynomial column 0 evaluates
        real = SecureCollective.round_key
        if compat.axis_index("share") == 1:
            SecureCollective.round_key = staticmethod(
                lambda seed, slot, device: real(seed + 1, slot, device))
        try:
            out["misseeded"] = multihost.secure_psum_2d(tree, SEED)
        finally:
            SecureCollective.round_key = staticmethod(real)
        try:
            multihost.secure_psum_2d(tree, SEED, aggregator=SecureCollective(
                backend="kernel", scheme=ShamirScheme(threshold=3,
                                                      num_shares=3)))
            raised["share_axis_size"] = False
        except ValueError as e:
            raised["share_axis_size"] = "one center per revealed" in str(e)
        out["agree"] = torch.tensor(_agree(
            {k: v for k, v in out.items() if k not in ("coords",
                                                       "misseeded")}))
    if rank == 0:
        torch.save((out, raised), out_path)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port_1d(jax_proc):
    from repro_torch.distributed.multihost import spawn_ranks

    return spawn_ranks(3, _world_1d, _inputs(),
                        deadline_s=SPAWN_DEADLINE_S)


@pytest.fixture(scope="module")
def port_2d(jax_proc):
    from repro_torch.distributed.multihost import spawn_ranks

    return spawn_ranks(6, _world_2d, _inputs(),
                        deadline_s=SPAWN_DEADLINE_S)


def _assert_tree_equal(got, jax_out, name):
    for k in ("g", "h"):
        np.testing.assert_array_equal(got[k].numpy(), jax_out[f"{name}_{k}"])


@pytest.mark.parametrize("name", ["reference", "replicated", "sharded",
                                  "tile"])
def test_secure_psum_bit_identical_to_jax(port_1d, jax_wires, name):
    """Every wire format and reveal mode at D = 3 reveals what the JAX
    package reveals, bit for bit, and D * tree within quantization."""
    out, _ = port_1d
    _assert_tree_equal(out[name], jax_wires, name)
    inp = _inputs()
    for k in ("g", "h"):
        np.testing.assert_allclose(out[name][k].numpy(), 3 * inp[k],
                                   atol=1e-5)


def test_every_rank_gets_the_same_reveal(port_1d, port_2d):
    assert bool(port_1d[0]["agree"]) and bool(port_2d[0]["agree"])


def test_any_t_subset_reveals_the_same_bits(port_1d):
    out, _ = port_1d
    for k in ("g", "h"):
        assert torch.equal(out["points25"][k], out["replicated"][k])


def test_sharded_tile_rows_and_fragments(port_1d):
    """D = 3: rows pad to lcm(8, 3) = 24, each rank decodes 8 of them, and
    rank 0's tile holds the whole 300-element leaf and the 16 of the next
    (2 of 24 rows hold data)."""
    out, _ = port_1d
    assert tuple(out["tile_rows"].tolist()) == (8, 128)
    frags = out["fragments"]
    assert sorted(frags) == ["0", "1"]
    np.testing.assert_array_equal(frags["0"].numpy(),
                                  out["tile"]["g"].numpy())
    np.testing.assert_array_equal(frags["1"].numpy(),
                                  out["tile"]["h"].numpy().reshape(-1))


@pytest.mark.parametrize("reveal", ["replicated", "sharded"])
def test_scanned_rounds_bit_identical_to_jax(port_1d, jax_wires, reveal):
    """Round 1 reveals 3 * tree, every later round preserves the mean; the
    final tree and the (4,) trace are the JAX package's, bit for bit."""
    out, _ = port_1d
    _assert_tree_equal(out[f"scan_{reveal}"], jax_wires, f"scan_{reveal}")
    trace = out[f"scan_{reveal}_trace"]
    assert tuple(trace.shape) == (4,)
    np.testing.assert_array_equal(trace.numpy(),
                                  jax_wires[f"scan_{reveal}_trace"])
    inp = _inputs()
    for k in ("g", "h"):
        np.testing.assert_allclose(out[f"scan_{reveal}"][k].numpy(), inp[k],
                                   atol=1e-4)


def test_compressed_psum_bit_identical_to_jax(port_1d, jax_wires):
    out, _ = port_1d
    np.testing.assert_array_equal(out["comp_mean"].numpy(),
                                  jax_wires["comp_mean"])
    np.testing.assert_array_equal(out["comp_resid"].numpy(),
                                  jax_wires["comp_resid"])


@pytest.mark.parametrize("case", [
    "below_threshold", "below_threshold_reference", "tile_without_sharded",
    "sharded_on_reference", "unknown_reveal", "2d_needs_kernel",
    "headroom"])
def test_wire_errors_raise_as_in_jax(port_1d, case):
    """Below-threshold points, ``out="tile"`` without the sharded reveal,
    the sharded reveal on the reference backend, an unknown reveal, the 2D
    wire off the flat buffer and an axis too large for the exact int64
    sum all raise ``ValueError``, as in the JAX package."""
    assert port_1d[1][case]


def test_host_tensors_stage_nothing(port_1d):
    assert int(port_1d[0]["host_staged"]) == 0


def test_2d_bit_identical_to_1d_and_jax(port_2d, jax_wires):
    """The distributed Lagrange reveal on a 3 x 2 mesh equals the 1D wire
    over the same mesh's pod axis and the JAX package's 2D wire, bit for
    bit."""
    out, raised = port_2d
    for k in ("g", "h"):
        assert torch.equal(out["2d"][k], out["1d"][k])
    _assert_tree_equal(out["2d"], jax_wires, "2d")
    _assert_tree_equal(out["1d"], jax_wires, "replicated")
    assert raised["share_axis_size"]


def test_2d_mesh_coordinates(port_2d):
    """Rank 0 sits at (pod 0, share 0) of a 3 x 2 mesh."""
    assert tuple(port_2d[0]["coords"].tolist()) == (0, 0, 3, 2)


def test_misseeded_share_column_breaks_the_reveal(port_2d):
    """The 2D wire needs every center of a pod to draw the same polynomial:
    one column seeded differently reveals garbage, so the bit-identity
    above is known to catch a seeding fault."""
    out, _ = port_2d
    for k in ("g", "h"):
        assert not torch.allclose(out["misseeded"][k], out["1d"][k],
                                  atol=1.0)


def test_headroom_bound_is_the_int64_accumulators():
    """The port's exact-sum bound: D * max(p) < 2**63 (the JAX package's
    uint64 accumulator allows 2**64)."""
    from repro_torch.core.collective import check_aggregation_headroom
    from repro_torch.core.field import FIELD_WIDE

    check_aggregation_headroom(2**32, FIELD_WIDE)
    with pytest.raises(ValueError, match="2\\*\\*63"):
        check_aggregation_headroom(2**33, FIELD_WIDE)


def test_axis_names_need_a_mesh():
    from repro_torch.distributed import compat

    with pytest.raises(RuntimeError, match="use_mesh"):
        compat.axis_size("pod")


def test_initialize_distributed_noop_outside_multiprocess(monkeypatch):
    """World size 1 (no ``WORLD_SIZE``, or 1) starts nothing."""
    from repro_torch.distributed.multihost import initialize_distributed

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert initialize_distributed() is False
    assert not dist.is_initialized()
