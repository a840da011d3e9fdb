"""Port vs JAX package: the cost counter (``launch/cost_analysis.py``)
against ``launch/hlo_analysis.py``.

The mirror of ``tests/test_hlo_analysis.py``: each case runs the same
shapes through the port under ``CostCounter`` and through JAX's compiled
HLO under ``analyze_hlo``.  Matrix-product FLOPs are exact in both: a
product, a loop of seven (JAX's ``scan`` trip count; the port runs every
iteration), a stacked (L, d, d) weight sliced a layer at a time, nested
loops.  Collective bytes keep ``obs/metrics.py``'s factors on a ``fake``
world: an all-reduce 2x its result, a reduce-scatter its operand, an
all-gather its result, a reduce-scatter and all-gather pair the
all-reduce's figure; JAX's side parses the same HLO texts as
``tests/test_hlo_analysis.py``.

The port's own: what the kernels charge (``kernels/work.py``, the one
definition ``chip_smoke.py``'s bounds read: K7's serving bound is
PERF.md's 0.17379 ms), the same on ``meta`` and the CPU with no launch;
every wrapper's ``meta`` branch (its outputs' shapes and dtypes, the
kernel's checks); probed loops counting the same FLOPs as every step;
live-storage tracking.
"""
import dataclasses
import sys

import pytest
import torch

from repro_torch.distributed import compat
from repro_torch.distributed.sharding import MeshRules
from repro_torch.kernels import work
from repro_torch.launch.cost_analysis import CostCounter
from repro_torch.launch.mesh import fake_world

META = torch.device("meta")


def _jax_cost(fn, *shapes):
    import jax
    import jax.numpy as jnp

    from repro.launch.hlo_analysis import analyze_hlo

    specs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze_hlo(jax.jit(fn).lower(*specs).compile().as_text())


def _count(fn, *shapes, device=META):
    args = [torch.empty(s, dtype=torch.float32, device=device)
            for s in shapes]
    with CostCounter() as c:
        c.track(args)
        fn(*args)
    return c


def test_matmul_flops_exact():
    c = _count(lambda a, b: a @ b, (256, 512), (512, 128))
    h = _jax_cost(lambda a, b: a @ b, (256, 512), (512, 128))
    assert c.flops == h.flops == 2 * 256 * 512 * 128
    expect = 4 * (256 * 512 + 512 * 128 + 256 * 128)  # a + b + out
    assert c.bytes == expect
    assert h.bytes == pytest.approx(expect, rel=0.05)


def test_loop_trip_count_multiplies_flops():
    import jax

    def port(a):
        for _ in range(7):
            a = a @ a * 0.5
        return a

    def jx(a):
        def step(c, _):
            return c @ c * 0.5, None
        return jax.lax.scan(step, a, None, length=7)[0]

    c = _count(port, (128, 128))
    assert c.flops == _jax_cost(jx, (128, 128)).flops == 7 * 2 * 128 ** 3


def test_sliced_stack_counts_each_layer_once():
    import jax
    import jax.numpy as jnp

    L, d = 16, 128

    def port(x, w):
        for i in range(L):
            x = torch.tanh(x @ w[i])
        return x

    def jx(x, w_stack):
        def step(c, w):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(step, x, w_stack)[0]

    c = _count(port, (d, d), (L, d, d))
    assert c.flops == _jax_cost(jx, (d, d), (L, d, d)).flops \
        == L * 2 * d ** 3
    # slices are views: a layer's read is its slice, not the stack
    assert c.bytes < 3 * L * d * d * 4 * 4


def test_nested_loop_trip_products():
    import jax

    def port(a):
        for _ in range(5):
            for _ in range(3):
                a = a @ a
        return a

    def jx(a):
        def outer(c, _):
            def inner(ci, _):
                return ci @ ci, None
            c, _ = jax.lax.scan(inner, c, None, length=3)
            return c, None
        return jax.lax.scan(outer, a, None, length=5)[0]

    c = _count(port, (64, 64))
    assert c.flops == _jax_cost(jx, (64, 64)).flops == 5 * 3 * 2 * 64 ** 3


_RS_AG_HLO = """
HloModule rs_ag

ENTRY %main (p0: f32[1024]) -> f32[1024] {
  %p0 = f32[1024]{0} parameter(0)
  %rs = f32[256]{0} reduce-scatter(%p0), replica_groups={{0,1,2,3}}, dimensions={0}, to_apply=%add
  ROOT %ag = f32[1024]{0} all-gather(%rs), replica_groups={{0,1,2,3}}, dimensions={0}
}
"""

_AR_HLO = """
HloModule ar

ENTRY %main (p0: f32[1024]) -> f32[1024] {
  %p0 = f32[1024]{0} parameter(0)
  ROOT %ar = f32[1024]{0} all-reduce(%p0), replica_groups={{0,1,2,3}}, to_apply=%add
}
"""


def _collectives(fn):
    """The counter's collective bytes and counts for ``fn`` run as rank 0
    of a fake world of 4 with one axis "x"."""
    with fake_world(4):
        mesh = compat.make_mesh((4,), ("x",))
        with compat.use_mesh(mesh), CostCounter() as c:
            fn(torch.empty(1024, dtype=torch.float32, device=META))
    return dict(c.collective_bytes), dict(c.collective_count)


def test_collective_conventions_match_jax():
    from repro.launch.hlo_analysis import analyze_hlo

    ar_bytes, ar_count = _collectives(lambda t: compat.psum(t, "x"))
    pair_bytes, pair_count = _collectives(
        lambda t: compat.all_gather(compat.psum_scatter(t, "x"), "x"))
    ar, pair = analyze_hlo(_AR_HLO), analyze_hlo(_RS_AG_HLO)
    assert ar_bytes == dict(ar.collective_bytes) == {"all-reduce": 8192}
    # reduce-scatter moves its operand, all-gather its result
    assert pair_bytes == dict(pair.collective_bytes) == {
        "reduce-scatter": 4096, "all-gather": 4096}
    assert sum(pair_bytes.values()) == ar_bytes["all-reduce"]
    assert ar_count == {"all-reduce": 1}
    assert pair_count == {"reduce-scatter": 1, "all-gather": 1}


def test_a_fake_world_carries_meta_tensors_only():
    with fake_world(2):
        mesh = compat.make_mesh((2,), ("x",))
        with compat.use_mesh(mesh), pytest.raises(RuntimeError,
                                                  match="meta tensors"):
            compat.psum(torch.zeros(4), "x")


# -- the kernels' declared work ----------------------------------------------

def test_k7_bound_is_phase_12s():
    """``chip_smoke.py``'s bound reads ``kernels/work.py``: K7 at the
    serving shape, as PERF.md's kernel table prints it."""
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parents[1]))
    import chip_smoke

    ms, by = chip_smoke.bound(work.k7_flash(4, 2048, 40, 8, 128, 2))
    assert (round(ms, 5), by) == (0.17379, "operations")
    ms, by = chip_smoke.bound(work.k6_gram_hessian(25_000, 128))
    assert (round(ms, 7), by) == (0.0038703, "bytes")


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_flash_charges_its_work_and_nothing_else(device):
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.flash_attention_bwd import (flash_dkdv_kernel,
                                                         flash_dq_kernel)

    B, S, H, KVH, D = 1, 64, 4, 2, 16
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((B, S, h, D), generator=g).to(device)
               .requires_grad_(True) for h in (H, KVH, KVH))
    before = [f.launches for f in (flash_attention_kernel, flash_dq_kernel,
                                   flash_dkdv_kernel)]
    with CostCounter() as c:
        ops.flash_attention(q, k, v).sum().backward()
    dims = (B, S, H, KVH, D, 4)
    kernel_flops = {"K7": work.k7_flash(*dims).ops,
                    "K8a": work.k8a_flash_dq(*dims).ops,
                    "K8b": work.k8b_flash_dkdv(*dims).ops}
    assert dict(c.kernel_flops) == kernel_flops
    assert dict(c.kernel_calls) == {"K7": 1, "K8a": 1, "K8b": 1}
    # the plain versions' products are not counted again: no mm/bmm ran
    # outside the kernels
    assert c.flops == sum(kernel_flops.values())
    assert [f.launches for f in (flash_attention_kernel, flash_dq_kernel,
                                 flash_dkdv_kernel)] == before
    assert q.grad.shape == q.shape and k.grad.shape == k.shape


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device=META)


def test_every_wrapper_gives_meta_its_outputs_shapes():
    """Each kernel wrapper on ``meta`` returns what its plain version
    returns on the CPU, shape for shape and dtype for dtype, and launches
    nothing."""
    from repro_torch.core.field import FIELD_WIDE
    from repro_torch.kernels import (flash_attention, flash_attention_bwd,
                                     fused_irls, shamir_poly,
                                     shamir_reconstruct)

    g = torch.Generator().manual_seed(0)
    m = FIELD_WIDE.moduli
    x = torch.randn((4, 128), generator=g, dtype=torch.float64)
    co = torch.randint(0, 1000, (2, 1, 4, 128), generator=g,
                       dtype=torch.int32)
    sec = torch.randint(0, 1000, (2, 256), generator=g)
    cs = torch.randint(0, 1000, (2, 1, 256), generator=g)
    sh = torch.randint(0, 1000, (2, 2, 4, 128), generator=g,
                       dtype=torch.int32)
    X = torch.randn((2, 50, 8), generator=g, dtype=torch.float64)
    irls = (torch.zeros(8, dtype=torch.float64), X, X.float(),
            torch.zeros((2, 50), dtype=torch.float64),
            torch.tensor([50, 30], dtype=torch.int32))
    cv = (torch.zeros((3, 8), dtype=torch.float64), *irls[1:],
          torch.zeros((2, 50), dtype=torch.int32),
          torch.tensor([-1, 0, 1], dtype=torch.int32))
    q = torch.randn((1, 16, 4, 8), generator=g)
    kv = torch.randn((1, 16, 2, 8), generator=g)
    st = torch.randn((1, 4, 16), generator=g)
    cases = [
        (shamir_poly.encode_share_kernel, (x, co, m, 28, (1, 2, 3))),
        (shamir_poly.share_kernel, (sec, cs, m, 3)),
        (shamir_reconstruct.reconstruct_kernel, (sh, (1, 2), m, 28)),
        (shamir_reconstruct.reconstruct_kernel, (sh, (1, 2), m, None)),
        (fused_irls.fused_irls_kernel, irls),
        (fused_irls.fused_irls_cv_kernel, cv),
        (fused_irls.gram_hessian_kernel, (X[0], X[0, :, 0])),
        (flash_attention.flash_attention_kernel, (q, kv, kv)),
        (flash_attention_bwd.flash_dq_kernel, (q, kv, kv, q, st, st, st)),
        (flash_attention_bwd.flash_dkdv_kernel, (q, kv, kv, q, st, st, st)),
    ]
    for fn, args in cases:
        want = fn(*args)
        before = fn.launches
        got = fn(*(_meta(a) if isinstance(a, torch.Tensor) else a
                   for a in args))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert [(tuple(t.shape), t.dtype) for t in got] == \
            [(tuple(t.shape), t.dtype) for t in want], fn.__name__
        assert all(t.device.type == "meta" for t in got)
        assert fn.launches == before
    # the kernels' own checks hold on meta too: K7 takes D <= 256
    big = torch.empty((1, 8, 2, 264), dtype=torch.bfloat16, device=META)
    with pytest.raises(ValueError, match="head_dim <= 256"):
        flash_attention.flash_attention_kernel(big, big, big)


def test_other_devices_still_raise():
    from repro_torch.kernels import _build

    class Elsewhere:
        device = torch.device("xla")

    with pytest.raises(ValueError, match="no K7 for device xla"):
        _build.plain(Elsewhere(), "K7")


# -- probed loops ------------------------------------------------------------

@pytest.mark.parametrize("arch,kv", [
    ("rwkv6_3b", {}), ("rwkv6_3b", {"rwkv_chunk": 16}),
    ("rwkv6_3b", {"rwkv_chunk": 16, "remat": True}),
    ("recurrentgemma_9b", {"remat": True})])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_probed_loops_count_every_steps_flops(arch, kv, kind):
    from repro_torch.configs import smoke_config
    from repro_torch.launch.dryrun import dry_run
    from repro_torch.models.config import ShapeConfig

    cfg = dataclasses.replace(smoke_config(arch), **kv)
    shape = ShapeConfig("t", 128, 4, kind)
    flops = []
    for probe in (0, 3, 5):
        with fake_world(4):
            rules = MeshRules(compat.make_mesh((2, 2), ("data", "model")))
            rec = dry_run(cfg, shape, rules, probe_loops=probe)
        flops.append(rec["cost_analysis"]["flops_per_device"])
        assert bool(rec["cost_analysis"]["scaled_loops"]) == (probe > 0)
    assert flops[1] == pytest.approx(flops[0], rel=1e-12)
    assert flops[2] == pytest.approx(flops[0], rel=1e-12)


# -- live storages ------------------------------------------------------------

def test_peak_counts_new_storages_not_views_or_in_place():
    mb = 1 << 20
    a = torch.empty(mb // 4, dtype=torch.float32, device=META)
    with CostCounter() as c:
        assert c.track(a, a.view(2, -1)) == mb  # one storage, once
        b = a * 2.0                             # a new storage
        b.mul_(3.0)                             # in place: none
        v = b[: 10]                             # a view: none
        del b                                   # the view keeps it alive
        assert c.live_bytes == 2 * mb
        del v
        assert c.live_bytes == mb
        t = a.to(torch.float64) + 1.0           # 2 MB, then 2 MB more
        del t
    assert c.peak_bytes == mb + 2 * 2 * mb
    assert c.live_bytes == mb


def test_untracked_storages_stay_untracked():
    """A tensor made before the counter and not tracked (a batch handed
    whole to every rank) is invisible, and so are its views and slices."""
    whole = torch.empty((64, 1024), dtype=torch.float32, device=META)
    with CostCounter() as c:
        rows = whole[:8]
        _ = rows.sum()
    assert c.peak_bytes == 4  # the sum's scalar


def test_convolution_counts_its_products():
    """A convolution is a matrix product too: 2 x the output's elements x
    (C_in / groups) x the kernel's taps, and its backward two more (the
    input's and the weight's gradients)."""
    x = torch.randn((2, 4, 16), requires_grad=True)
    w = torch.randn((8, 4, 3), requires_grad=True)
    with CostCounter() as c:
        y = torch.nn.functional.conv1d(x, w)
    assert c.flops == 2 * y.numel() * 4 * 3
    with CostCounter() as c:
        y.sum().backward()
    assert c.flops == 2 * (2 * y.numel() * 4 * 3)
