"""Port vs JAX package: the privacy gate (``repro_torch.analysis``).

Pins, in order: every certified driver spec running clean with its
declassification trail; the port's census of each spec equal, site and
shape, to the census of the JAX package's jaxpr for the eight specs JAX
still builds (a walker over ``jax.make_jaxpr`` output cut by dead-code
elimination, here in the test);
the psum specs on spawned gloo worlds (D = 4, and 3 x 2 for the 2D wire)
with the counts read from the JAX package's source (its ``AbstractMesh``
specs no longer trace); every leak fixture caught at its boundary with
its source line; laundering attempts through a second institution-axis
sum caught; the lints (host sync, host reads, headroom against JAX's
``lint_headroom``, mesh axes, collective sites, obs purity); and the CLI.

The JAX package's own gate cannot run under the installed jax (its
verifier reads ``jax.core.Literal``), so the taint rules and fixtures are
held to its documented rules (``src/repro/analysis/taint.py``) and its
fixtures (``src/repro/analysis/fixtures.py``); only the census is
compared live.  Every spec runs on the CPU at the JAX package's toy
shapes (3 institutions x 8 rows x 4 features).
"""
import datetime
import os
import subprocess
import sys
from collections import Counter

import pytest
import torch
import torch.distributed as dist

from repro_torch._device import host_buffer
from repro_torch.analysis import PROTECTED, PUBLIC, SECRET, verify_run
from repro_torch.analysis.__main__ import analyze_spec, merge_ranks
from repro_torch.analysis.drivers import (_aggregator, _generator, _packed,
                                          all_driver_specs, certify,
                                          run_world)
from repro_torch.analysis.fixtures import leak_fixture_specs
from repro_torch.analysis.lints import (SummaryBounds, lint_collective_sites,
                                        lint_headroom, lint_host_reads,
                                        lint_host_sync, lint_mesh_axes,
                                        lint_obs_purity)
from repro_torch.analysis.report import AnalysisReport, Finding
from repro_torch.obs.audit import site_totals

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPECS = {s.name: s for s in all_driver_specs()}
_LOCAL = [s.name for s in all_driver_specs() if not s.world]
_WORLD = [s.name for s in all_driver_specs() if s.world]
_SITES = ("_protect_flat", "_reveal_flat", "_distributed_reveal",
          "declassify_sum")


@pytest.fixture(scope="module")
def worlds():
    """The four psum specs on two spawned gloo worlds (4 ranks, 3 x 2)."""
    return run_world([_SPECS[n] for n in _WORLD], "cpu", audit=False)


def _census(name, worlds=None):
    if name in _LOCAL:
        _, trace = certify(_SPECS[name], "cpu")
        census, _, consistent = trace.round_census()
        assert consistent
        return census
    return worlds[name][0]["census"]


# -- the certified surface -------------------------------------------------


def test_there_are_the_jax_packages_twelve_specs_in_its_order():
    from repro.analysis.drivers import all_driver_specs as jax_specs

    assert [s.name for s in all_driver_specs()] == \
        [s.name for s in jax_specs()]


@pytest.mark.parametrize("name", _LOCAL)
def test_driver_certifies_clean(name):
    rep = analyze_spec(_SPECS[name], "cpu")
    assert rep.ok, rep.format(verbose=True)
    assert rep.declassifications, f"{name}: no declassification recorded"


@pytest.mark.parametrize("name", _WORLD)
def test_psum_driver_certifies_clean_on_every_rank(worlds, name):
    ranks = worlds[name]
    assert len(ranks) == {"secure_psum_2d": 6}.get(name, 4)
    for r in ranks:
        assert r["report"].ok, r["report"].format(verbose=True)
    rep = merge_ranks(name, ranks)
    assert rep.ok, rep.format(verbose=True)
    assert rep.declassifications


def test_gradient_mode_records_plaintext_declassification():
    """protect='gradient' sums H and the deviance through the annotated
    declassify_sum: the audit trail names it beside the reveal."""
    rep = analyze_spec(_SPECS["secure_fit_fused[protect=gradient]"], "cpu")
    assert any("declassify_sum" in d for d in rep.declassifications)
    assert any("_reveal_flat" in d for d in rep.declassifications)
    both = analyze_spec(_SPECS["secure_fit_fused[protect=both]"], "cpu")
    assert not any("declassify_sum" in d for d in both.declassifications)


def test_2d_mesh_uses_distributed_reveal(worlds):
    rep = merge_ranks("secure_psum_2d", worlds["secure_psum_2d"])
    assert any("_distributed_reveal" in d for d in rep.declassifications)
    assert not any("_reveal_flat" in d for d in rep.declassifications)


# -- the census against the JAX package's jaxprs ---------------------------


def _jax_census(closed, dce: bool = True) -> dict:
    """(site, operand shape) -> count over a closed jaxpr and every jaxpr
    nested in its equations' params: the boundary equations by name, each
    keyed by its highest-rank operand (the JAX package's
    ``obs/audit.py::_operand_shape``).

    With ``dce`` the jaxpr is first cut to what its outputs use, as XLA
    cuts it before anything runs: the census of the calls that execute,
    which is what the port's eager run records."""
    from jax.interpreters import partial_eval as pe

    counts = Counter()
    jaxpr = closed.jaxpr
    if dce:
        jaxpr, _ = pe.dce_jaxpr(jaxpr, [True] * len(jaxpr.outvars),
                                instantiate=True)

    def nested(v):
        if hasattr(v, "eqns"):
            yield v
        elif hasattr(v, "jaxpr") and hasattr(v.jaxpr, "eqns"):
            yield v.jaxpr
        elif isinstance(v, (tuple, list)):
            for x in v:
                yield from nested(x)

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            name = eqn.params.get("name")
            if name in _SITES:
                shapes = [tuple(v.aval.shape) for v in eqn.invars
                          if hasattr(getattr(v, "aval", None), "shape")]
                counts[(name, max(shapes, key=len, default=()))] += 1
                continue  # a boundary body holds no further boundaries
            for v in eqn.params.values():
                for sub in nested(v):
                    walk(sub)

    walk(jaxpr)
    return dict(counts)


@pytest.fixture(scope="module")
def jax_jaxprs():
    from repro.analysis.drivers import all_driver_specs as jax_specs

    return {s.name: s.build()[0] for s in jax_specs() if s.name in _LOCAL}


@pytest.fixture(scope="module")
def jax_census(jax_jaxprs):
    return {name: _jax_census(closed) for name, closed in jax_jaxprs.items()}


@pytest.mark.parametrize("name", _LOCAL)
def test_census_equals_the_jax_packages_jaxpr(jax_census, name):
    assert _census(name) == jax_census[name]


def test_census_rows_the_jax_package_shows():
    """The fused rows are {protect 1, reveal 1}, plus declassify_sum 1 in
    gradient mode; so are the selection sweep's: its held-out stats leave
    through the reveal."""
    def by_site(name):
        return site_totals(_census(name))

    pr = {"_protect_flat": 1, "_reveal_flat": 1}
    for name in ("secure_fit_fused", "coordinator_fused", "secure_fit_scan"):
        assert by_site(f"{name}[protect=both]") == pr
        assert by_site(f"{name}[protect=gradient]") == \
            {**pr, "declassify_sum": 1}
    assert by_site("selection_scan[protect=both]") == pr
    assert by_site("selection_scan[protect=gradient]") == \
        {**pr, "declassify_sum": 1}


@pytest.mark.parametrize("protect", ["both", "gradient"])
def test_selection_traced_census_holds_three_dead_sums(jax_jaxprs, protect):
    """The stated difference: the JAX package's selection jaxpr, as
    traced, holds three more ``declassify_sum`` equations a round than
    run.  ``revealed.get(k, declassify_sum(...))`` evaluates its default
    while tracing; nothing uses the result, and dead-code elimination
    (XLA's, and the walker's here) removes them.  The port makes only
    the sums that are used."""
    name = f"selection_scan[protect={protect}]"
    raw = _jax_census(jax_jaxprs[name], dce=False)
    live = _jax_census(jax_jaxprs[name])
    dead = Counter(raw)
    dead.subtract(live)
    assert {k: n for k, n in dead.items() if n} == \
        {("declassify_sum", (4, 3)): 3}
    assert live == _census(name)


def test_psum_census_from_the_jax_packages_source(worlds):
    """Read from ``core/collective.py::psum`` / ``psum_2d`` of the JAX
    package: one protect of the (rows, 128) flat buffer (12 + 4 elements:
    8 rows), then one reveal of t = 2 slices — the whole buffer when
    replicated, a 1/D tile when sharded — or, on the 2D mesh, one
    distributed reveal of this center's (R, rows, 128) slice."""
    protect = ("_protect_flat", (8, 128))
    assert _census("secure_psum[replicated]", worlds) == {
        protect: 1, ("_reveal_flat", (2, 2, 8, 128)): 1}
    for name in ("secure_psum[sharded,tree]", "secure_psum[sharded,tile]"):
        assert _census(name, worlds) == {
            protect: 1, ("_reveal_flat", (2, 2, 2, 128)): 1}
    assert _census("secure_psum_2d", worlds) == {
        protect: 1, ("_distributed_reveal", (2, 8, 128)): 1}
    for name in _WORLD:
        censuses = [r["census"] for r in worlds[name]]
        assert all(c == censuses[0] for c in censuses)


def test_scan_block_folds_executed_rounds_into_one_census():
    _, trace = certify(_SPECS["secure_fit_scan[protect=both]"], "cpu")
    census, rounds, consistent = trace.round_census()
    assert consistent and rounds == sum(trace.slots) >= 2
    assert trace.counts() == {k: n * rounds for k, n in census.items()}


def test_the_gate_is_bit_invisible():
    """A round under the gate returns what it returns without it."""
    spec = _SPECS["secure_fit_fused[protect=gradient]"]
    fn, args, taints = spec.setup(torch.device("cpu"))
    _, _, gated = verify_run(fn, args, taints, spec.threshold)
    fn, args, _ = spec.setup(torch.device("cpu"))
    plain = fn(*args)
    assert all(torch.equal(a, b) for a, b in zip(gated, plain))


# -- negative controls -----------------------------------------------------


def _fixture(name):
    (spec,) = [s for s in leak_fixture_specs() if s.name == name]
    return analyze_spec(spec, "cpu", expect_leak=True)


def test_skip_protect_fixture_caught():
    rep = _fixture("LEAKY:skip_protect")
    assert not rep.ok
    errs = [f for f in rep.errors() if "outputs[" in f.where]
    assert errs and all("SECRET" in f.message for f in errs)
    # each names the op that made the output and its source line
    assert all("core/newton.py:" in f.message for f in errs)


def test_reveal_slice_fixture_caught_at_the_reveal_boundary():
    """The acceptance case: a per-institution reveal is flagged at the
    ``_reveal_flat`` boundary, with the call site and the fixture line."""
    rep = _fixture("LEAKY:reveal_institution_slice")
    assert not rep.ok
    (f,) = rep.errors()
    assert f.where.startswith("_reveal_flat@repro_torch/core/collective.py:")
    assert "repro_torch/analysis/fixtures.py:" in f.where
    assert "PER-INSTITUTION" in f.message


def test_callback_fixture_caught_at_the_host_read():
    rep = _fixture("LEAKY:callback_leak")
    assert not rep.ok
    (f,) = rep.errors()
    assert f.where.startswith(
        "host-read(tolist)@repro_torch/analysis/fixtures.py:")
    assert "SECRET" in f.message


def _laundered(stack_fn):
    """Protect three institutions, build a 5-D buffer out of institution
    0's slice with ``stack_fn``, sum its institution axis as Algorithm 2
    does, and reveal it."""
    from repro_torch.core.batched_summaries import batched_local_summaries
    from repro_torch.core.collective import FlatProtected

    agg = _aggregator()
    packed = _packed("cpu")

    def fn(beta, generator, packed):
        sm = batched_local_summaries(beta, packed, backend="kernel")
        prot = agg.protect_batched(generator, {"gradient": sm.gradient})
        summed = agg.aggregate_batched(
            FlatProtected(stack_fn(prot.buf), prot.layout))
        return agg.reveal(summed)

    beta = torch.zeros((packed.dim,), dtype=torch.float64)
    rep, _, _ = verify_run(fn, (beta, _generator("cpu"), packed),
                           (PUBLIC, PUBLIC, SECRET), 2, target="launder")
    return rep


@pytest.mark.parametrize("how", ["stack", "gather", "expand", "one",
                                 "zero_others"])
def test_a_second_institution_sum_cannot_aggregate_one_institution(how):
    """Institution 0's slice, doubled by stacking, by an index gather, by
    a stride-0 expand, kept alone, or left alone by zeroing the other
    institutions' shares in place, and summed over the institution axis:
    still one institution's shares, and its reveal is caught."""
    stack_fn = {
        "stack": lambda b: torch.stack([b[:, :, 0], b[:, :, 0]], dim=2),
        "gather": lambda b: b[:, :, [0, 0]],
        "expand": lambda b: b[:, :, 0:1].expand(-1, -1, 2, -1, -1),
        "one": lambda b: b[:, :, 0:1],
        "zero_others": lambda b: b.index_fill_(2, torch.tensor([1, 2]), 0),
    }[how]
    rep = _laundered(stack_fn)
    assert not rep.ok
    assert any("PER-INSTITUTION" in f.message for f in rep.errors())


def test_the_real_institution_sum_aggregates():
    """The same chain over the protect output itself is Algorithm 2."""
    rep = _laundered(lambda b: b)
    assert rep.ok, rep.format(verbose=True)
    assert any("_reveal_flat" in d for d in rep.declassifications)


def test_share_material_never_leaves_a_run():
    agg = _aggregator()

    def fn(gen, x):
        return agg.protect(gen, {"x": x}).buf

    rep, _, _ = verify_run(fn, (_generator("cpu"), torch.ones(4)),
                           (PUBLIC, SECRET), 2)
    (f,) = rep.errors()
    assert "outputs[0]" in f.where and "PROTECTED" in f.message


def test_in_place_writes_carry_taint():
    """``copy_`` into a public buffer, and a view of it, cannot launder."""
    def fn(x):
        buf = torch.zeros(4, dtype=torch.float64)
        buf[1:].copy_(x[:3])
        return buf.view(2, 2)

    rep, _, _ = verify_run(fn, (torch.arange(4.0, dtype=torch.float64),),
                           (SECRET,), 2)
    assert not rep.ok


# -- host-sync lint --------------------------------------------------------


def test_host_sync_lint_clean_on_the_port_drivers():
    rep = lint_host_sync()
    assert rep.ok, rep.format(verbose=True)
    # one info finding per monitored function: its single marked sync,
    # and PathDriver.run_chunk's one read of the carry after its loop
    infos = Counter(f.message for f in rep.findings
                    if f.severity == "info")
    assert infos == {
        "the one marked host sync of this driver": 4,
        "the one marked read of the carry after the block loop": 1}


_DRIVER = '''
import numpy as np
import torch

class Driver:
    def step_block(self):
        carry, objs, actives = fit_scan_block(self.beta)
        flat, unflatten = host_buffer(objs, actives)
        # host-sync: the block read-back, one copy
        objs, actives = unflatten(flat.cpu().numpy())
        done = bool(actives.all())
        return objs, done
'''


def test_host_sync_lint_accepts_one_marked_read_back():
    rep = lint_host_sync(modules={
        "driver.py": (_DRIVER, [("Driver", "step_block")])})
    assert rep.ok, rep.format(verbose=True)


def test_host_sync_lint_flags_an_injected_item():
    injected = _DRIVER.replace(
        "        done = bool(actives.all())\n",
        "        done = bool(actives.all())\n"
        "        self.last = carry[1].item()\n")
    rep = lint_host_sync(modules={
        "driver.py": (injected, [("Driver", "step_block")])})
    (f,) = rep.errors()
    assert "unannotated host materialization" in f.message
    assert ".item()(carry)" in f.where


def test_host_sync_lint_catches_the_legacy_multi_read_back():
    legacy = _DRIVER.replace(
        "        objs, actives = unflatten(flat.cpu().numpy())\n",
        "        objs = objs.cpu().numpy()\n"
        "        self._obj_prev = float(carry[1])\n"
        "        self.converged = bool(carry[2])\n"
        "        actives = np.asarray(actives)\n")
    rep = lint_host_sync(modules={
        "legacy.py": (legacy, [("Driver", "step_block")])})
    errs = rep.errors()
    # float(carry), bool(carry), np.asarray(actives): three stray syncs
    assert len(errs) == 3
    assert any("float(carry)" in f.where for f in errs)


@pytest.mark.parametrize("reads", [
    "        objs, actives = (t.cpu().numpy() for t in (objs, actives))\n",
    "        objs, actives = [t.tolist() for t in (objs, actives)]\n",
])
def test_host_sync_lint_counts_a_copy_per_tensor_in_a_comprehension(reads):
    """One statement that reads tensors one by one makes a blocking copy
    apiece: torch has no ``device_get`` of a tuple."""
    one_by_one = _DRIVER.replace(
        "        objs, actives = unflatten(flat.cpu().numpy())\n", reads)
    rep = lint_host_sync(modules={
        "driver.py": (one_by_one, [("Driver", "step_block")])})
    assert any("inside a comprehension" in f.message for f in rep.errors())


def test_host_sync_lint_counts_each_copy_of_one_statement():
    two = _DRIVER.replace(
        "        objs, actives = unflatten(flat.cpu().numpy())\n",
        "        objs, actives = objs.cpu().numpy(), actives.cpu().numpy()\n")
    rep = lint_host_sync(modules={
        "driver.py": (two, [("Driver", "step_block")])})
    (f,) = rep.errors()
    assert ".cpu()/.numpy()(actives)" in f.where


_LOOP_DRIVER = '''
class Driver:
    def run_chunk(self, carry):
        while True:
            carry, (objs, actives) = _cv_sweep_block(carry)
            flat, unflatten = host_buffer(objs, actives, carry[2])
            # host-sync: the block's read-back
            objs, actives, conv = unflatten(flat.cpu().numpy())
            if bool(conv.all()):
                break
        # host-sync: the carry's last values
        betas = carry[0].cpu().numpy()
        return objs, betas
'''


def test_host_sync_lint_allows_one_read_after_the_block_loop():
    rep = lint_host_sync(modules={
        "loop.py": (_LOOP_DRIVER, [("Driver", "run_chunk")])})
    assert rep.ok, rep.format(verbose=True)
    twice = _LOOP_DRIVER.replace(
        "        return objs, betas\n",
        "        # host-sync: and again\n"
        "        vdev = carry[4].cpu().numpy()\n"
        "        return objs, betas, vdev\n")
    rep = lint_host_sync(modules={
        "loop.py": (twice, [("Driver", "run_chunk")])})
    assert any("2 marked reads after the block loop" in f.message
               for f in rep.errors())
    inner = _LOOP_DRIVER.replace(
        "            if bool(conv.all()):\n",
        "            for r in range(2):\n"
        "                # host-sync: a read a round\n"
        "                self.last = carry[1][r].item()\n"
        "            if bool(conv.all()):\n")
    rep = lint_host_sync(modules={
        "loop.py": (inner, [("Driver", "run_chunk")])})
    assert any("inside an inner loop" in f.message for f in rep.errors())


def test_host_sync_lint_requires_exactly_one_marked_site():
    doubled = _DRIVER.replace(
        "        done = bool(actives.all())\n",
        "        # host-sync: a second one\n"
        "        self.last = float(carry[1])\n")
    rep = lint_host_sync(modules={
        "doubled.py": (doubled, [("Driver", "step_block")])})
    assert any("2 marked host-sync sites" in f.message
               for f in rep.errors())
    rep = lint_host_sync(modules={
        "none.py": (_DRIVER.replace("# host-sync:", "#"),
                    [("Driver", "step_block")])})
    assert any("no marked host-sync site" in f.message
               for f in rep.errors())


def test_host_buffer_reads_each_dtype_back_exactly():
    ts = (torch.tensor([[1.5, -2.0], [3.0, 1e-300]], dtype=torch.float64),
          torch.tensor([True, False]),
          torch.tensor([7, -(2 ** 31)], dtype=torch.int32),
          torch.tensor(0.1, dtype=torch.float32))
    flat, unflatten = host_buffer(*ts)
    assert flat.dtype == torch.float64 and flat.numel() == 9
    back = unflatten(flat.cpu().numpy())
    for t, a in zip(ts, back):
        assert a.dtype == t.numpy().dtype and a.shape == tuple(t.shape)
        assert (a == t.numpy()).all()
    with pytest.raises(TypeError, match="not exact in float64"):
        host_buffer(torch.tensor([2 ** 60]))


def test_host_sync_lint_finds_a_moved_function():
    rep = lint_host_sync(modules={"x.py": ("def f():\n    pass\n",
                                           [("Driver", "step_block")])})
    assert any("not found" in f.message for f in rep.errors())


# -- host reads of a certified run -----------------------------------------


@pytest.mark.parametrize("name", ["secure_fit_scan[protect=both]",
                                  "selection_scan[protect=gradient]"])
def test_scan_blocks_read_only_the_documented_settled_scalar(name):
    """The per-slot ``settled`` read is the one host read of a block,
    reported as the documented deviation with its count."""
    _, trace = certify(_SPECS[name], "cpu")
    assert len(trace.host_reads) == len(trace.slots)
    assert all(r.taint == PUBLIC for r in trace.host_reads)
    rep = lint_host_reads(trace.host_reads, name)
    assert rep.ok
    (w,) = [f for f in rep.findings if f.severity == "warning"]
    assert "documented deviation (ROADMAP item 12)" in w.message
    assert f"{len(trace.slots)} per-slot 'settled'" in w.message
    assert "repro_torch/core/scanfit.py:" in w.where


def test_fused_round_makes_no_host_read():
    _, trace = certify(_SPECS["secure_fit_fused[protect=both]"], "cpu")
    assert trace.host_reads == []
    rep = lint_host_reads(trace.host_reads, "fused")
    assert any("host-read-free" in f.message for f in rep.findings)


def test_an_unmarked_host_read_in_a_round_is_flagged():
    def fn(x):
        return torch.tensor(float(x.sum()))

    _, trace, _ = verify_run(fn, (torch.ones(3),), (PUBLIC,), 2)
    rep = lint_host_reads(trace.host_reads, "unmarked")
    (f,) = rep.errors()
    assert f.where.startswith("host-read(__float__)@test_torch_analysis.py:")
    assert "unmarked host read" in f.message


# -- headroom lint against the JAX package's -------------------------------


_GRID = [SummaryBounds(d=d, n_max=n, num_parts=s)
         for d in (4, 128) for n in (10, 100_000, 10 ** 9)
         for s in (2, 16, 64, 2 ** 20, 2 ** 31, 2 ** 32, 2 ** 33, 2 ** 35)]


def _verdict(rep):
    return rep.ok, sorted(f.where for f in rep.errors())


@pytest.mark.parametrize("bounds", _GRID, ids=str)
def test_headroom_lint_matches_the_jax_packages(bounds):
    """The same verdicts as JAX's ``lint_headroom``, except where S *
    max(p) falls in [2**63, 2**64): the port's exact sum is int64, so it
    flags the aggregation there where JAX's uint64 one does not."""
    from repro.analysis.lints import SummaryBounds as JaxBounds
    from repro.analysis.lints import lint_headroom as jax_lint

    port = _verdict(lint_headroom(bounds))
    jax_rep = jax_lint(JaxBounds(**vars(bounds)))
    want = _verdict(jax_rep)
    worst = bounds.num_parts * (2 ** 31 - 1)
    if 2 ** 63 <= worst < 2 ** 64:
        assert "aggregation" in port[1] and "aggregation" not in want[1]
        assert [w for w in port[1] if w != "aggregation"] == want[1]
    else:
        assert port == want


def test_headroom_window_is_the_stated_difference():
    inside = [b for b in _GRID
              if 2 ** 63 <= b.num_parts * (2 ** 31 - 1) < 2 ** 64]
    assert inside  # the grid reaches the window (S = 2**33)
    rep = lint_headroom(SummaryBounds(d=4, n_max=10, num_parts=2 ** 33))
    (f,) = [f for f in rep.errors() if f.where == "aggregation"]
    assert "2**63" in f.message


def test_headroom_lint_passes_the_deployment_envelope():
    rep = lint_headroom(SummaryBounds(d=128, n_max=100_000, num_parts=16))
    assert rep.ok, rep.format(verbose=True)
    assert {f.where for f in rep.findings} == {"aggregation", "codec"}


# -- mesh-axis lint --------------------------------------------------------


def test_mesh_axis_lint_flags_a_rogue_axis(tmp_path):
    """A real collective over a mesh axis named 'rogue' (one gloo rank)."""
    from repro_torch.distributed import compat

    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        with compat.use_mesh(compat.make_mesh([1], ["rogue"])):
            _, trace, _ = verify_run(
                lambda x: compat.psum(x, "rogue"), (torch.ones(4),),
                (PUBLIC,), 2)
    finally:
        dist.destroy_process_group()
    rep = lint_mesh_axes(trace.collectives, "rogue-test")
    (f,) = rep.errors()
    assert "unknown axis 'rogue'" in f.message
    assert f.where.startswith("psum@test_torch_analysis.py:")


def test_mesh_axis_lint_passes_the_protocol_axes(worlds):
    for name in _WORLD:
        for r in worlds[name]:
            assert r["collectives"]
            rep = lint_mesh_axes(r["collectives"], name)
            assert rep.ok, rep.format(verbose=True)
    axes = {e.axis for r in worlds["secure_psum_2d"]
            for e in r["collectives"]}
    assert axes == {"pod", "share"}


# -- collective boundary-ownership lint ------------------------------------


def test_collective_sites_lint_clean_on_the_port():
    rep = lint_collective_sites()
    assert rep.ok, rep.format(verbose=True)


def test_collective_sites_lint_flags_a_new_call_site():
    rogue = (
        "from repro_torch.core.collective import _protect_flat, "
        "_reveal_flat\n"
        "def my_round(gen, buf, scheme, frac_bits, rows, pts):\n"
        "    shares = _protect_flat(gen, buf, scheme, frac_bits, rows)\n"
        "    return _reveal_flat(shares, scheme, frac_bits, pts)\n"
    )
    rep = lint_collective_sites(modules={"core/rogue.py": rogue})
    errs = rep.errors()
    assert len(errs) == 2
    assert all("outside core/collective.py" in f.message for f in errs)
    assert lint_collective_sites(modules={"core/collective.py": rogue}).ok
    imports_only = ("from .collective import _reveal_flat\n"
                    "handle = _reveal_flat\n")
    assert lint_collective_sites(modules={"core/x.py": imports_only}).ok


# -- obs purity lint -------------------------------------------------------


def test_obs_purity_passes_on_the_port():
    rep = lint_obs_purity()
    assert rep.ok, rep.format(verbose=True)
    assert len(rep.findings) == 4  # trace, ledger, metrics, gate


def test_obs_purity_catches_torch_and_a_materializer():
    rep = lint_obs_purity(modules={
        "obs/bad.py": "import torch\ndef f(x):\n    return x.item()\n"})
    assert len(rep.errors()) == 2


def test_obs_purity_allows_only_the_lazy_profiler_hook():
    hook = ("class SpanTracer:\n"
            "    def _annotation(self, name):\n"
            "        import torch.profiler\n"
            "        return torch.profiler.record_function(name)\n")
    assert lint_obs_purity(modules={"obs/trace.py": hook}).ok
    assert not lint_obs_purity(modules={"obs/ledger.py": hook}).ok


# -- the hooks -------------------------------------------------------------


def test_every_kernel_wrapper_with_a_launch_counter_is_declared():
    import inspect

    from repro_torch import kernels

    found = []
    for mod in ("shamir_poly", "shamir_reconstruct", "fused_irls",
                "flash_attention", "flash_attention_bwd"):
        m = __import__(f"repro_torch.kernels.{mod}", fromlist=["_"])
        for name, obj in inspect.getmembers(m, callable):
            if hasattr(obj, "launches"):
                found.append(name)
                assert getattr(obj, "gate_hook", None) == ("kernel", name)
    assert len(found) == 9
    assert kernels.ops  # every ops entry routes through one of them


def test_the_boundaries_and_collectives_are_declared():
    from repro_torch.core import collective
    from repro_torch.distributed import compat

    for site in _SITES:
        assert getattr(collective, site).gate_hook == ("boundary", site)
    for kind in ("psum", "pmax", "psum_scatter", "all_gather"):
        assert getattr(compat, kind).gate_hook == ("collective", kind)


# -- report plumbing and the CLI -------------------------------------------


def test_report_dedup_and_severity_gate():
    rep = AnalysisReport(target="t")
    f = Finding("taint", "warning", "w", "m")
    rep.add(f)
    rep.add(f)
    assert len(rep.findings) == 1 and rep.ok
    rep.add(Finding("taint", "error", "w2", "m2"))
    assert not rep.ok and len(rep.errors()) == 1
    with pytest.raises(ValueError):
        Finding("taint", "fatal", "w", "m")


def test_taint_levels_are_the_jax_packages():
    from repro.analysis import taint as jax_taint

    assert (PUBLIC, PROTECTED, SECRET) == (
        jax_taint.PUBLIC, jax_taint.PROTECTED, jax_taint.SECRET)


def test_gate_cli_subprocess():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "gate: PASS (12 drivers, 3 fixtures, on cpu)" in out.stdout
    assert out.stdout.count("CAUGHT  LEAKY:") == 3
