"""Protocol lints: the static and runtime twins of the protocol invariants.

The port's counterparts of the JAX package's ``analysis/lints.py``, aimed
at the port's own files.  Each pass produces
:class:`~repro_torch.analysis.report.Finding` records:

* :func:`lint_host_sync` — AST pass pinning "ONE host sync per round or
  scan block" over the drivers.  Values bound from a round dispatch
  (``fit_scan_block`` / ``_cv_sweep_block`` / ``_fused_secure_iteration``)
  are device-resident; each call that reads one to the host (``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float``/``int``/``bool``,
  ``np.asarray``) is one blocking copy, and so is
  ``torch.cuda.synchronize()``.  A chain such as ``x.cpu().numpy()`` is
  one copy; a read inside a comprehension or an inner loop is one copy
  per element, and an error.  Each monitored function must make exactly
  ONE read a block, annotated with a ``# host-sync:`` comment (a driver
  that gathers several tensors puts them in one buffer first,
  ``_device.host_buffer``); one that loops over blocks may make one more
  after the loop, for the carry's last values.  Names bound by a read
  are host values from then on.
* :func:`lint_host_reads` — the runtime twin of JAX's callback census:
  every host read a certified round made (``GateTrace.host_reads``) must
  sit at a marked site.  The per-slot ``settled`` read of
  ``core.scanfit.scan_rounds`` is a documented deviation (ROADMAP item
  12: a CUDA graph of the block would remove it) and is reported as one,
  with its count.
* :func:`lint_headroom` — symbolic fixed-point pass: from configuration
  bounds alone (:class:`SummaryBounds`), prove the aggregation bound
  ``S * max(p_r) < 2**63`` (the port's int64 accumulator; the JAX
  package's uint64 one allows 2**64) and the codec capacity bound
  ``S * max|summary| < capacity``.
* :func:`lint_mesh_axes` — every collective of a certified run is over a
  protocol axis (``POD_AXIS``/``SHARE_AXIS``) bound by the mesh in use.
* :func:`lint_collective_sites` — AST pass: the protect/reveal boundaries
  (``_protect_flat`` / ``_reveal_flat`` / ``_distributed_reveal``) are
  CALLED only in ``core/collective.py``, plus the deliberate-leak audit
  fixture (``obs/audit.py``) and the raw kernel layer (``kernels/ops.py``).
* :func:`lint_obs_purity` — AST pass over ``obs/{trace,ledger,metrics,
  gate}.py``: stdlib-only imports, no device materializers.  The one
  sanctioned exception is the lazy ``import torch.profiler`` inside
  ``SpanTracer._annotation``.

* :func:`lint_kernel_knobs` — the CUDA launch knobs of every kernel
  family (``kernels/tuning.py``) against the H100's shared-memory,
  register and thread budget and the alignment each kernel's code needs,
  before any build: one info finding a family, an error on the first
  knob that could not launch (JAX's Pallas knob lint, whose VMEM model
  this budget replaces).
"""
from __future__ import annotations

import ast
import dataclasses
import functools
import math
import pathlib

from .report import AnalysisReport, Finding
from .taint import TAINT_NAMES

__all__ = [
    "MONITORED_DRIVERS",
    "SYNC_MARK",
    "SummaryBounds",
    "lint_host_sync",
    "lint_host_reads",
    "lint_headroom",
    "lint_mesh_axes",
    "lint_kernel_knobs",
    "lint_obs_purity",
    "lint_collective_sites",
    "BOUNDARY_CALL_EXEMPT",
    "OBS_CORE_MODULES",
]

_PKG = pathlib.Path(__file__).resolve().parents[1]

# -- host-sync lint --------------------------------------------------------

SYNC_MARK = "# host-sync:"

# round-dispatch callables: binding their result makes a name device-resident
DISPATCH_FNS = {"fit_scan_block", "_cv_sweep_block", "_fused_secure_iteration"}

# module path (relative to repro_torch) -> class (None: a module-level
# function) -> monitored functions.  Both drivers' ``step_block`` hand
# their block to ``scanfit.run_fit_block``, where its one read-back is.
MONITORED_DRIVERS = (
    ("core/newton.py", "SecureFitDriver", ("_round_fused",)),
    ("core/protocol.py", "StudyCoordinator", ("_round_fused",)),
    ("core/scanfit.py", None, ("run_fit_block",)),
    ("selection/path.py", "PathDriver", ("run_chunk",)),
)

_SCALAR_MATERIALIZERS = {"float", "int", "bool"}
_METHOD_MATERIALIZERS = {"item", "tolist", "cpu", "numpy"}
_MODULE_MATERIALIZERS = {("np", "asarray"), ("np", "array"),
                         ("numpy", "asarray"), ("numpy", "array")}
# marker comment must sit within this many lines above the sync
_MARK_WINDOW = 5


def _materializer_kind(call: ast.Call):
    f = call.func
    if isinstance(f, ast.Name) and f.id in _SCALAR_MATERIALIZERS:
        return f.id
    if isinstance(f, ast.Attribute):
        if isinstance(f.value, ast.Name) and \
                (f.value.id, f.attr) in _MODULE_MATERIALIZERS:
            return f"{f.value.id}.{f.attr}"
        if f.attr == "synchronize" and isinstance(f.value, ast.Attribute) \
                and f.value.attr == "cuda":
            return "torch.cuda.synchronize"
        if f.attr in _METHOD_MATERIALIZERS:
            return f".{f.attr}()"
    return None


def _names(node) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _call_callee(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _bound_names(target) -> list:
    """Names an assignment target binds (not those it only reads, as
    ``obj`` in ``obj.attr = ...``)."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for e in target.elts for n in _bound_names(e)]
    if isinstance(target, ast.Starred):
        return _bound_names(target.value)
    return []


def _target_names(stmt) -> list:
    targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
    return [n for t in targets for n in _bound_names(t)]


def _own_exprs(stmt: ast.stmt) -> list:
    """The expressions of this statement itself, not of the statements
    nested in it (a compound statement would re-yield its body)."""
    return [ch for ch in ast.iter_child_nodes(stmt)
            if not isinstance(ch, ast.stmt)]


def _find_function(tree: ast.Module, cls: str | None, fn: str):
    body = tree.body
    if cls is not None:
        body = next((n.body for n in tree.body
                     if isinstance(n, ast.ClassDef) and n.name == cls), [])
    return next((n for n in body if isinstance(n, ast.FunctionDef)
                 and n.name == fn), None)


# expressions whose body runs once per element
_PER_ELEMENT = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp,
                ast.Lambda)


def _reads(exprs, device: set) -> list:
    """``(call, kinds, names, in_comprehension)`` of each host read in
    ``exprs``: a materializer call on a device name, or
    ``torch.cuda.synchronize``.  A materializer applied to another's
    result (``x.cpu().numpy()``) is the same copy and counts once."""
    out = []

    def visit(node, comp, chain):
        # comp: None outside a comprehension, else the names it iterates
        kind = _materializer_kind(node) if isinstance(node, ast.Call) \
            else None
        if kind and chain is None:
            names = (_names(node) | (comp or set())) & device
            if names or kind == "torch.cuda.synchronize":
                chain = [kind]
                out.append((node, chain, names, comp is not None))
        elif kind:
            chain.append(kind)
        if isinstance(node, _PER_ELEMENT):
            comp = (comp or set()) | _names(node)
        for ch in ast.iter_child_nodes(node):
            visit(ch, comp, chain)

    for e in exprs:
        visit(e, None, None)
    return out


def _innermost_loop(loops, line: int):
    inside = [lp for lp in loops if lp.lineno < line <= lp.end_lineno]
    return max(inside, key=lambda lp: lp.lineno, default=None)


def _lint_function(fn_node: ast.FunctionDef, mark_lines: set, where: str,
                   report: AnalysisReport):
    """One monitored function: exactly one marked read a block (and, for
    a block loop, at most one after it), no strays."""
    stmts = sorted(
        (n for n in ast.walk(fn_node) if isinstance(n, ast.stmt)
         and n is not fn_node),
        key=lambda n: (n.lineno, n.col_offset),
    )
    loops = [n for n in stmts if isinstance(n, (ast.For, ast.While))]
    device: set = set()
    block_loop = None
    candidates = []  # (lineno, site, in_comprehension, loop) of each read

    for stmt in stmts:
        exprs = _own_exprs(stmt)
        calls = [c for e in exprs for c in ast.walk(e)
                 if isinstance(c, ast.Call)]
        # an assignment's targets are written, not read
        read = [stmt.value] if isinstance(stmt, (ast.Assign, ast.AnnAssign)) \
            and stmt.value is not None else exprs
        reads = _reads(read, device)
        for call, kinds, names, in_comp in reads:
            site = f"{where}:{call.lineno} {'/'.join(sorted(set(kinds)))}"
            if names:
                site += f"({', '.join(sorted(names))})"
            candidates.append((call.lineno, site, in_comp,
                               _innermost_loop(loops, call.lineno)))
        # binding effects, in source order
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)) \
                and stmt.value is not None:
            names = _target_names(stmt)
            if any(_call_callee(c) in DISPATCH_FNS for c in calls):
                device.update(names)
                block_loop = _innermost_loop(loops, stmt.lineno)
            elif reads:
                device.difference_update(names)  # read -> host side
            elif _names(stmt.value) & device:
                device.update(names)  # derived from a device value

    # a marker blesses only the FIRST read at/after it (within the
    # window): trailing reads can't ride an earlier annotation
    blessed = set()
    for m in sorted(mark_lines):
        for idx, (lineno, *_) in enumerate(candidates):
            if idx not in blessed and m <= lineno <= m + _MARK_WINDOW:
                blessed.add(idx)
                break

    def in_block(loop) -> bool:
        return block_loop is None or (
            loop is not None and block_loop.lineno <= loop.lineno
            <= block_loop.end_lineno)

    per_block, after = [], []
    for idx, (_, site, in_comp, loop) in enumerate(candidates):
        if in_comp:
            report.add(Finding(
                "host-sync", "error", site,
                "a host read inside a comprehension copies each element "
                "on its own, a blocking copy apiece (put the tensors in "
                "one buffer, _device.host_buffer, and copy it once)",
            ))
        elif idx not in blessed:
            report.add(Finding(
                "host-sync", "error", site,
                "unannotated host materialization of a device-resident "
                "round value — a hidden sync (mark the ONE intended "
                f"site with '{SYNC_MARK}' or keep the value on device)",
            ))
        elif loop is not (block_loop if in_block(loop) else None):
            report.add(Finding(
                "host-sync", "error", site,
                "a host read inside an inner loop copies once an "
                "iteration: read the block's values once",
            ))
        else:
            (per_block if in_block(loop) else after).append(site)
    if len(per_block) == 1:
        report.add(Finding("host-sync", "info", per_block[0],
                           "the one marked host sync of this driver"))
    elif not per_block:
        report.add(Finding(
            "host-sync", "error", where,
            f"no marked host-sync site found (expected exactly one "
            f"'{SYNC_MARK}'-annotated read-back)",
        ))
    else:
        report.add(Finding(
            "host-sync", "error", where,
            f"{len(per_block)} marked host-sync sites "
            f"({'; '.join(per_block)}): a driver round or block must "
            "sync exactly once",
        ))
    if len(after) == 1:
        report.add(Finding("host-sync", "info", after[0],
                           "the one marked read of the carry after the "
                           "block loop"))
    elif after:
        report.add(Finding(
            "host-sync", "error", where,
            f"{len(after)} marked reads after the block loop "
            f"({'; '.join(after)}): read the carry's last values once",
        ))


def lint_host_sync(report: AnalysisReport | None = None, *,
                   modules=None) -> AnalysisReport:
    """Pin "one host sync per round or block" over the driver sources.

    ``modules`` (for tests) maps a display name to ``(source_text,
    [(class_name or None, fn_name), ...])``; default is
    :data:`MONITORED_DRIVERS` read from the package sources.
    """
    rep = report or AnalysisReport(target="host-sync")
    if modules is None:
        modules = {rel: ((_PKG / rel).read_text(),
                         [(cls, fn) for fn in fns])
                   for rel, cls, fns in MONITORED_DRIVERS}
    for name, (src, targets) in modules.items():
        tree = ast.parse(src)
        mark_lines = {i for i, line in enumerate(src.splitlines(), start=1)
                      if SYNC_MARK in line}
        for cls, fn in targets:
            label = f"{cls}.{fn}" if cls else fn
            node = _find_function(tree, cls, fn)
            if node is None:
                rep.add(Finding(
                    "host-sync", "error", f"{name}:{label}",
                    "monitored driver function not found — update "
                    "MONITORED_DRIVERS if it moved",
                ))
                continue
            _lint_function(node, mark_lines, f"{name}:{label}", rep)
    return rep


# -- host reads of a certified run -----------------------------------------

# the documented deviation: scan_rounds reads one public ``settled``
# scalar per slot (ROADMAP item 12), where JAX's lax.scan reads nothing
DEVIATION_READS = (("core/scanfit.py", "scan_rounds"),)


@functools.lru_cache(maxsize=None)
def _source(path: str):
    try:
        text = pathlib.Path(path).read_text()
    except OSError:
        return None, ()
    return text.splitlines(), ast.parse(text)


def _marked(path: str, line: int) -> bool:
    lines, _ = _source(path)
    if lines is None:
        return False
    lo = max(line - 1 - _MARK_WINDOW, 0)
    return any(SYNC_MARK in ln for ln in lines[lo:line])


def _function_at(path: str, line: int) -> str:
    _, tree = _source(path)
    best = ""
    for node in ast.walk(tree) if tree else ():
        if isinstance(node, ast.FunctionDef) and \
                node.lineno <= line <= node.end_lineno:
            best = node.name  # ast.walk is breadth-first: innermost last
    return best


def lint_host_reads(host_reads, target: str,
                    report: AnalysisReport | None = None) -> AnalysisReport:
    """Every host read of a certified round sits at a marked site.

    ``host_reads`` is ``GateTrace.host_reads``.  An unmarked read is a
    hidden per-round sync (and a telemetry channel): an error.  Reads at
    :data:`DEVIATION_READS` are reported as the documented deviation.
    """
    rep = report or AnalysisReport(target=target)
    by_site: dict = {}
    for r in host_reads:
        by_site.setdefault((r.path, r.line, r.where), []).append(r)
    for (path, line, where), reads in by_site.items():
        n = len(reads)
        rel = str(pathlib.Path(path).resolve().relative_to(_PKG)) \
            if pathlib.Path(path).resolve().is_relative_to(_PKG) else path
        fn = _function_at(path, line)
        if not _marked(path, line):
            rep.add(Finding(
                "host-sync", "error", where,
                f"{n} unmarked host read(s) of "
                f"{TAINT_NAMES[max(r.taint for r in reads)]} data inside "
                "a certified round: a hidden sync that breaks the "
                "one-sync-per-block contract",
            ))
        elif (rel, fn) in DEVIATION_READS:
            rep.add(Finding(
                "host-sync", "warning", where,
                f"documented deviation (ROADMAP item 12): {n} per-slot "
                f"'settled' read(s) in {fn}, one a slot, where JAX's "
                "lax.scan reads none; a CUDA graph of the block would "
                "remove them",
            ))
        else:
            rep.add(Finding("host-sync", "info", where,
                            f"{n} marked host read(s)"))
    if not by_site:
        rep.add(Finding(
            "host-sync", "info", target,
            "host-read-free round: its only host point is the driver's "
            "read-back after it",
        ))
    return rep


# -- fixed-point headroom lint ---------------------------------------------


@dataclasses.dataclass(frozen=True)
class SummaryBounds:
    """Configuration-level magnitude bounds on one institution's summary.

    From these deployment facts the lint derives worst-case bounds on
    every summary statistic an institution encodes:

    * hessian entry:  ``0.25 * n_max * x_max**2``  (logistic w <= 1/4)
    * gradient entry: ``n_max * x_max``            (|y - p| <= 1)
    * deviance:       ``2 * n_max * (log 2 + d * x_max * beta_max)``
    * count:          ``n_max``
    """

    d: int
    n_max: int
    num_parts: int
    x_max: float = 1.0
    beta_max: float = 10.0

    def eta_max(self) -> float:
        return self.d * self.x_max * self.beta_max

    def max_abs(self) -> float:
        hess = 0.25 * self.n_max * self.x_max ** 2
        grad = self.n_max * self.x_max
        dev = 2.0 * self.n_max * (math.log(2.0) + self.eta_max())
        return max(hess, grad, dev, float(self.n_max))


def lint_headroom(bounds: SummaryBounds, aggregator=None,
                  report: AnalysisReport | None = None) -> AnalysisReport:
    """Prove the overflow invariants from config bounds, statically.

    The static twin of ``check_aggregation_headroom`` (the exact int64
    share sum: ``S * max(p_r) < 2**63``) and of
    ``FixedPointCodec.check_headroom`` / ``SecureCollective.headroom_ok``
    (the decoded aggregate fits the codec's signed capacity).
    """
    from ..core.collective import ACCUMULATOR_LIMIT, SecureCollective

    if aggregator is None:
        aggregator = SecureCollective(backend="kernel")
    rep = report or AnalysisReport(target="headroom")
    field = aggregator.scheme.field
    s = bounds.num_parts

    worst = s * max(field.moduli)
    if worst >= ACCUMULATOR_LIMIT:
        rep.add(Finding(
            "headroom", "error", "aggregation",
            f"S * max(p_r) = {s} * {max(field.moduli)} = {worst} >= "
            "2**63: the Algorithm-2 int64 residue accumulator can wrap "
            "— at these moduli at most "
            f"{(ACCUMULATOR_LIMIT - 1) // max(field.moduli)} institutions "
            "are admissible",
        ))
    else:
        rep.add(Finding(
            "headroom", "info", "aggregation",
            f"S * max(p_r) = {worst} < 2**63 "
            f"({math.log2(ACCUMULATOR_LIMIT / worst):.1f} bits of "
            "accumulator headroom)",
        ))

    cap = aggregator.codec.capacity()
    need = bounds.max_abs() * s
    if not aggregator.headroom_ok(bounds.max_abs(), s):
        rep.add(Finding(
            "headroom", "error", "codec",
            f"worst-case aggregate {need:.3g} >= codec capacity "
            f"{cap:.3g} (frac_bits={aggregator.codec.frac_bits}): the "
            "encoded aggregate would saturate — shrink n_max/num_parts "
            "or the payload bounds",
        ))
    else:
        rep.add(Finding(
            "headroom", "info", "codec",
            f"worst-case aggregate {need:.3g} < capacity {cap:.3g} "
            f"({math.log2(cap / need):.1f} bits of codec headroom)",
        ))
    return rep


# -- mesh-axis lint --------------------------------------------------------


def lint_mesh_axes(collectives, target: str,
                   report: AnalysisReport | None = None) -> AnalysisReport:
    """Every collective of a certified run is over a protocol mesh axis,
    bound by the mesh in use.  ``collectives`` is
    ``GateTrace.collectives``."""
    from ..distributed.sharding import POD_AXIS, SHARE_AXIS

    allowed = {POD_AXIS, SHARE_AXIS}
    rep = report or AnalysisReport(target=target)
    for e in collectives:
        if e.axis not in allowed:
            rep.add(Finding(
                "mesh-axes", "error", e.where,
                f"collective over unknown axis '{e.axis}' — protocol "
                f"collectives run only over {sorted(allowed)}",
            ))
        elif e.mesh_axes is None:
            rep.add(Finding(
                "mesh-axes", "warning", e.where,
                f"collective over '{e.axis}' outside any mesh: axis size "
                "unprovable",
            ))
        elif e.axis not in e.mesh_axes:
            rep.add(Finding(
                "mesh-axes", "error", e.where,
                f"axis '{e.axis}' is not bound by the mesh in use (mesh "
                f"axes: {sorted(e.mesh_axes)})",
            ))
    if collectives:
        rep.add(Finding(
            "mesh-axes", "info", target,
            f"{len(collectives)} collective axis reference(s) checked",
        ))
    return rep


# -- obs purity lint -------------------------------------------------------

# the observability core: host-side bookkeeping the drivers import at
# load time — stdlib-only, and never observing a device value
OBS_CORE_MODULES = ("obs/trace.py", "obs/ledger.py", "obs/metrics.py",
                    "obs/gate.py")

# (module, enclosing function, imported module): the one sanctioned
# non-stdlib import — the lazy, failure-tolerant profiler hook
_OBS_IMPORT_EXCEPTIONS = {
    ("obs/trace.py", "_annotation", "torch.profiler"),
    ("obs/trace.py", "_annotation", "torch"),
}

_BANNED_IMPORT_ROOTS = {"torch", "numpy", "np", "jax", "jaxlib", "repro"}
# attribute names that pull data off a device or wait for it
_BANNED_NAMES = {"item", "tolist", "cpu", "numpy", "synchronize",
                 "asarray", "device_get", "block_until_ready"}


def _enclosing_functions(tree: ast.Module):
    """Map every node id to the name of its innermost enclosing def."""
    owner: dict[int, str] = {}

    def walk(node, fn):
        for ch in ast.iter_child_nodes(node):
            nfn = ch.name if isinstance(
                ch, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn
            owner[id(ch)] = nfn
            walk(ch, nfn)

    walk(tree, "")
    return owner


def lint_obs_purity(report: AnalysisReport | None = None, *,
                    modules=None) -> AnalysisReport:
    """Pin the observability core to pure host-side stdlib Python.

    ``modules`` (for tests) maps a display name to source text; default
    is :data:`OBS_CORE_MODULES` read from the package sources.
    """
    rep = report or AnalysisReport(target="obs-purity")
    if modules is None:
        modules = {rel: (_PKG / rel).read_text()
                   for rel in OBS_CORE_MODULES}
    for name, src in modules.items():
        tree = ast.parse(src)
        owner = _enclosing_functions(tree)
        clean = True
        for node in ast.walk(tree):
            fn = owner.get(id(node), "")
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import)
                        else [node.module or ""] if not node.level else [])
                for mod in mods:
                    if mod.split(".")[0] not in _BANNED_IMPORT_ROOTS or \
                            (name, fn, mod) in _OBS_IMPORT_EXCEPTIONS:
                        continue
                    clean = False
                    rep.add(Finding(
                        "obs-purity", "error", f"{name}:{node.lineno}",
                        f"import of '{mod}' in the obs core — the tracer, "
                        "ledger, metrics and gate hooks stay stdlib-only "
                        "(only the lazy profiler hook may touch torch)",
                    ))
            elif isinstance(node, ast.Attribute) and \
                    node.attr in _BANNED_NAMES:
                clean = False
                rep.add(Finding(
                    "obs-purity", "error", f"{name}:{node.lineno}",
                    f"'.{node.attr}' in the obs core — a device read would "
                    "make instrumentation a hidden sync; obs records only "
                    "host values the drivers already read back",
                ))
        if clean:
            rep.add(Finding("obs-purity", "info", name,
                            "stdlib-only, no device materializers"))
    return rep


# -- collective ownership lint ---------------------------------------------

# the boundary wrappers only core/collective.py may invoke
_BOUNDARY_FNS = ("_protect_flat", "_reveal_flat", "_distributed_reveal")

# files (package-relative) where calling a boundary wrapper is sanctioned:
# the owner, the deliberate-leak audit fixture, and the raw kernel layer
BOUNDARY_CALL_EXEMPT = (
    "core/collective.py",
    "obs/audit.py",
    "kernels/ops.py",
)


def lint_collective_sites(report: AnalysisReport | None = None, *,
                          modules=None) -> AnalysisReport:
    """Every protect/reveal boundary CALL lives in core/collective.py.

    Walks the package sources (or ``modules``, a display-name -> source
    map, for tests) and flags any ``ast.Call`` whose callee — bare name
    or attribute — is one of the three boundary wrappers, outside the
    exempt files.  Importing the names is allowed; only invoking them
    builds a second chain.
    """
    rep = report or AnalysisReport(target="collective-sites")
    if modules is None:
        modules = {str(p.relative_to(_PKG)): p.read_text()
                   for p in sorted(_PKG.rglob("*.py"))}
    calls = 0
    for name, src in modules.items():
        exempt = name in BOUNDARY_CALL_EXEMPT
        for node in ast.walk(ast.parse(src)):
            if not isinstance(node, ast.Call):
                continue
            callee = _call_callee(node)
            if callee not in _BOUNDARY_FNS:
                continue
            calls += 1
            if not exempt:
                rep.add(Finding(
                    "collective-sites", "error", f"{name}:{node.lineno}",
                    f"direct call to boundary wrapper '{callee}' outside "
                    "core/collective.py — drivers must route through "
                    "SecureCollective so the one chain stays the only "
                    "chain (ledger, gate hooks and byte telemetry all "
                    "anchor there)",
                ))
    rep.add(Finding(
        "collective-sites", "info", "collective-sites",
        f"{calls} boundary call site(s) scanned; owner + "
        f"{len(BOUNDARY_CALL_EXEMPT) - 1} sanctioned exceptions "
        "(obs/audit.py leak fixture, kernels/ops.py raw layer)",
    ))
    return rep


# -- kernel knob lint --------------------------------------------------------


def lint_kernel_knobs(report: AnalysisReport | None = None, *, knobs=None,
                      registers=None) -> AnalysisReport:
    """Check the CUDA kernels' launch knobs without building them.

    Reuses ``kernels.tuning``'s model of the H100: every instantiation's
    threads and the shared memory of its largest launch against the
    card's budget.  ``registers`` ({instantiation: registers a thread},
    from the built library on the card) also holds each to its launch
    bounds' cap.
    """
    from ..kernels.tuning import H100, validate_real_kernel_knobs

    rep = report or AnalysisReport(target="kernel-knobs")
    try:
        results = validate_real_kernel_knobs(knobs, registers=registers)
    except ValueError as e:
        rep.add(Finding("kernel-knobs", "error", "kernels.tuning",
                        f"launch knob rejected: {e}"))
        return rep
    for r in results:
        pct = 100.0 * r["smem_bytes"] / H100.smem_block
        blocks = (f", {r['blocks_per_sm']} block(s) an SM at least"
                  if "blocks_per_sm" in r else "")
        rep.add(Finding(
            "kernel-knobs", "info", r["kernel"],
            f"{r['instantiations']} instantiation(s), "
            f"{'/'.join(map(str, r['threads']))} threads a block, register "
            f"cap {r['register_cap']} a thread, shared memory up to "
            f"{r['smem_bytes']} B = {pct:.1f}% of the {H100.smem_block} B a "
            f"block can have{blocks}",
        ))
    return rep
