"""The launch knobs of the port's CUDA kernels, and a model of what they
cost the H100: the counterpart of the JAX package's ``kernels/tuning.py``.

The JAX package's knobs are Pallas block sizes whose VMEM working set it
models before a TPU compile.  The port's kernels are compiled for one
card, so their knobs are the CUDA launch's: threads a block, the blocks
an SM each kernel's ``__launch_bounds__`` promises (which caps its
registers a thread), the elements a thread takes, and the tiles of the
flash kernels and the IRLS plan.  One :class:`KernelKnobs` record a
kernel family (:data:`DEFAULT_KNOBS`) holds the values the sources
compile with (``csrc/*.cu``); :func:`instantiations` expands a record
into its compiled instantiations, 42 in all, each with its threads, its
register cap and the static and dynamic shared memory its largest launch
asks for (:func:`smem_bytes`: pure arithmetic, the sources' formulas).

:func:`validate_real_kernel_knobs` holds every instantiation to the
H100's budget (``H100``: 232,448 bytes of shared memory a block, 65,536
registers an SM, 255 a thread, 1,024 threads a block, 2,048 an SM) and to
the alignment its code needs, and raises ``ValueError`` naming the first
knob that could not launch, as the JAX function does.  It needs no card.

On the card, :func:`compiled_attributes` asks the built library
(``repro_kernel_attributes``: ``cudaFuncGetAttributes`` and the occupancy
API for every instantiation) and :func:`check_compiled` holds the model
to it: the same shared memory, static and dynamic, the same threads, the
registers within the cap, and the same blocks an SM.  A model that
disagrees with the compiled kernel raises.
"""
from __future__ import annotations

import ctypes
import dataclasses

__all__ = ["DEFAULT_KNOBS", "H100", "KernelKnobs", "blocks_per_sm",
           "check_compiled", "compiled_attributes", "instantiations",
           "register_cap", "smem_bytes", "validate_real_kernel_knobs"]


@dataclasses.dataclass(frozen=True)
class Budget:
    """What one SM of the card gives a kernel (NVIDIA's H100 data sheet
    and the CUDA occupancy rules for compute capability 9.0)."""

    smem_block: int = 232_448     # shared memory a block can ask for
    smem_sm: int = 233_472        # shared memory an SM gives its blocks
    smem_reserved: int = 1_024    # the runtime's own, a block
    regs_sm: int = 65_536
    regs_thread: int = 255
    reg_unit: int = 8             # registers a thread are allocated in 8s
    threads_block: int = 1_024
    threads_sm: int = 2_048
    blocks_sm: int = 32


H100 = Budget()


@dataclasses.dataclass(frozen=True)
class KernelKnobs:
    """One kernel family's launch knobs, as ``csrc/`` compiles them.

    ``threads``: threads a block (the bf16 tensor-core kernels' for the
    flash family, the rows and reduce kernels' for the IRLS family);
    ``min_blocks``: the blocks an SM its ``__launch_bounds__`` promises;
    ``elements``: elements a thread (K1, K2, K4: 16-byte accesses);
    ``block_q``, ``block_k``, ``block_k_wide``: a flash kernel's query
    rows a block and key rows a tile (``block_k_wide`` at head dim 256);
    ``f32_threads``: the flash family's float32 CUDA-core kernels' threads;
    ``cb``: configurations a rows block, and ``gram_threads`` the wide
    Gram kernel's threads: two consumer warpgroups and a producer one
    (IRLS; the narrow ones take one warpgroup and a producer warp);
    ``stage``: the most points (K1) or weights
    (K2) a table-path launch stages in shared memory.
    """

    kernel: str
    threads: int
    min_blocks: int = 1
    elements: int = 0
    block_q: int = 0
    block_k: int = 0
    block_k_wide: int = 0
    f32_threads: int = 0
    cb: int = 0
    gram_threads: int = 0
    stage: int = 0

    def replace(self, **kw) -> "KernelKnobs":
        return dataclasses.replace(self, **kw)


# The values the sources compile with (K1_THREADS, K7Tile, K8aTile,
# K8Tile, IRLS_THREADS, IrlsGram<128>::THREADS, IRLS_CB, K1_STAGE_POINTS,
# ...)
DEFAULT_KNOBS = {
    "K1": KernelKnobs("K1", threads=128, min_blocks=8, elements=4,
                      stage=12_288),
    "K2": KernelKnobs("K2", threads=128, min_blocks=8, elements=4,
                      stage=6_144),
    "K4": KernelKnobs("K4", threads=128, min_blocks=8, elements=2),
    "K3": KernelKnobs("K3", threads=256, min_blocks=2, cb=8,
                      gram_threads=384),
    "K5": KernelKnobs("K5", threads=256, min_blocks=2, cb=8,
                      gram_threads=384),
    "K6": KernelKnobs("K6", threads=256, min_blocks=2, cb=8,
                      gram_threads=384),
    "K7": KernelKnobs("K7", threads=128, min_blocks=2, block_q=64,
                      block_k=64, block_k_wide=32, f32_threads=256),
    "K8a": KernelKnobs("K8a", threads=128, min_blocks=2, block_q=64,
                       block_k=64, block_k_wide=16, f32_threads=256),
    "K8b": KernelKnobs("K8b", threads=256, min_blocks=1, block_q=64,
                       block_k=64, block_k_wide=32, f32_threads=256),
}

_FLASH_DP = (32, 64, 128, 256)  # the bf16 instantiations' padded head dims
# the Gram's IRLS_TN; its warpgroup tile widths (IrlsGram<NT>), the blocks
# an SM their launch bounds promise, and the narrow ones' threads (a
# warpgroup and a producer warp)
_IRLS_TN = 32
_IRLS_GRAM_NT = {32: 3, 128: 1}
_IRLS_NARROW_THREADS = 128 + 32
_IRLS_TWO_PER_SM = 113 * 1024
_IRLS_STAT, _IRLS_REDUCE_STATIC = 4, 256 * 8  # double part[IRLS_THREADS]
_K1_STRUCT_POINTS = 16


@dataclasses.dataclass(frozen=True)
class Instantiation:
    """One compiled kernel: its name in ``repro_kernel_attributes``, its
    launch's threads, the blocks an SM its launch bounds promise (0:
    none), and the shared memory of its largest launch."""

    name: str
    threads: int
    min_blocks: int
    static_smem: int
    dynamic_smem: int


# -- the sources' shared-memory formulas ------------------------------------

def _k7_bf16(kn, dp):
    bk = kn.block_k_wide if dp > 128 else kn.block_k
    return (kn.block_q + 4 * bk) * (dp + 8) * 2  # Q, two stages of K, V


def _k7_f32(kn, d):
    bq = bk = kn.block_q
    kp = max(bk * (d + 1), bq * (bk + 1))  # the K tile, then P over it
    return ((bq + bk) * (d + 1) + kp) * 4


def _k8a_bf16(kn, dp):
    bk = kn.block_k_wide if dp > 128 else kn.block_k
    return (2 * kn.block_q + 4 * bk) * (dp + 8) * 2  # Q, dO, K and V


def _k8b_bf16(kn, dp):
    bk = kn.block_k_wide if dp > 128 else kn.block_k
    ld, pld = dp + 8, kn.block_q + 8
    # K, V; two stages of q and do; P^T and dS^T as hi + lo; two stages of
    # (m, linv, delta) rows
    return (2 * bk * ld + 4 * kn.block_q * ld + 4 * bk * pld) * 2 \
        + 2 * 3 * kn.block_q * 4


def _k8a_f32(rows, d):
    return (3 * rows * (d + 1) + rows * max(d + 1, rows + 1)) * 4


def _k8b_f32(rows, d):
    return (4 * rows * (d + 1) + 2 * rows * (rows + 1) + 3 * rows) * 4


def _irls_ldx(d):
    return (d + 15) // 16 * 16 + 4


def _irls_rows_smem(kn, d, tnr):
    ldx = _irls_ldx(d)
    return 8 * (2 * tnr * ldx + kn.cb * ldx + 64 * kn.cb + kn.cb * (tnr + 4)
                + 2 * tnr + kn.threads * _IRLS_STAT) + 4 * 2 * tnr


def _irls_rows_tile(kn, d):
    """The largest of 32, 16, 8 rows whose rows-kernel shared memory lets
    two blocks share an SM, else 8."""
    for tn in (32, 16, 8):
        if _irls_rows_smem(kn, d, tn) <= _IRLS_TWO_PER_SM:
            return tn
    return 8


def _irls_gram_smem(nt):
    """The split stages (x_hi and x_lo), the raw stages (the j-range, and
    the i-range at the wide width, rows padded by 8, with their weights),
    and a full and an empty mbarrier a stage of each: IrlsGram<NT>."""
    wide = nt > 64
    raw, split = (3, 3) if wide else (4, 2)
    return 4 * (split * 2 * nt * _IRLS_TN
                + raw * ((1 + wide) * _IRLS_TN * (nt + 8) + _IRLS_TN)) \
        + 8 * 2 * (raw + split)


def instantiations(knobs: KernelKnobs) -> list:
    """Every compiled instantiation of ``knobs``' family, each with the
    shared memory of its largest launch: a flash kernel at the largest
    head dim it takes, an IRLS rows kernel at the largest d of its m-tiles
    a warp, K1's and K2's table paths at the most they stage."""
    kn, fam = knobs, knobs.kernel
    if fam == "K1":
        return [Instantiation(f"K1 {t} {path}", kn.threads, kn.min_blocks,
                              _K1_STRUCT_POINTS * 4 if path == "struct"
                              else 0, kn.stage * 4 if path == "table" else 0)
                for t in ("f32", "f64") for path in ("struct", "table")]
    if fam == "K2":
        return [Instantiation("K2 struct", kn.threads, kn.min_blocks, 0, 0),
                Instantiation("K2 table", kn.threads, kn.min_blocks, 0,
                              kn.stage * 8)]
    if fam == "K4":
        return [Instantiation("K4", kn.threads, kn.min_blocks, 0, 0)]
    if fam in ("K3", "K5", "K6"):
        out = [] if fam == "K6" else [
            Instantiation(f"{fam} rows MTW{m}", kn.threads, kn.min_blocks, 0,
                          _irls_rows_smem(kn, 64 * m,
                                          _irls_rows_tile(kn, 64 * m)))
            for m in (2, 4, 8, 16)]
        return out + [
            Instantiation(f"{fam} gram N{nt}",
                          kn.gram_threads if nt > 64 else
                          _IRLS_NARROW_THREADS, blocks, 0,
                          _irls_gram_smem(nt))
            for nt, blocks in _IRLS_GRAM_NT.items()] + [
            Instantiation(f"{fam} reduce", kn.threads, 0,
                          _IRLS_REDUCE_STATIC, 0)]
    bf16, f32 = {"K7": (_k7_bf16, None), "K8a": (_k8a_bf16, _k8a_f32),
                 "K8b": (_k8b_bf16, _k8b_f32)}[fam]
    out = [Instantiation(f"{fam} bf16 D{dp}", kn.threads, kn.min_blocks, 0,
                         bf16(kn, dp)) for dp in _FLASH_DP]
    for d, rows in ((128, 64), (256, 32)):  # FLASH_NC_SMALL, _LARGE
        if fam == "K7":
            out.append(Instantiation(f"K7 f32 D{d}", kn.f32_threads,
                                     2 if d == 128 else 1, 0,
                                     _k7_f32(kn, d)))
        else:
            out.append(Instantiation(f"{fam} f32 D{d}", kn.f32_threads, 1, 0,
                                     f32(rows, d)))
    return out


def smem_bytes(knobs: KernelKnobs) -> dict:
    """{instantiation: (static, dynamic) shared memory bytes of its
    largest launch} for ``knobs``' family."""
    return {i.name: (i.static_smem, i.dynamic_smem)
            for i in instantiations(knobs)}


def register_cap(threads: int, min_blocks: int) -> int:
    """The registers a thread ``__launch_bounds__(threads, min_blocks)``
    leaves the compiler: the register file shared by ``min_blocks``
    blocks, in the allocation unit, at most 255."""
    if not min_blocks:
        return H100.regs_thread
    cap = H100.regs_sm // (threads * min_blocks)
    return min(H100.regs_thread, cap // H100.reg_unit * H100.reg_unit)


def blocks_per_sm(inst: Instantiation, registers: int) -> int:
    """The blocks an SM holds at once of ``inst`` compiled to
    ``registers`` a thread: the least of what its registers (allocated
    a warp at a time, ``reg_unit`` a thread), its shared memory (with the
    runtime's reserve), its threads and the block limit allow."""
    unit = H100.reg_unit
    warp_regs = -(-registers // unit) * unit * 32
    warps = inst.threads // 32
    by_regs = (H100.regs_sm // warp_regs) // warps if warp_regs else \
        H100.blocks_sm
    smem = inst.static_smem + inst.dynamic_smem + H100.smem_reserved
    return min(by_regs, H100.smem_sm // smem,
               H100.threads_sm // inst.threads, H100.blocks_sm)


def _check_family(name: str, kn: KernelKnobs) -> None:
    """Raise on the first knob of ``kn`` that breaks an alignment its code
    needs."""
    for field in ("threads", "f32_threads", "gram_threads"):
        t = getattr(kn, field)
        if t and (t % 32 or t > H100.threads_block):
            raise ValueError(f"{name}: {field}={t} is not a whole number of "
                             f"warps within {H100.threads_block}")
    if kn.threads * max(kn.min_blocks, 1) > H100.threads_sm:
        raise ValueError(f"{name}: min_blocks={kn.min_blocks} blocks of "
                         f"{kn.threads} threads exceed an SM's "
                         f"{H100.threads_sm}")
    if kn.elements and kn.elements not in (1, 2, 4):
        raise ValueError(f"{name}: elements={kn.elements} is not a 16-byte "
                         "access's 1, 2 or 4")
    for field in ("block_q", "block_k", "block_k_wide"):
        b = getattr(kn, field)
        if b and b % 16:
            raise ValueError(f"{name}: {field}={b} breaks the 16-row "
                             "mma.sync m16n8k16 tile")
    if kn.block_q and kn.kernel in ("K7", "K8a") \
            and kn.block_q != 16 * (kn.threads // 32):
        raise ValueError(f"{name}: block_q={kn.block_q} is not 16 query "
                         f"rows for each of {kn.threads // 32} warps")
    if kn.cb and kn.cb != 8:
        raise ValueError(f"{name}: cb={kn.cb} is not the float64 mma's "
                         "n of 8")
    if kn.gram_threads and kn.gram_threads != 3 * 128:
        raise ValueError(f"{name}: gram_threads={kn.gram_threads} is not "
                         "two consumer warpgroups of 128 and a producer one")


def validate_real_kernel_knobs(knobs=None, *,
                               registers: dict | None = None) -> list:
    """Check every family's knobs against alignment and the card's
    budget, before any build or launch.

    Returns one report a family (``{kernel, instantiations, threads,
    register_cap, smem_bytes: its largest static + dynamic, smem_budget,
    ok}``); raises ``ValueError`` on the first knob that could not launch.
    With ``registers`` ({instantiation: registers a thread}, from the
    built library) each is also held to its cap and the report gains the
    fewest blocks an SM among the family's instantiations.
    """
    knobs = dict(DEFAULT_KNOBS if knobs is None else knobs)
    reports = []
    for name, kn in knobs.items():
        _check_family(name, kn)
        insts = instantiations(kn)
        for inst in insts:
            need = inst.static_smem + inst.dynamic_smem
            if need > H100.smem_block:
                raise ValueError(
                    f"{name}: {inst.name} asks for {need} bytes of shared "
                    f"memory, past the {H100.smem_block} a block can have "
                    f"({kn})")
            cap = register_cap(inst.threads, inst.min_blocks)
            regs = (registers or {}).get(inst.name)
            if regs is not None and regs > cap:
                raise ValueError(f"{name}: {inst.name} compiled to {regs} "
                                 f"registers a thread, past its cap {cap}")
        rep = {"kernel": name, "instantiations": len(insts),
               "threads": sorted({i.threads for i in insts}),
               "register_cap": min(register_cap(i.threads, i.min_blocks) for i in insts),
               "smem_bytes": max(i.static_smem + i.dynamic_smem
                                 for i in insts),
               "smem_budget": H100.smem_block, "ok": True}
        if registers is not None:
            rep["blocks_per_sm"] = min(
                blocks_per_sm(i, registers[i.name]) for i in insts)
        reports.append(rep)
    return reports


# -- the card ----------------------------------------------------------------

class _Attr(ctypes.Structure):
    """``ReproKernelAttr`` (csrc/kernel_attributes.cuh)."""

    _fields_ = [("name", ctypes.c_char * 48), ("registers", ctypes.c_int),
                ("static_smem", ctypes.c_int), ("local_bytes", ctypes.c_int),
                ("max_threads", ctypes.c_int), ("dynamic_smem", ctypes.c_int),
                ("blocks_per_sm", ctypes.c_int)]


def compiled_attributes() -> dict:
    """{instantiation: its compiled attributes} from the built library:
    registers a thread, static shared memory, local memory, maximum
    threads a block, the dynamic shared memory its largest launch asks for
    and the blocks an SM the occupancy API allows.  Needs the card."""
    from . import _build

    lib = _build.library()
    n = lib.repro_kernel_attributes(None, 0)
    recs = (_Attr * n)()
    got = lib.repro_kernel_attributes(ctypes.cast(recs, ctypes.c_void_p), n)
    if got != n:
        raise RuntimeError(f"repro_kernel_attributes: {got} (CUDA error "
                           f"{-got} if negative), {n} expected")
    return {r.name.decode(): {f: getattr(r, f) for f, _ in _Attr._fields_
                              if f != "name"} for r in recs}


def check_compiled(knobs=None, attributes: dict | None = None) -> dict:
    """Hold the model to the built kernels: for every instantiation the
    same static and dynamic shared memory, the launch's threads as the
    maximum a block, the registers within the cap, and the blocks an SM
    :func:`blocks_per_sm` gives from the compiled registers equal to the
    occupancy API's.  Returns {family: {registers (the most of any
    instantiation), smem_bytes, blocks_per_sm (the fewest), instantiations}};
    raises ``RuntimeError`` on a disagreement."""
    knobs = dict(DEFAULT_KNOBS if knobs is None else knobs)
    attrs = compiled_attributes() if attributes is None else attributes
    model = {i.name: (fam, i) for fam, kn in knobs.items()
             for i in instantiations(kn)}
    if set(model) != set(attrs):
        raise RuntimeError(
            f"instantiations: the model has {sorted(set(model) - set(attrs))}"
            f" the library lacks, the library "
            f"{sorted(set(attrs) - set(model))}")
    validate_real_kernel_knobs(knobs, registers={
        n: a["registers"] for n, a in attrs.items()})
    out: dict = {}
    for name, (fam, inst) in model.items():
        a = attrs[name]
        want = {"static_smem": inst.static_smem,
                "dynamic_smem": inst.dynamic_smem,
                "max_threads": inst.threads,
                "blocks_per_sm": blocks_per_sm(inst, a["registers"])}
        got = {k: a[k] for k in want}
        if got != want:
            raise RuntimeError(f"{name}: the model {want} disagrees with "
                               f"the compiled kernel {got}")
        rec = out.setdefault(fam, {"registers": 0, "smem_bytes": 0,
                                   "blocks_per_sm": H100.blocks_sm,
                                   "instantiations": 0})
        rec["registers"] = max(rec["registers"], a["registers"])
        rec["smem_bytes"] = max(rec["smem_bytes"],
                                inst.static_smem + inst.dynamic_smem)
        rec["blocks_per_sm"] = min(rec["blocks_per_sm"],
                                   want["blocks_per_sm"])
        rec["instantiations"] += 1
    return out
