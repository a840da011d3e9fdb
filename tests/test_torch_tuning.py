"""Port vs JAX package: the kernels' launch knobs (``kernels/tuning.py``)
and their lint (``analysis/lints.py::lint_kernel_knobs``).

The JAX package models its Pallas kernels' VMEM working set; the port
models its CUDA kernels' launch against the H100: threads, the register
cap a ``__launch_bounds__`` leaves, shared memory.  The mirror of
``tests/test_analysis.py``'s knob-lint cases, each beside the JAX lint on
its own knobs: the defaults fit (one info finding a family), a misaligned
knob is rejected and the message names it, an oversized working set is
rejected.

Then the model against what the card reported: the 18 flash
instantiations' dynamic shared memory equal to what
``repro_k7_smem_bytes``/``repro_k8_smem_bytes`` returned on the H100
(``chip_smoke.py``'s ``{"flash_ptxas": ...}`` line on an NVIDIA H100
80GB HBM3), the
static shared memory ptxas reported (K1's struct path 64 B, the IRLS
reduce 2,048 B), and the blocks an SM from those runs' registers; and
``check_compiled``'s comparison on attributes made to agree and to
disagree.  The card's own comparison is ``tests/test_torch_cuda.py``'s.
"""
import pytest

from repro_torch.analysis.lints import lint_kernel_knobs
from repro_torch.kernels import tuning
from repro_torch.kernels.tuning import DEFAULT_KNOBS

# an earlier H100 run: the flash kernels' dynamic shared memory from the
# exports, and registers a thread from ptxas
H100_FLASH_SMEM = {
    "K7 bf16 D256": 101376, "K7 bf16 D128": 87040, "K7 bf16 D64": 46080,
    "K7 bf16 D32": 25600, "K7 f32 D128": 99072, "K7 f32 D256": 197376,
    "K8b bf16 D256": 188928, "K8b bf16 D128": 142848, "K8b bf16 D64": 93696,
    "K8b bf16 D32": 69120, "K8b f32 D256": 140416, "K8b f32 D128": 166144,
    "K8a bf16 D256": 101376, "K8a bf16 D128": 104448, "K8a bf16 D64": 55296,
    "K8a bf16 D32": 30720, "K8a f32 D256": 131584, "K8a f32 D128": 132096}
H100_REGISTERS = {
    "K7 bf16 D256": 239, "K7 bf16 D128": 206, "K7 bf16 D64": 152,
    "K7 bf16 D32": 122, "K7 f32 D128": 128, "K7 f32 D256": 157,
    "K8b bf16 D256": 170, "K8b bf16 D128": 233, "K8b bf16 D64": 166,
    "K8b bf16 D32": 128, "K8b f32 D256": 146, "K8b f32 D128": 154,
    "K8a bf16 D256": 245, "K8a bf16 D128": 241, "K8a bf16 D64": 167,
    "K8a bf16 D32": 140, "K8a f32 D256": 104, "K8a f32 D128": 156,
    **{f"{f} gram N{t}": r for f in ("K3", "K5", "K6")
       for t, r in ((32, 96), (128, 168))},
    **{f"{f} rows MTW{m}": r for f in ("K3", "K5")
       for m, r in ((16, 128), (8, 128), (4, 125), (2, 112))},
    **{f"{f} reduce": 32 for f in ("K3", "K5", "K6")},
    "K1 f32 struct": 56, "K1 f32 table": 60, "K1 f64 struct": 56,
    "K1 f64 table": 56, "K4": 62, "K2 struct": 40, "K2 table": 48}


def test_kernel_knob_lint_default_knobs_fit():
    from repro.analysis.lints import lint_kernel_knobs as jax_lint

    assert jax_lint().ok
    rep = lint_kernel_knobs()
    assert rep.ok, rep.format(verbose=True)
    infos = [f for f in rep.findings if f.severity == "info"]
    assert [f.where for f in infos] == list(DEFAULT_KNOBS)
    assert sum(len(tuning.instantiations(k)) for k in DEFAULT_KNOBS.values()) \
        == 42


@pytest.mark.parametrize("family,knob,value", [
    ("K7", "block_k", 40), ("K8a", "block_q", 48), ("K1", "threads", 100),
    ("K4", "elements", 3), ("K3", "cb", 4), ("K8b", "block_k_wide", 20)])
def test_kernel_knob_lint_rejects_misaligned_knobs(family, knob, value):
    from repro.analysis.lints import lint_kernel_knobs as jax_lint
    from repro.kernels.tuning import DEFAULT_KNOBS as JAX_KNOBS

    jax_knobs = dict(JAX_KNOBS)
    jax_knobs["fused_irls"] = jax_knobs["fused_irls"].replace(block_n=7)
    assert any("block_n=7" in f.message for f in jax_lint(
        knobs=jax_knobs).errors())
    knobs = dict(DEFAULT_KNOBS)
    knobs[family] = knobs[family].replace(**{knob: value})
    rep = lint_kernel_knobs(knobs=knobs)
    assert not rep.ok
    assert any(f"{knob}={value}" in f.message for f in rep.errors())


def test_kernel_knob_lint_rejects_an_oversized_working_set():
    from repro.analysis.lints import lint_kernel_knobs as jax_lint
    from repro.kernels.tuning import DEFAULT_KNOBS as JAX_KNOBS

    jax_knobs = dict(JAX_KNOBS)
    jax_knobs["shamir_protect_flat"] = \
        jax_knobs["shamir_protect_flat"].replace(block_rows=1 << 20)
    assert not jax_lint(knobs=jax_knobs).ok
    knobs = dict(DEFAULT_KNOBS)
    knobs["K8b"] = knobs["K8b"].replace(block_k=192)  # 286,208 B at D 128
    rep = lint_kernel_knobs(knobs=knobs)
    assert not rep.ok
    assert any("K8b bf16 D128" in f.message and "block_k=192" in f.message
               for f in rep.errors())
    knobs = dict(DEFAULT_KNOBS)
    knobs["K1"] = knobs["K1"].replace(stage=1 << 16)  # 256 KB of points
    assert not lint_kernel_knobs(knobs=knobs).ok


def test_register_lint_holds_the_compiled_count_to_its_cap():
    assert lint_kernel_knobs(registers=H100_REGISTERS).ok
    over = dict(H100_REGISTERS, **{"K4": 72})  # launch bounds (128, 8): 64
    rep = lint_kernel_knobs(registers=over)
    assert not rep.ok and "K4 compiled to 72" in rep.errors()[0].message


def test_the_model_is_the_cards_shared_memory():
    model = {name: dyn for kn in DEFAULT_KNOBS.values()
             for name, (_, dyn) in tuning.smem_bytes(kn).items()}
    assert {k: model[k] for k in H100_FLASH_SMEM} == H100_FLASH_SMEM
    static = {name: st for kn in DEFAULT_KNOBS.values()
              for name, (st, _) in tuning.smem_bytes(kn).items() if st}
    assert static == {"K1 f32 struct": 64, "K1 f64 struct": 64,
                      "K3 reduce": 2048, "K5 reduce": 2048,
                      "K6 reduce": 2048}


def test_blocks_an_sm():
    insts = {i.name: i for kn in DEFAULT_KNOBS.values()
             for i in tuning.instantiations(kn)}
    blocks = {n: tuning.blocks_per_sm(i, H100_REGISTERS[n])
              for n, i in insts.items()}
    # registers: 208 x 128 a block, 2 fit; shared memory: 87,040 + 1,024
    assert blocks["K7 bf16 D128"] == 2
    # the wide Gram: 168 x 384 registers (its consumers take 216 of the
    # producer warpgroup's, setmaxnreg); the narrow one 96 x 160
    assert [blocks[f"K3 gram N{t}"] for t in (32, 128)] == [4, 1]
    assert blocks["K4"] == 8              # 64 x 128 registers
    assert blocks["K1 f32 table"] == 4    # 49,152 B of staged points
    assert blocks["K3 reduce"] == 8       # threads: 2,048 / 256
    # the rows kernel's launch bounds promise 2; at d 1024 its 8-row tile
    # takes 210,624 B, and one fits
    assert [blocks[f"K3 rows MTW{m}"] for m in (2, 4, 8, 16)] == [2, 2, 2, 1]
    assert tuning.register_cap(384, 1) == 168
    assert tuning.register_cap(160, 3) == 136
    assert tuning.register_cap(128, 2) == 255


def _attributes(registers):
    """The attributes the card would report if the model were right."""
    out = {}
    for kn in DEFAULT_KNOBS.values():
        for i in tuning.instantiations(kn):
            out[i.name] = {
                "registers": registers[i.name], "static_smem": i.static_smem,
                "local_bytes": 0, "max_threads": i.threads,
                "dynamic_smem": i.dynamic_smem,
                "blocks_per_sm": tuning.blocks_per_sm(i, registers[i.name])}
    return out


def test_check_compiled_holds_the_model_to_the_attributes():
    families = tuning.check_compiled(attributes=_attributes(H100_REGISTERS))
    assert families["K7"] == {"registers": 239, "smem_bytes": 197376,
                              "blocks_per_sm": 1, "instantiations": 6}
    assert sum(f["instantiations"] for f in families.values()) == 42
    for field, delta in (("static_smem", 16), ("blocks_per_sm", 1),
                         ("max_threads", 32), ("dynamic_smem", 8)):
        attrs = _attributes(H100_REGISTERS)
        attrs["K8a bf16 D64"][field] += delta
        with pytest.raises(RuntimeError, match="K8a bf16 D64"):
            tuning.check_compiled(attributes=attrs)
    attrs = _attributes(H100_REGISTERS)
    del attrs["K2 table"]
    with pytest.raises(RuntimeError, match="K2 table"):
        tuning.check_compiled(attributes=attrs)
