"""The IRLS Gram's launch plan and kernel names, without a card.

The benchmark reads K3's and K5's device time by kernel name
(``port_bench/pbench/categories.py``, a frozen table): every ``__global__``
of ``csrc/fused_irls.cu``, ``csrc/fused_irls_cv.cu`` and
``csrc/gram_hessian.cu`` has to fall in its family's category, as the
source names it and as the profiler names an instantiation, or its time
would move into "small ops" and ``k3_roofline``/``k5_roofline`` would read
too high.  The sources' text and the table are read, neither edited.

Then ``_gram_slices``: at the cells' shapes (PASCAL alpha 8 x 62,500 x 500
as K3 and as K5 at 5 configurations, HIGGS 8 x 1,375,000 x 28) the Gram's
waves are at least 95% full, no slice is shorter than a tile, and K5's
400 blocks a slice find their count past the first four.
"""
import importlib.util
import math
import pathlib
import re

import pytest

from repro_torch.kernels.fused_irls import _gram_slices

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
SOURCES = (("fused_irls.cu", "K3"), ("fused_irls_cv.cu", "K5"),
           ("gram_hessian.cu", "K6"))
KERNELS = [(src, fam, name) for src, fam in SOURCES
           for name in GLOBAL.findall((CSRC / src).read_text())]


def _categories():
    spec = importlib.util.spec_from_file_location(
        "_pbench_categories", ROOT / "port_bench" / "pbench" / "categories.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_each_source_defines_its_rows_gram_and_reduce():
    found = {(src, name.split("_kernel")[0].rsplit("_", 1)[-1])
             for src, _, name in KERNELS}
    for src, fam in SOURCES:
        parts = {"gram", "reduce"} | (set() if fam == "K6" else {"rows"})
        assert {p for s, p in found if s == src} == parts, src


@pytest.mark.parametrize("source,family,name", KERNELS)
def test_every_irls_kernel_falls_in_its_familys_category(source, family,
                                                         name):
    cat = _categories()
    assert cat.category(name) == family
    for nt in (32, 128):  # as the profiler names an instantiation
        assert cat.category(
            f"void {name}<{nt}>(float const*, float const*, int const*, "
            f"float*, IrlsDims)") == family


def _efficiency(per_slice, nsl, wave):
    blocks = per_slice * nsl
    return blocks / (math.ceil(blocks / wave) * wave)


@pytest.mark.parametrize("what,per_slice,per_sm,n,want", [
    ("K3 at PASCAL alpha", 8 * 10, 1, 62_500, 8),
    ("K5 at PASCAL alpha, 5 configurations", 5 * 8 * 10, 1, 62_500, 6),
    ("K3 at HIGGS", 8, 4, 1_375_000, 66),
    ("a slice no shorter than a tile", 8 * 10, 1, 100, 4),
])
def test_gram_slices_fill_their_waves(what, per_slice, per_sm, n, want):
    plan = {"gram_per_sm": per_sm, "sms": 132, "tn_gram": 32}
    nsl = _gram_slices(per_slice, n, plan)
    assert nsl == want, what
    assert nsl <= math.ceil(n / 32)
    if nsl < math.ceil(n / 32):
        assert _efficiency(per_slice, nsl, per_sm * 132) >= 0.95
