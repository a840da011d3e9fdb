"""What the benchmark's own tests share: its spec, and a cell cut to a size
the CPU holds (the configuration's rows and features made small, every
other setting as the cell states)."""
from __future__ import annotations

import dataclasses
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from pbench.spec import Spec  # noqa: E402

TINY = {"rows": 1200, "features": 6}


def spec() -> Spec:
    return Spec(ROOT)


def tiny_cell(name: str, **config):
    cell = spec().cell(name)
    return dataclasses.replace(cell, config=dict(cell.config, **TINY,
                                                 **config))
