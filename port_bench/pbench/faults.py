"""Faults a training cell can have, planted in the program's timed path:
for the readings that set a cell's limits (``calibrate.py --fault``) and
for the tests that see ``correct`` come out false.  Each is a list of
(module, attribute, replacement) patches; ``planted`` applies one for the
length of a ``with`` block.  The benchmark's own runs plant none.
"""
from __future__ import annotations

import contextlib


def step_unchanged() -> list:
    """The step returns its state unchanged (and a plausible answer)."""
    import repro_torch.launch.train as train

    def unchanged(params, state, *a, **k):
        return params, state, {"loss": 6.2, "grad_norm": 1.0, "lr": 3e-4,
                               "bytes": 0}

    return [(train, "train_step", unchanged)]


def half_batch() -> list:
    """Each institution's loss and gradient from the first half of its
    rows: the mean taken over the half kept."""
    import repro_torch.launch.train as train

    grads = train._loss_and_grads

    def half(params, batch, cfg):
        rows = batch["labels"].shape[0] // 2
        return grads(params, {k: v[:rows] for k, v in batch.items()}, cfg)

    return [(train, "_loss_and_grads", half)]


def exchange() -> list:
    """The centers' share-wise sum over the institutions left out: the
    first institution's shares alone are revealed (a secure cell's)."""
    import repro_torch.core.collective as collective

    def first(stacked, field, axis=0, residue_axis=1):
        return stacked.select(axis, 0)

    return [(collective, "fsum", first)]


def answer() -> list:
    """The step's loss altered where it is produced, by a part in 10^3."""
    import repro_torch.launch.train as train

    step = train.train_step

    def altered(*a, **k):
        params, state, m = step(*a, **k)
        return params, state, dict(m, loss=m["loss"] * (1 + 1e-3))

    return [(train, "train_step", altered)]


FAULTS = {"step_unchanged": step_unchanged, "half_batch": half_batch,
          "exchange": exchange, "answer": answer}


@contextlib.contextmanager
def planted(name: str | None):
    """The fault ``name`` planted for the block (none for None)."""
    patches = FAULTS[name]() if name else []
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, fn in patches:
        setattr(mod, attr, fn)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
