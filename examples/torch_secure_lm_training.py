"""The paper's technique as an LM-training feature, on the PyTorch port:
secret-shared gradient aggregation across institutions, with
checkpoint/restart.

Four institutions co-train a small decoder LM; per-institution gradients
are fixed-point-encoded, Shamir-shared 2-of-3 and aggregated share-wise
(K1 shares the stacked gradients, K2 reveals their sum), so no
institution's gradient is ever visible to the others or to any single
Computation Center.  Mid-run we kill and restore from checkpoint.  The
twin of ``examples/secure_lm_training.py``: the same command lines and
lines, through ``repro_torch.launch.train``, on the CUDA card unless
``--device cpu`` is given.

  PYTHONPATH=src python examples/torch_secure_lm_training.py [--device cpu]
"""
import argparse
import pathlib
import shutil
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402


def argv(ckpt_dir: str, device: str) -> list[str]:
    """The example's command line, without ``--steps``."""
    return [
        "--arch", "deepseek_7b", "--smoke",
        "--batch", "8", "--seq-len", "64",
        "--secure-agg", "shamir", "--institutions", "4",
        "--checkpoint-dir", ckpt_dir, "--checkpoint-every", "5",
        "--log-every", "5", "--device", device,
    ]


def run(device=None, ckpt_dir=None) -> dict:
    """Both phases; returns each one's JSON report.  ``ckpt_dir`` keeps
    the checkpoints (a temporary directory, removed after, by default)."""
    dev = str(resolve_device(device))
    own = ckpt_dir is None
    ckpt_dir = tempfile.mkdtemp(prefix="secure_lm_") if own else ckpt_dir
    common = argv(ckpt_dir, dev)
    try:
        print("=== phase 1: train 10 steps, checkpointing every 5 ===")
        first = train_mod.main(common + ["--steps", "10"])

        print("\n=== phase 2: 'crash', resume from step 10, train to 15 ===")
        resumed = train_mod.main(common + ["--steps", "15", "--resume"])
    finally:
        if own:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    print("OK")
    return {"phase1": first, "phase2": resumed, "device": dev}


def resume_against_uninterrupted(device=None, root=None) -> dict:
    """What the restart must give: a 15-step run, uninterrupted, and the
    same run resumed from its step-10 checkpoint (its step-15 file taken
    away) to step 15.  Returns both reports and whether the resumed
    losses and final checkpoint equal the uninterrupted run's bit for
    bit.  (Phase 1's 10-step run is not that run: the warm-up is half of
    ``--steps``, 5 there and 7 here, in both packages' drivers.)"""
    dev = str(resolve_device(device))
    own = root is None
    root = pathlib.Path(tempfile.mkdtemp(prefix="secure_lm_") if own
                        else root)
    whole_dir, resumed_dir = root / "whole", root / "resumed"
    try:
        whole = train_mod.main(argv(str(whole_dir), dev) + ["--steps", "15"])
        shutil.copytree(whole_dir, resumed_dir)
        (resumed_dir / "ckpt_0000000015.npz").unlink()
        resumed = train_mod.main(argv(str(resumed_dir), dev)
                                 + ["--steps", "15", "--resume"])
        with np.load(whole_dir / "ckpt_0000000015.npz") as a, \
                np.load(resumed_dir / "ckpt_0000000015.npz") as b:
            same_state = (sorted(a.files) == sorted(b.files) and all(
                np.array_equal(a[k], b[k]) for k in a.files))
    finally:
        if own:
            shutil.rmtree(root, ignore_errors=True)
    return {"whole": whole, "resumed": resumed,
            "losses_equal": resumed["losses"] == whole["losses"][10:],
            "state_equal": bool(same_state)}


def main(args=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return run(ap.parse_args(args).device)


if __name__ == "__main__":
    main()
