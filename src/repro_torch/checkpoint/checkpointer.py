"""Checkpoint/restart: atomic, retain-k, optional async writer thread.

The JAX package's ``checkpoint/checkpointer.py``, file for file: one npz
per step whose keys are the tree paths joined by ``||`` exactly as JAX
writes them — a dict key as itself, a list index as its number, a
NamedTuple field as ``.name`` (``params||segments||0||wq``,
``opt||.mu||embed``, ``opt||.step``) — and bfloat16 leaves stored as
float32 (lossless), cast back to the template's dtype on load.  So a
checkpoint written by either package restores into the other.  Writes go
to a temporary file renamed into place; ``CheckpointManager`` keeps the
newest k and can hand writes to a background thread (drained by
``close``).
"""
from __future__ import annotations

import os
import queue
import re
import threading

import numpy as np
import torch

__all__ = ["save_pytree", "load_pytree", "CheckpointManager"]

_SEP = "||"


def _items(tree, path=()):
    """(path, leaf) pairs in JAX's flatten order; path parts are the
    strings JAX's key printer gives."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _items(getattr(tree, name), path + ("." + name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, path + (str(i),))
    else:
        yield path, tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)  # numpy has no bfloat16: lossless
        # a copy, never a view: the caller may update the leaf in place
        return t.to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    return {_SEP.join(path): _to_numpy(leaf) for path, leaf in _items(tree)}


def save_pytree(tree, path: str):
    """Write ``tree`` to ``path`` (npz) through a temporary file."""
    tmp = path + ".tmp"
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def _rebuild(template, flat, path=()):
    if isinstance(template, dict):
        return {k: _rebuild(template[k], flat, path + (str(k),))
                for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*[
            _rebuild(getattr(template, n), flat, path + ("." + n,))
            for n in template._fields])
    if isinstance(template, (list, tuple)):
        out = [_rebuild(v, flat, path + (str(i),))
               for i, v in enumerate(template)]
        return type(template)(out)
    arr = flat[_SEP.join(path)]
    if isinstance(template, torch.Tensor):
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"{_SEP.join(path)}: shape {arr.shape} != "
                             f"{tuple(template.shape)}")
        return torch.from_numpy(np.array(arr)).to(device=template.device,
                                                  dtype=template.dtype)
    if hasattr(template, "dtype"):
        return arr.astype(template.dtype)
    return arr


def load_pytree(template, path: str):
    """Restore into the structure of ``template``: each tensor leaf comes
    back with the template leaf's shape, dtype and device."""
    with np.load(path, allow_pickle=False) as data:
        flat = dict(data)
    return _rebuild(template, flat)


class CheckpointManager:
    def __init__(self, directory: str, retain: int = 3,
                 async_writes: bool = False):
        self.dir = directory
        self.retain = retain
        os.makedirs(directory, exist_ok=True)
        self._q: queue.Queue | None = None
        self._thread = None
        if async_writes:
            self._q = queue.Queue()
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            tree, path = item
            save_pytree(tree, path)
            self._gc()

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:010d}.npz")

    def save(self, step: int, tree):
        path = self._path(step)
        if self._q is not None:
            # the device-to-host copy happens here, so the step may go on
            # updating the tensors in place
            self._q.put((_flatten(tree), path))
        else:
            save_pytree(tree, path)
            self._gc()

    def steps(self):
        pat = re.compile(r"ckpt_(\d+)\.npz$")
        out = []
        for f in os.listdir(self.dir):
            m = pat.match(f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self):
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template, step: int | None = None):
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        return load_pytree(template, self._path(step)), step

    def _gc(self):
        for s in self.steps()[: -self.retain]:
            try:
                os.remove(self._path(s))
            except OSError:
                pass

    def close(self):
        if self._q is not None:
            self._q.put(None)
            self._thread.join()
