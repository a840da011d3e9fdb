"""Port vs JAX package: the summaries pack cache and the layout facts.

Mirrors ``tests/test_batched_summaries.py``'s pack-cache tests and
``tests/test_secure_pipeline.py::test_pack_unpack_roundtrip`` on the
port: ``pack_cache_clear``, ``pack_cache_len``,
``PackedPartitions.total_records``, the ``dtype`` of ``pack_partitions``
and ``pack_cache_evict`` (a float32 pack is one float32 buffer under its
own cache key) and ``FlatLayout.num_elements`` / ``.padded``.  The same
numpy inputs go to both packages; packs and field outputs are
bit-identical.
"""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched_summaries as jbs
from repro.core.flatbuf import pack_pytree as j_pack_pytree
from repro_torch.core import (
    SecureCollective,
    batched_local_summaries,
    pack_cache_clear,
    pack_cache_evict,
    pack_cache_len,
    pack_partitions,
    pack_pytree,
    unpack_pytree,
)
from repro_torch.core import batched_summaries as bs_mod

SIZES = (3, 170, 512, 515)


def _np_parts(seed=7, sizes=SIZES, d=10):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(sum(sizes), d))
    X[:, 0] = 1.0
    y = (rng.random(sum(sizes)) < 0.4).astype(np.float64)
    out, off = [], 0
    for s in sizes:
        out.append((X[off:off + s], y[off:off + s]))
        off += s
    return out


def _parts(seed=7):
    return [(torch.as_tensor(X), torch.as_tensor(y))
            for X, y in _np_parts(seed)]


def test_pack_partitions_memoized_per_study():
    """Same part tensors -> same packed object; a float32 pack keys its
    own entry; new tensors -> a fresh pack of the same values."""
    parts = _parts()
    p1 = pack_partitions(parts)
    assert pack_partitions(parts) is p1
    p32 = pack_partitions(parts, dtype=torch.float32)
    assert p32 is not p1
    assert pack_partitions(parts, dtype=torch.float32) is p32
    fresh = [(Xj + 0.0, yj) for Xj, yj in parts]
    p3 = pack_partitions(fresh)
    assert p3 is not p1
    assert torch.equal(p3.X, p1.X)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_packs_equal_jax_bitwise(dtype):
    """Both payload dtypes pack to the JAX package's buffers bit for bit;
    a float32 pack is one buffer (``X32`` is ``X``)."""
    nparts = _np_parts(3)
    got = pack_partitions([(torch.as_tensor(X), torch.as_tensor(y))
                           for X, y in nparts], dtype=getattr(torch, dtype))
    want = jbs.pack_partitions([(jnp.asarray(X), jnp.asarray(y))
                                for X, y in nparts],
                               dtype=getattr(jnp, dtype))
    for a, b in ((got.X, want.X), (got.X32, want.X32), (got.y, want.y),
                 (got.counts, want.counts)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert str(a.dtype).split(".")[-1] == str(np.asarray(b).dtype)
    assert (got.X32 is got.X) == (dtype == "float32")
    assert got.total_records == want.total_records == sum(SIZES)


@pytest.mark.parametrize("backend", ["reference", "kernel", "mixed"])
def test_float32_pack_summaries_equal_the_float64_pack(backend):
    """A float32 payload widens exactly: on float32-representable data its
    summaries equal the float64 pack's bit for bit, and so does the
    secure round's reveal of them."""
    parts = [(X.float().double(), y) for X, y in _parts(5)]
    p64 = pack_partitions(parts)
    p32 = pack_partitions(parts, dtype=torch.float32)
    beta = 0.1 * torch.arange(10, dtype=torch.float64)
    a = batched_local_summaries(beta, p64, backend=backend)
    b = batched_local_summaries(beta, p32, backend=backend)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    agg = SecureCollective(backend="kernel")
    tree = {"g": a.gradient, "dev": a.deviance}
    r64 = agg.secure_round_batched(torch.Generator().manual_seed(1), tree)
    r32 = agg.secure_round_batched(torch.Generator().manual_seed(2),
                                   {"g": b.gradient, "dev": b.deviance})
    for k in tree:
        assert torch.equal(r64[k], r32[k])


def test_pack_cache_serves_alternating_studies():
    """The LRU holds several studies at once: alternating between two
    part sets hits both ways."""
    parts_a = _parts()
    parts_b = [(Xj + 0.0, yj + 0.0) for Xj, yj in parts_a]
    pa, pb = pack_partitions(parts_a), pack_partitions(parts_b)
    assert pack_partitions(parts_a) is pa
    assert pack_partitions(parts_b) is pb
    assert pack_partitions(parts_a) is pa


def test_pack_cache_bounded_lru():
    pack_cache_clear()
    assert pack_cache_len() == 0
    keep = []
    for k in range(bs_mod._PACK_CACHE_SIZE + 3):
        parts = [(torch.full((4, 3), float(k)), torch.ones(4))]
        keep.append(parts)  # hold tensors so entries die only by LRU
        pack_partitions(parts)
    assert pack_cache_len() == bs_mod._PACK_CACHE_SIZE
    newest = pack_partitions(keep[-1])
    assert pack_partitions(keep[-1]) is newest
    pack_cache_clear()
    assert pack_cache_len() == 0


def test_pack_cache_entry_dies_with_its_buffers():
    """Evict-on-collect: when a part tensor is garbage collected the entry
    goes too, so a recycled id can never alias a stale pack."""
    pack_cache_clear()
    parts = [(torch.ones((4, 3)), torch.ones(4))]
    pack_partitions(parts)
    assert pack_cache_len() == 1
    del parts
    gc.collect()
    assert pack_cache_len() == 0


def test_pack_cache_evict_on_churn():
    """``pack_cache_evict`` drops every entry holding a churned tensor;
    with a dtype, only that payload's entries."""
    pack_cache_clear()
    parts = _parts()
    p64 = pack_partitions(parts)
    p32 = pack_partitions(parts, dtype=torch.float32)
    assert pack_cache_len() == 2
    pack_cache_evict([parts[0]], dtype=torch.float32)
    assert pack_cache_len() == 1
    assert pack_partitions(parts) is p64
    assert pack_partitions(parts, dtype=torch.float32) is not p32
    pack_cache_evict([parts[0]])
    assert pack_cache_len() == 0
    assert pack_partitions(parts) is not p64  # repacked, not resurrected


def test_pack_partitions_validates():
    X = torch.ones((4, 3))
    with pytest.raises(ValueError, match="at least one"):
        pack_partitions([])
    with pytest.raises(ValueError, match="feature dimension"):
        pack_partitions([(X, torch.ones(4)), (torch.ones((2, 5)),
                                              torch.ones(2))])
    with pytest.raises(ValueError, match="dtype"):
        pack_partitions([(X, torch.ones(4))], dtype=torch.float16)
    packed = pack_partitions([(X, torch.ones(4)),
                              (2 * torch.ones((1, 3)), torch.zeros(1))])
    assert tuple(packed.X.shape) == (2, 4, 3)
    assert packed.total_records == 5
    assert packed.X32.dtype == torch.float32
    np.testing.assert_array_equal(packed.counts.numpy(), [4, 1])
    # padding rows are zero (masking makes them inert either way)
    assert (packed.X[1, 1:] == 0).all()


def test_pack_unpack_roundtrip():
    """``tests/test_secure_pipeline.py::test_pack_unpack_roundtrip`` on
    the port: the layout counts 12 elements, like the JAX package's."""
    np_tree = {"h": np.arange(9, dtype=np.float64).reshape(3, 3),
               "g": np.asarray([1.5, -2.25], dtype=np.float32),
               "dev": np.asarray(3.25, dtype=np.float64)}
    tree = {k: torch.as_tensor(v) for k, v in np_tree.items()}
    buf, layout = pack_pytree(tree)
    _, jlayout = j_pack_pytree({k: jnp.asarray(v)
                                for k, v in np_tree.items()})
    assert tuple(buf.shape) == (layout.rows, 128) and layout.rows % 8 == 0
    assert layout.num_elements == jlayout.num_elements == 12
    assert layout.padded == jlayout.padded == layout.rows * 128
    out = unpack_pytree(buf, layout)
    for k in tree:
        assert out[k].dtype == tree[k].dtype
        assert torch.equal(out[k], tree[k])
