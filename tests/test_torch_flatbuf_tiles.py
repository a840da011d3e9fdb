"""Port vs JAX package: the flat buffer's tile table and tile unpacking.

``tile_slices`` / ``unpack_pytree_tile`` carry the sharded ``secure_psum``
wire (``reveal="sharded"``: the rows axis reduce-scatters into per-rank
tiles).  Each test of ``tests/test_flatbuf_tiles.py`` runs here on the
port, on the same trees, and the fragment table must equal the JAX
package's field by field for the same layout.  Also the layout facts
``FlatLayout.num_elements`` / ``.padded``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flatbuf as jflat
from repro_torch.core.flatbuf import (LANES, ROW_ALIGN, pack_pytree,
                                      tile_slices, unpack_pytree,
                                      unpack_pytree_tile)


def _tree(d: int):
    return {
        "gradient": torch.arange(d, dtype=torch.float64) - d / 2,
        "hessian": torch.arange(d * d, dtype=torch.float64).reshape(d, d)
        * 0.5,
        "deviance": torch.tensor(3.25, dtype=torch.float64).reshape(()),
    }


def _jax_tree(tree):
    return {k: jnp.asarray(v.numpy()) for k, v in tree.items()}


def _reassemble(buf, layout, num_tiles):
    """Stitch every tile's fragments back into full raveled leaves."""
    rows = layout.rows // num_tiles
    parts = {i: {} for i in range(len(layout.shapes))}
    for t in range(num_tiles):
        tile = buf[t * rows:(t + 1) * rows]
        for leaf, (start, stop, frag) in unpack_pytree_tile(
            tile, layout, t, num_tiles
        ).items():
            parts[leaf][start] = (stop, frag)
    leaves = []
    for i, shape in enumerate(layout.shapes):
        n = math.prod(shape)
        flat = np.zeros(n)
        covered = 0
        for start in sorted(parts[i]):
            stop, frag = parts[i][start]
            flat[start:stop] = frag.numpy()
            covered += stop - start
        assert covered == n, f"leaf {i} fragments do not tile the leaf"
        leaves.append(flat.reshape(shape))
    return leaves


def _fields(table):
    return [[(f.leaf, f.leaf_start, f.leaf_stop, f.tile_offset)
             for f in frags] for frags in table]


# (d, num_tiles, row_align): the shapes of the JAX tests below, and the
# wire's lcm(8, D) alignments for D = 3, 4 and 6
@pytest.mark.parametrize("d,num_tiles,row_align", [
    (5, 3, 24), (7, 4, 8), (9, 6, 24), (40, 2, 16), (4, 1, 8), (4, 8, 8),
    (300, 3, 24), (128, 4, 8)])
def test_fragment_table_equals_jax(d, num_tiles, row_align):
    tree = _tree(d)
    buf, layout = pack_pytree(tree, row_align=row_align)
    jbuf, jlayout = jflat.pack_pytree(_jax_tree(tree), row_align=row_align)
    assert layout.rows == jlayout.rows
    assert (layout.num_elements, layout.padded) == (jlayout.num_elements,
                                                    jlayout.padded)
    assert _fields(tile_slices(layout, num_tiles)) == \
        _fields(jflat.tile_slices(jlayout, num_tiles))
    rows = layout.rows // num_tiles
    for t in range(num_tiles):
        got = unpack_pytree_tile(buf[t * rows:(t + 1) * rows], layout, t,
                                 num_tiles)
        want = jflat.unpack_pytree_tile(jbuf[t * rows:(t + 1) * rows],
                                        jlayout, t, num_tiles)
        assert sorted(got) == sorted(want)
        for leaf, (a, b, frag) in got.items():
            assert (a, b) == want[leaf][:2]
            np.testing.assert_array_equal(frag.numpy(),
                                          np.asarray(want[leaf][2]))


def test_layout_counts_elements_and_padding():
    _, layout = pack_pytree(_tree(3))  # 3 + 9 + 1 elements
    assert layout.num_elements == 13
    assert layout.padded == layout.rows * LANES == 8 * 128


def test_rows_not_divisible_raises():
    # d=4: gradient 4 + hessian 16 + scalar = 21 elements -> 8 rows
    _, layout = pack_pytree(_tree(4))
    assert layout.rows == ROW_ALIGN
    with pytest.raises(ValueError, match="does not split"):
        tile_slices(layout, 3)


def test_lcm_row_align_makes_awkward_counts_divisible():
    """d=5 over 3 ranks: 31 elements never align at row_align=8, but the
    lcm(8, 3) alignment the sharded wire uses always does."""
    num_tiles = 3
    buf, layout = pack_pytree(_tree(5),
                              row_align=math.lcm(ROW_ALIGN, num_tiles))
    assert layout.rows % num_tiles == 0
    leaves = _reassemble(buf, layout, num_tiles)
    np.testing.assert_array_equal(leaves[1], np.arange(5) - 2.5)


def test_fragment_table_covers_leaves():
    num_tiles = 4
    _, layout = pack_pytree(_tree(7),
                            row_align=math.lcm(ROW_ALIGN, num_tiles))
    table = tile_slices(layout, num_tiles)
    assert len(table) == num_tiles
    for frags in table:
        for f in frags:
            assert all(isinstance(v, int)
                       for v in (f.leaf, f.leaf_start, f.leaf_stop,
                                 f.tile_offset))
    # per-leaf coverage: fragment extents partition [0, n) exactly
    for i, shape in enumerate(layout.shapes):
        n = math.prod(shape)
        spans = sorted((f.leaf_start, f.leaf_stop)
                       for frags in table for f in frags if f.leaf == i)
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def test_single_row_leaves_and_empty_tail_tiles():
    """Tiny leaves land whole in tile 0; trailing tiles that are pure
    zero-pad carry NO fragments (the pad belongs to nobody)."""
    tree = {"a": torch.tensor([1.0, 2.0]), "b": torch.tensor(7.0).reshape(())}
    num_tiles = 8
    buf, layout = pack_pytree(tree, row_align=num_tiles)
    table = tile_slices(layout, num_tiles)
    step = layout.rows // num_tiles
    first = unpack_pytree_tile(buf[:step], layout, 0, num_tiles)
    assert set(first) == {0, 1}
    np.testing.assert_array_equal(first[0][2].numpy(), [1.0, 2.0])
    assert first[1][:2] == (0, 1)
    assert float(first[1][2][0]) == 7.0
    for t in range(1, num_tiles):
        assert table[t] == ()
        assert unpack_pytree_tile(buf[t * step:(t + 1) * step], layout, t,
                                  num_tiles) == {}


def test_tile_reassembly_matches_unpack_pytree():
    num_tiles = 6
    buf, layout = pack_pytree(_tree(9),
                              row_align=math.lcm(ROW_ALIGN, num_tiles))
    whole = unpack_pytree(buf, layout)
    leaves = _reassemble(buf, layout, num_tiles)
    np.testing.assert_array_equal(leaves[1], whole["gradient"].numpy())
    np.testing.assert_array_equal(leaves[2], whole["hessian"].numpy())
    np.testing.assert_array_equal(leaves[0].reshape(()),
                                  whole["deviance"].numpy())


def test_leaf_straddles_tile_boundary():
    """A leaf bigger than one tile splits into per-tile fragments whose
    tile_offsets are where the fragment starts inside each tile."""
    num_tiles = 2
    d = 40  # hessian d*d = 1600 elements > one (8, 128) = 1024-elem tile
    buf, layout = pack_pytree(_tree(d), row_align=ROW_ALIGN * num_tiles)
    table = tile_slices(layout, num_tiles)
    hess_frags = [f for frags in table for f in frags if f.leaf == 2]
    assert len(hess_frags) == 2
    leaves = _reassemble(buf, layout, num_tiles)
    np.testing.assert_array_equal(leaves[2],
                                  np.arange(d * d).reshape(d, d) * 0.5)


def test_dtype_override_and_restore():
    """Fragments restore each leaf's own dtype unless one is given."""
    tree = {"a": torch.arange(5, dtype=torch.float32),
            "b": torch.arange(3, dtype=torch.float64)}
    buf, layout = pack_pytree(tree)
    frags = unpack_pytree_tile(buf, layout, 0, 1)
    assert frags[0][2].dtype == torch.float32
    assert frags[1][2].dtype == torch.float64
    assert all(f[2].dtype == torch.float16 for f in unpack_pytree_tile(
        buf, layout, 0, 1, dtype=torch.float16).values())
