"""Inputs of the block-form UPSAMPLE_UV tail (planar.upsample_fdct_blocks
and the upsample_fdct kernel), shared by the CPU test against the JAX
package (test_torch_fused.py) and the card test against the plain version
(test_torch_cuda.py).  numpy only: the card test imports no JAX."""

import numpy as np

# UPSAMPLE_UV tails of the block form: (hs, ws, hb_c, wb_c, hb_l, wb_l,
# img_h, img_w, n, shard), shard None or (row0, hb_l_total, col0,
# wb_l_total).  Odd grids; right tails over more than the first 8 * hs
# rows (the quirk) and bottom tails; a bottom tail of a whole block row,
# its source row in the block above (8 px high, 2 block rows); a 1x1
# grid; shards of a grid: the last row and column (the bottom tail), the
# first row and last column (the right tail), the first row of two (the
# right tail, the bottom one's source in the other shard) and a middle
# one (no tail).
UPSAMPLE_TAILS = [
    (2, 2, 3, 4, 5, 7, 37, 51, 1, None),
    (2, 1, 4, 3, 7, 3, 50, 21, 3, None),
    (1, 2, 3, 4, 3, 7, 20, 50, 1, None),
    (2, 2, 2, 3, 4, 6, 32, 48, 3, None),
    (2, 2, 1, 1, 1, 1, 5, 3, 2, None),
    (2, 2, 1, 2, 2, 4, 8, 30, 1, None),
    (2, 2, 2, 2, 4, 4, 90, 59, 2, (64, 12, 32, 8)),
    (2, 2, 3, 2, 6, 4, 90, 59, 1, (0, 12, 32, 8)),
    (2, 1, 3, 2, 6, 2, 85, 13, 1, (0, 12, 0, 2)),
    (1, 2, 2, 2, 2, 4, 37, 54, 1, (16, 6, 0, 7)),
]


def upsample_tail_inputs(hs, ws, hb_c, wb_c, hb_l, wb_l, n, seed):
    """Chroma and downsampled-luma halos int32[100, n*hb_c*wb_c] and luma
    pixels int32[64, n*hb_l*wb_l]: per chroma block a flat luma halo (s_aa
    == 0), one of two near levels (slopes clamped to +-16) or noise; the
    luma pixels 0 / 255 or noise, so outputs saturate at both ends."""
    rng = np.random.default_rng(seed)
    Bc, Bl = n * hb_c * wb_c, n * hb_l * wb_l
    kind = rng.integers(0, 3, Bc)
    image2 = np.where(kind == 0, rng.integers(0, 256, Bc),
                      np.where(kind == 1, 100 + rng.integers(0, 2, (100, Bc)),
                               rng.integers(0, 256, (100, Bc))))
    chroma = rng.integers(0, 256, (100, Bc))
    luma = np.where(rng.random(Bl) < 0.5, 255 * rng.integers(0, 2, (64, Bl)),
                    rng.integers(0, 256, (64, Bl)))
    return [np.ascontiguousarray(a, np.int32) for a in (chroma, image2,
                                                         luma)]
