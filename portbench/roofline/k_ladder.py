"""The least time of ``k_ladder`` in one ``dh`` call: the signed width-4
windowed multiply (K4), every lane's secret times its peer.

The algorithm is the JAX package's ``scalar_mul_windowed_signed``
(zerocaf_tpu/ops/pallas/field_kernels.py:825) at width 4 over the 63
windows of ceil(250 / 4):

* the table, ``_table_kernel`` (:654-678): entries 2..8 by 7 unified
  additions ``_padd_ext_block`` (:219-233, 10 multiplies each), and the
  Niels form of entries 1..8, one multiply by 2d each: 78 multiplies;
* each window, ``_step_kernel_signed`` (:777-800): 4 doublings
  ``_pdbl_block`` (:183-198: squares of X, Y, Z and X+Y, then E F, G H,
  F G, and E H on the last only) and one mixed addition ``_madd_block``
  (:201-216, 8 multiplies): 16 squares and 21 multiplies.

Every lane does all of it whatever its secret (the route is oblivious), so
a lane needs 78 + 63 x 21 = 1401 multiplies and 63 x 16 = 1008 squares.
Bytes at the tensor boundary, each once: the peer point in, 63 int32
digits in, the product point out.
"""

from portbench.peaks import (HBM_BYTES_PER_S, POINT_BYTES, WORD_PRODUCTS_PER_S,
                             WORDS_PER_MUL, WORDS_PER_SQUARE)

WIDTH = 4
NWIN = -(-250 // WIDTH)
TABLE_MULS = 7 * 10 + 8
MULS = TABLE_MULS + NWIN * (WIDTH * 3 + 1 + 8)
SQUARES = NWIN * WIDTH * 4


def least_seconds(r):
    if r.traffic.op != "dh":
        return None
    lanes = r.traffic.batch
    work = lanes * (MULS * WORDS_PER_MUL + SQUARES * WORDS_PER_SQUARE)
    moved = lanes * (2 * POINT_BYTES + 4 * NWIN)
    return work / WORD_PRODUCTS_PER_S, moved / HBM_BYTES_PER_S
