"""The least time of ``k_comb`` in one ``keygen`` call: the signed
width-14 fixed-base comb (K6), every lane's secret key times the basepoint.

The algorithm is the JAX package's ``fixed_base_mul_stepped``
(zerocaf_tpu/ops/pallas/field_kernels.py:437) with ``signed=True`` at
``models.edwards.COMB_WIDTH_SIGNED`` = 14, over the 18 windows of
ceil(250 / 14), from the identity:

* the signed recoding, ``_signed_recode`` (:804-821): an add, a compare
  and a select a window, no field operation;
* each window, one mixed addition of the gathered affine Niels entry,
  ``_madd_packed_core`` (:378-407; two a step in
  ``_madd2_affine_packed_kernel`` :422): PP, MM and TT, then E F, G H, F G
  and E H -- 7 multiplies and no square.  A negative digit swaps y+x and
  y-x and negates 2dxy (:395-397): selects and a negation, no multiply.
  With 18 windows (even) the packed2 route adds no padding window
  (:523-531).

So a lane needs 18 x 7 = 126 multiplies.  Bytes at the tensor boundary,
each once: 18 int32 digits in, the product point out, and the comb table
once a call in the form the kernel is handed (the core's: 3 coordinates
of 8 words, 96 bytes an entry, 2^13 + 1 entries a window).
"""

from portbench.peaks import (HBM_BYTES_PER_S, POINT_BYTES, WORD_PRODUCTS_PER_S,
                             WORDS_PER_MUL)

WIDTH = 14
NWIN = -(-250 // WIDTH)
MULS = NWIN * 7
ENTRY_BYTES = 3 * 8 * 4
TABLE_BYTES = NWIN * ((1 << (WIDTH - 1)) + 1) * ENTRY_BYTES


def least_seconds(r):
    if r.traffic.op != "keygen":
        return None
    lanes = r.traffic.batch
    work = lanes * MULS * WORDS_PER_MUL
    moved = lanes * (4 * NWIN + POINT_BYTES) + TABLE_BYTES
    return work / WORD_PRODUCTS_PER_S, moved / HBM_BYTES_PER_S
