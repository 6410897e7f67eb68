"""The least time of ``k_bucket_accum`` in one call: the dense route's
bucket accumulation (K7, one launch over all window groups) and the pod
route's (K9, one launch a group of windows, on each rank's block).

The algorithm is the JAX package's ``_accum_one``
(zerocaf_tpu/ops/pallas/msm_kernels.py:63-89), run by ``_bucketall_kernel``
(:366, for ``bucket_accum_all`` :392) and ``_bucketk_kernel`` (:312, for
``bucket_accum_k`` :339) for every point and every window of
signed c-bit digits: the point, negated for a negative digit, is added to
the bucket of the digit's magnitude by ONE unified extended addition,
``_padd_ext_block`` (zerocaf_tpu/ops/pallas/field_kernels.py:219-233):
A, B, T1 T2, that times d, Z1 Z2, (X1+Y1)(X2+Y2), then E F, G H, F G, E H
-- 10 field multiplies and no square.  A zero digit needs no addition
(the kernel leaves its table untouched), so the work counts the (point,
window) pairs whose signed digit is not zero, over nwin = ceil(251 / c)
windows, the digits recoded as the program's ``signed_digits`` and the
JAX package's dense digits do: d = w + carry, negative above 2^(c-1).

Bytes at the tensor boundary, each read or written once: the points (4
coordinates of 22 int32 limbs), one int32 digit a window, and one bucket
table of 2^(c-1) + 1 points a window.
"""

import numpy as np

from portbench.peaks import (HBM_BYTES_PER_S, POINT_BYTES, WORD_PRODUCTS_PER_S,
                             WORDS_PER_MUL)

MULS_PER_ADD = 10
COVER_BITS = 251
CHUNK = 1 << 16


def nonzero_digits(scalars: np.ndarray, c: int) -> int:
    """The signed c-bit digits of [n, 32] uint8 scalars that are not zero."""
    nwin = -(-COVER_BITS // c)
    weights = 1 << np.arange(c)
    total = 0
    for lo in range(0, len(scalars), CHUNK):
        bits = np.unpackbits(scalars[lo:lo + CHUNK], axis=1, bitorder="little")
        bits = np.pad(bits, ((0, 0), (0, max(0, nwin * c - bits.shape[1]))))
        win = bits[:, : nwin * c].reshape(len(bits), nwin, c) @ weights
        carry = np.zeros(len(win), np.int64)
        for w in range(nwin):
            d = win[:, w] + carry
            carry = (d > (1 << (c - 1))).astype(np.int64)
            total += int(np.count_nonzero((d != 0) & (d != 1 << c)))
    return total


def least_seconds(r):
    """(work bound, byte bound) in seconds for one call on this rank, or
    None where the cell runs no dense MSM."""
    if r.traffic.op != "msm" or r.window_bits is None:
        return None
    c = r.window_bits
    nwin = -(-COVER_BITS // c)
    rows = r.block
    digits = np.mean([nonzero_digits(r.traffic.batches[b].args[-1][rows], c)
                      for b in sorted(set(r.traced_batches))])
    work = digits * MULS_PER_ADD * WORDS_PER_MUL / WORD_PRODUCTS_PER_S
    n = rows.stop - rows.start
    moved = n * (POINT_BYTES + 4 * nwin) + nwin * ((1 << (c - 1)) + 1) * POINT_BYTES
    return work, moved / HBM_BYTES_PER_S
