"""Curve constants in the limb representation (zerocaf_tpu/constants.py
counterpart).

Every value is derived at import time from the pure-Python oracle, exactly as
the JAX package derives its own; ``interop.check_constants`` holds the two
sets equal.  Arrays are host numpy int32 so that importing the package makes
no tensor on any device; the modules that use them move them to the device of
their operands.
"""

from __future__ import annotations

import numpy as np

from . import oracle
from .config import NUM_LIMBS, RADIX_BITS

P = oracle.P
R = oracle.R
DELTA_P = oracle.DELTA_P
DELTA_R = oracle.DELTA_R
FOLD_C_P = DELTA_P                  # 2^252 == -FOLD_C_P (mod p)
FOLD_C_R = 8 * DELTA_R              # 2^252 == -FOLD_C_R (mod r)

EDWARDS_A = oracle.EDWARDS_A
EDWARDS_D = oracle.EDWARDS_D
SQRT_M1 = oracle.SQRT_M1
C6 = oracle.C6                      # 6^((p-1)/4): the Tonelli-raw sqrt(-1)
INV_SQRT_A_MINUS_D = oracle.INV_SQRT_A_MINUS_D
SQRT_AD_MINUS_ONE = oracle.SQRT_AD_MINUS_ONE
ONE_MINUS_D_SQ = oracle.ONE_MINUS_D_SQ
D_MINUS_ONE_SQ = oracle.D_MINUS_ONE_SQ
POS_RANGE = oracle.POS_RANGE
INV_SQRT_A = oracle.INV_SQRT_A
# -sqrt(a): with a = -1, sqrt(a) = i and 1/sqrt(a) = -i, so MINUS_SQRT_A and
# INV_SQRT_A are the same element.
MINUS_SQRT_A = oracle.INV_SQRT_A
INVERSE_MOD_TWO = oracle.INVERSE_MOD_TWO              # 1/2 (mod p)
SCALAR_INVERSE_MOD_TWO = oracle.SCALAR_INVERSE_MOD_TWO  # 1/2 (mod r)
MINUS_ONE_HALF = oracle.MINUS_ONE_HALF
MONT_A = oracle.MONT_A              # Montgomery-form A = 505186
MONT_B = oracle.MONT_B

# Fixed exponents of the branch-free chains (ops/inv_sqrt.py).
EXP_INV = P - 2                     # Fermat inverse
EXP_LEGENDRE = (P - 1) // 2
EXP_SQRT = (P + 3) // 8             # p == 5 (mod 8) closed-form sqrt
EXP_SQRT_RATIO = (P - 5) // 8       # dalek sqrt_ratio exponent
CHAIN_EXPONENTS = (EXP_INV, EXP_LEGENDRE, EXP_SQRT, EXP_SQRT_RATIO)
EXP_SINV = R - 2                    # scalar inverse (mod r)


def _limbs(v: int, n: int = NUM_LIMBS) -> np.ndarray:
    return np.array(oracle.int_to_limbs(v % (1 << (RADIX_BITS * n)), n=n),
                    dtype=np.int32)


def fold_limbs(c: int) -> np.ndarray:
    """Fold constants are < 2^133: 12 limbs."""
    assert c < 1 << (12 * RADIX_BITS)
    return np.array(oracle.int_to_limbs(c, n=12), dtype=np.int32)


P_LIMBS = _limbs(P)
R_LIMBS = _limbs(R)
FOLD_C_P_LIMBS = fold_limbs(FOLD_C_P)
FOLD_C_R_LIMBS = fold_limbs(FOLD_C_R)
DELTA_R_LIMBS = fold_limbs(DELTA_R)


# The f32x29 backend: radix 2^9, 29 limbs (252 = 9 * 28 keeps the fold
# limb-aligned).  Held as int32 like the JAX package's; ops/limb.py casts
# them to float32 where it uses them.


def _limbs_f9(v: int, n: int = 29) -> np.ndarray:
    return np.array(oracle.int_to_limbs(v % (1 << (9 * n)), n=n, w=9),
                    dtype=np.int32)


def fold_limbs_f9(c: int) -> np.ndarray:
    """Fold constants are < 2^133: 15 limbs at radix 2^9."""
    assert c < 1 << (9 * 15)
    return np.array(oracle.int_to_limbs(c, n=15, w=9), dtype=np.int32)


P_LIMBS_F9 = _limbs_f9(P)
R_LIMBS_F9 = _limbs_f9(R)
FOLD_C_P_LIMBS_F9 = fold_limbs_f9(FOLD_C_P)
FOLD_C_R_LIMBS_F9 = fold_limbs_f9(FOLD_C_R)
DELTA_R_LIMBS_F9 = fold_limbs_f9(DELTA_R)

ZERO_LIMBS = _limbs(0)
ONE_LIMBS = _limbs(1)
EDWARDS_D_LIMBS = _limbs(EDWARDS_D)
EDWARDS_2D_LIMBS = _limbs(2 * EDWARDS_D % P)   # Niels-form table scale
EDWARDS_A_LIMBS = _limbs(EDWARDS_A)
SQRT_M1_LIMBS = _limbs(SQRT_M1)
INV_SQRT_A_LIMBS = _limbs(INV_SQRT_A)
MINUS_SQRT_A_LIMBS = _limbs(MINUS_SQRT_A)
C6_LIMBS = _limbs(C6)
INV_SQRT_A_MINUS_D_LIMBS = _limbs(INV_SQRT_A_MINUS_D)
SQRT_AD_MINUS_ONE_LIMBS = _limbs(SQRT_AD_MINUS_ONE)
ONE_MINUS_D_SQ_LIMBS = _limbs(ONE_MINUS_D_SQ)
D_MINUS_ONE_SQ_LIMBS = _limbs(D_MINUS_ONE_SQ)
POS_RANGE_LIMBS = _limbs(POS_RANGE)


# The 8 x 32-bit Montgomery core of k_bucket_accum (csrc/field32.cuh):
# R = 2^256, a value v held as v R mod p in 8 little-endian uint32 words.
FIELD32_R = 1 << 256


def point_limbs(p) -> np.ndarray:
    """An oracle extended point (4 ints) as stacked [4, 22] limbs."""
    return np.stack([_limbs(c) for c in p])


BASEPOINT = point_limbs(oracle.BASEPOINT)
IDENTITY = point_limbs(oracle.IDENTITY)
FOUR_COSET_GROUP = np.stack([point_limbs(p) for p in oracle.FOUR_COSET_GROUP])

# TABLE[i] = i * BASEPOINT for i < 126: window_naf_mul's fixed-base table.
_table_pts = [oracle.IDENTITY]
for _ in range(125):
    _table_pts.append(oracle.point_add(_table_pts[-1], oracle.BASEPOINT))
BASEPOINT_MULTIPLES_TABLE = np.stack([point_limbs(p) for p in _table_pts])  # [126, 4, 22]
del _table_pts

# Compressed basepoint encodings (uint8 [32]).
BASEPOINT_COMPRESSED = np.frombuffer(
    oracle.edwards_compress(oracle.BASEPOINT), dtype=np.uint8).copy()
RISTRETTO_BASEPOINT_COMPRESSED = np.frombuffer(
    oracle.ristretto_compress(oracle.BASEPOINT), dtype=np.uint8).copy()

# Array constants that interop.check_constants compares with the JAX
# package's same-named arrays.
LIMB_CONSTANT_NAMES = (
    "P_LIMBS", "R_LIMBS", "FOLD_C_P_LIMBS", "FOLD_C_R_LIMBS", "DELTA_R_LIMBS",
    "P_LIMBS_F9", "R_LIMBS_F9", "FOLD_C_P_LIMBS_F9", "FOLD_C_R_LIMBS_F9",
    "DELTA_R_LIMBS_F9", "ZERO_LIMBS", "ONE_LIMBS",
    "EDWARDS_D_LIMBS", "EDWARDS_2D_LIMBS", "EDWARDS_A_LIMBS",
    "SQRT_M1_LIMBS", "INV_SQRT_A_LIMBS", "MINUS_SQRT_A_LIMBS", "C6_LIMBS", "INV_SQRT_A_MINUS_D_LIMBS",
    "SQRT_AD_MINUS_ONE_LIMBS", "ONE_MINUS_D_SQ_LIMBS", "D_MINUS_ONE_SQ_LIMBS",
    "POS_RANGE_LIMBS", "BASEPOINT", "IDENTITY", "FOUR_COSET_GROUP", "BASEPOINT_MULTIPLES_TABLE",
    "BASEPOINT_COMPRESSED", "RISTRETTO_BASEPOINT_COMPRESSED",
)
INT_CONSTANT_NAMES = ("P", "R", "EDWARDS_A", "EDWARDS_D", "MINUS_SQRT_A", "SQRT_M1", "C6", "INV_SQRT_A",
                      "INVERSE_MOD_TWO", "SCALAR_INVERSE_MOD_TWO",
                      "MINUS_ONE_HALF", "MONT_A", "MONT_B", "EXP_INV",
                      "EXP_LEGENDRE", "EXP_SQRT", "EXP_SQRT_RATIO", "EXP_SINV")
