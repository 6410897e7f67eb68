"""Point models: Edwards (extended, projective, affine, compressed y),
Ristretto, Montgomery, and the reference's free scalar-multiplication
functions."""

from .edwards import (AffinePoint, CompressedEdwardsY, EdwardsPoint,
                      ProjectivePoint, binary_naf_mul, double_and_add,
                      ltr_bin_mul, mul_by_cofactor, mul_by_pow_2,
                      window_naf_mul)
from .montgomery import MontgomeryPoint
from .ristretto import CompressedRistretto, RistrettoPoint

__all__ = [
    "AffinePoint", "CompressedEdwardsY", "EdwardsPoint", "ProjectivePoint",
    "MontgomeryPoint", "CompressedRistretto", "RistrettoPoint",
    "binary_naf_mul", "double_and_add", "ltr_bin_mul", "mul_by_cofactor",
    "mul_by_pow_2", "window_naf_mul",
]
