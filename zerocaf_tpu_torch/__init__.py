"""zerocaf_tpu_torch: the PyTorch / CUDA port of zerocaf_tpu for one NVIDIA
H100.

Batched arithmetic on the Sonny curve and its Ristretto group with the JAX
package's tensor boundary (int32 [..., 22] limbs, radix 2^12).  The hot
paths -- field multiply (K1), power chains (K2), the oblivious ladder (K3,
and K10, its own entry into the same kernel), the signed windowed multiply
(K4), batched point addition (K5), the fixed-base comb of key generation
(K6), and MSM's bucket accumulation (K7, and K9, K11, K12, its entries
for one window group) and window combine (K8) -- are hand-written CUDA
kernels for sm_90a, built from ``csrc/`` at first use; on CPU tensors the
same algebra runs in plain PyTorch.  ``parallel`` holds the mesh of
``torch.distributed`` ranks, its collectives, the sharded MSM and
checkpointing.  The library surface is the JAX package's: field and scalar
facades, Edwards (extended, projective, affine, compressed), Ristretto and
Montgomery points, the NAF and wNAF multiplies (recoded on the host by
``recode``), and ``traits``.  Constructors given no device place their
tensors on ``config.default_device()``, the first CUDA card unless set
otherwise.  This package never imports jax.
"""

from .field import FieldElement
from .scalar import Ristretto255Scalar, Scalar
from .models import (AffinePoint, CompressedEdwardsY, CompressedRistretto,
                     EdwardsPoint, MontgomeryPoint, ProjectivePoint,
                     RistrettoPoint, binary_naf_mul, double_and_add,
                     ltr_bin_mul, mul_by_cofactor, mul_by_pow_2,
                     window_naf_mul)
from . import constants
from . import oracle
from . import parallel
from . import traits
from .parallel import msm, msm_sharded
from .serving import Engine, pad_msm

__all__ = [
    "FieldElement", "Scalar", "Ristretto255Scalar",
    "AffinePoint", "CompressedEdwardsY", "CompressedRistretto", "EdwardsPoint",
    "MontgomeryPoint", "ProjectivePoint", "RistrettoPoint",
    "binary_naf_mul", "double_and_add", "ltr_bin_mul", "mul_by_cofactor",
    "mul_by_pow_2", "window_naf_mul",
    "constants", "oracle", "traits",
    "Engine", "msm", "msm_sharded", "pad_msm", "parallel",
]
