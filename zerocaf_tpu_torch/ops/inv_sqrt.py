"""Branch-free inversion, Legendre and square-root chains for the field
(zerocaf_tpu/ops/inv_sqrt.py counterpart).

Each is a fixed-exponent power (``limb.pow_const``, the K2 kernel on CUDA):
  * inverse:  Fermat a^(p-2);
  * legendre: a^((p-1)/2);
  * mod_sqrt: p == 5 (mod 8), so Tonelli-Shanks collapses to
    beta = a^((p+3)/8), raw = beta or beta * 6^((p-1)/4) -- bit-identical to
    the reference's raw Tonelli output (docs/DESIGN.md section 4);
  * sqrt_ratio_i: one a^((p-5)/8) with the 4-case contract.
All take and return semi-reduced [..., nlimbs] limbs of ``spec``'s backend
(i32x22 or f32x29); the f32x29 chains are plain PyTorch on every device.
"""

from __future__ import annotations

import torch

from .. import constants as C
from . import limb
from .limb import FIELD, ModSpec


def inverse(a: torch.Tensor, spec: ModSpec = FIELD) -> torch.Tensor:
    """a^-1 by Fermat; 0 for a == 0."""
    return limb.pow_const(a, spec.m - 2, spec)


def legendre_is_qr(a: torch.Tensor, spec: ModSpec = FIELD) -> torch.Tensor:
    """True where a is a nonzero quadratic residue."""
    sym = limb.pow_const(a, (spec.m - 1) // 2, spec)
    return limb.eq(sym, limb.one_like(sym), spec)


def is_positive(a: torch.Tensor, spec: ModSpec = FIELD) -> torch.Tensor:
    """Decaf non-negativity: canonical value <= (p-1)/2, branch-free
    (canonical plus a lexicographic compare, one launch on CUDA; no branch
    on the value)."""
    return ~limb.canonical_geq(a, limb.spec_limbs(C.POS_RANGE + 1, spec), spec)


def abs_positive(a: torch.Tensor, spec: ModSpec = FIELD) -> torch.Tensor:
    """The Decaf-positive representative of +-a."""
    return limb.select(is_positive(a, spec), a, limb.neg(a))


def conditional_negate(a: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    return limb.select(cond, limb.neg(a), a)


def sqrt_raw(a: torch.Tensor, spec: ModSpec = FIELD):
    """(exists, raw_root): raw_root is the reference's raw Tonelli output;
    garbage where exists is False; a == 0 gives (True, 0)."""
    beta = limb.pow_const(a, C.EXP_SQRT, spec)
    t_is_one = limb.eq(limb.square(beta, spec), a, spec)
    c6 = limb.const_int(C.C6, spec, a.device)
    raw = limb.select(t_is_one, beta, limb.mul(beta, c6, spec))
    exists = limb.eq(limb.square(raw, spec), a, spec)
    return exists, raw


def mod_sqrt(a: torch.Tensor, sign: torch.Tensor, spec: ModSpec = FIELD):
    """Reference mod_sqrt semantics: sign 0 -> raw root, 1 -> p - raw.
    Returns (exists, root)."""
    exists, raw = sqrt_raw(a, spec)
    root = limb.select(sign.to(torch.bool), limb.neg(raw), raw)
    return exists, limb.select(limb.is_zero(a, spec), torch.zeros_like(root), root)


def sqrt_ratio_i(u: torch.Tensor, v: torch.Tensor, spec: ModSpec = FIELD):
    """The 4-case contract:
      (True,  +sqrt(u/v))   if v != 0 and u/v square
      (True,  0)            if u == 0
      (False, 0)            if v == 0 and u != 0
      (False, +sqrt(i*u/v)) if u/v nonsquare
    via r = (u v^3) (u v^7)^((p-5)/8) and one multiplicative fixup."""
    u, v = torch.broadcast_tensors(u, v)
    v3 = limb.mul(limb.square(v, spec), v, spec)
    v7 = limb.mul(limb.square(v3, spec), v, spec)
    r = limb.mul(limb.mul(u, v3, spec),
                 limb.pow_const(limb.mul(u, v7, spec), C.EXP_SQRT_RATIO, spec),
                 spec)
    check = limb.mul(v, limb.square(r, spec), spec)

    neg_u = limb.neg(u)
    sqrt_m1 = limb.const_int(C.SQRT_M1, spec, u.device)
    correct = limb.eq(check, u, spec)
    flipped = limb.eq(check, neg_u, spec)
    flipped_i = limb.eq(check, limb.mul(neg_u, sqrt_m1, spec), spec)

    r = limb.select(flipped | flipped_i, limb.mul(r, sqrt_m1, spec), r)
    r = abs_positive(r, spec)
    return correct | flipped, r


def inv_sqrt(a: torch.Tensor, spec: ModSpec = FIELD):
    """sqrt(1/a): sqrt_ratio_i(1, a)."""
    return sqrt_ratio_i(limb.one_like(a), a, spec)
