"""Pure-Python arbitrary-precision oracle for the Sonny curve: the port's
judge and the source of its constants.

A direct, slow, obviously-correct implementation with Python ints of what
the port computes: field arithmetic mod p, Edwards points in extended
coordinates with the unified a = -1 HWCD addition, their compressed-y
encoding and the Montgomery u map, the Ristretto encode, decode, Elligator
map and order check, MSM, and the radix-2^12 limb codecs.  It imports
nothing, so the port derives every constant from it without any other
package.  ``tests/test_torch_constants.py`` holds it equal to the JAX
package's oracle.

The Tonelli-Shanks square root uses z = 6 as the non-residue.  Since
p == 5 (mod 8) the loop collapses to a closed form:

    beta = a^((p+3)/8);  raw = beta if beta^2 == a else beta * 6^((p-1)/4)

``mod_sqrt_ts`` returns that raw root, sign quirks included.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Primes
# ---------------------------------------------------------------------------

P = 2**252 + 27742317777372353535851937790883648493
R = 2**249 + 14490550575682688738086195780655237219  # subgroup order ("L")

DELTA_P = P - 2**252  # p = 2^252 + DELTA_P
DELTA_R = R - 2**249  # r = 2^249 + DELTA_R

Q_TS = (P - 1) // 4   # p - 1 = Q_TS * 2^2 with Q_TS odd (p == 5 mod 8)

# ---------------------------------------------------------------------------
# Field arithmetic mod p
# ---------------------------------------------------------------------------


def fadd(a: int, b: int) -> int:
    return (a + b) % P


def fsub(a: int, b: int) -> int:
    return (a - b) % P


def fmul(a: int, b: int) -> int:
    return (a * b) % P


def fsquare(a: int) -> int:
    return (a * a) % P


def fneg(a: int) -> int:
    return (-a) % P


def finv(a: int) -> int:
    """a^-1 (mod p) by Fermat."""
    if a % P == 0:
        raise ZeroDivisionError("cannot invert 0")
    return pow(a, P - 2, P)


def fdiv(a: int, b: int) -> int:
    return fmul(a, finv(b))


def fpow(a: int, e: int) -> int:
    return pow(a, e, P)


def fhalf(a: int) -> int:
    """a/2 (mod p)  (field.rs:317-323)."""
    return fmul(a, INVERSE_MOD_TWO)


def legendre_symbol(a: int) -> int:
    """1 if a is a non-zero square, -1 if not a square, 0 if a == 0."""
    if a % P == 0:
        return 0
    return 1 if pow(a, (P - 1) // 2, P) == 1 else -1


def is_positive(a: int) -> bool:
    """Decaf non-negativity: least residue in [0, (p-1)/2]."""
    return (a % P) <= (P - 1) // 2


def fabs(a: int) -> int:
    """The Decaf-positive representative of +-a."""
    a %= P
    return a if is_positive(a) else P - a


C6 = pow(6, Q_TS, P)                          # a square root of -1
SQRT_M1 = C6 if is_positive(C6) else P - C6   # the positive one


def mod_sqrt_ts(a: int) -> int | None:
    """The raw Tonelli-Shanks root (closed p == 5 (mod 8) form), or None
    for a non-residue."""
    a %= P
    if a == 0:
        return 0
    beta = pow(a, (P + 3) // 8, P)
    if (beta * beta) % P == a:
        return beta
    raw = (beta * C6) % P
    if (raw * raw) % P == a:
        return raw
    return None


def mod_sqrt(a: int, sign: int) -> int | None:
    """sign 0: the raw root; sign 1: p - raw."""
    raw = mod_sqrt_ts(a)
    if raw is None:
        return None
    return (P - raw) % P if sign else raw


def sqrt_positive(a: int) -> int | None:
    """The Decaf-positive square root, if it exists."""
    raw = mod_sqrt_ts(a)
    return None if raw is None else fabs(raw)


def sqrt_ratio_i(u: int, v: int) -> tuple[bool, int]:
    """Merged sqrt(u/v) with the four-case contract:

      (True,  +sqrt(u/v))    if v != 0 and u/v square
      (True,  0)             if u == 0
      (False, 0)             if v == 0, u != 0
      (False, +sqrt(i*u/v))  if u/v nonsquare
    """
    u %= P
    v %= P
    if u == 0:
        return True, 0
    if v == 0:
        return False, 0
    ratio = fdiv(u, v)
    if legendre_symbol(ratio) == 1:
        return True, sqrt_positive(ratio)
    return False, sqrt_positive(fmul(SQRT_M1, ratio))


def inv_sqrt(a: int) -> tuple[bool, int]:
    return sqrt_ratio_i(1, a)


# ---------------------------------------------------------------------------
# Derived constants
# ---------------------------------------------------------------------------

POS_RANGE = (P - 1) // 2                      # Decaf range bound

EDWARDS_A = P - 1
EDWARDS_D = fmul(fneg(126296), finv(126297))

INV_SQRT_A_MINUS_D = sqrt_positive(finv(fsub(EDWARDS_A, EDWARDS_D)))
SQRT_AD_MINUS_ONE = sqrt_positive(fsub(fmul(EDWARDS_A, EDWARDS_D), 1))
ONE_MINUS_D_SQ = fsub(1, fsquare(EDWARDS_D))
D_MINUS_ONE_SQ = fsquare(fsub(EDWARDS_D, 1))
INV_SQRT_A = P - SQRT_M1

INVERSE_MOD_TWO = pow(2, P - 2, P)        # 1/2 (mod p)
MINUS_ONE_HALF = (P - 1) // 2             # (-1/2) (mod p)
SCALAR_INVERSE_MOD_TWO = pow(2, R - 2, R)  # 1/2 (mod r)

MONT_A = fmul(2, fdiv(fadd(EDWARDS_A, EDWARDS_D), fsub(EDWARDS_A, EDWARDS_D)))
MONT_B = fdiv(4, fsub(EDWARDS_A, EDWARDS_D))

# ---------------------------------------------------------------------------
# Scalar arithmetic mod r
# ---------------------------------------------------------------------------


def sadd(a: int, b: int) -> int:
    return (a + b) % R


def ssub(a: int, b: int) -> int:
    return (a - b) % R


def smul(a: int, b: int) -> int:
    return (a * b) % R


def ssquare(a: int) -> int:
    return (a * a) % R


def sneg(a: int) -> int:
    return (-a) % R


def spow(a: int, e: int) -> int:
    return pow(a, e, R)


def shalf(a: int) -> int:
    return smul(a, SCALAR_INVERSE_MOD_TWO)


def sinv(a: int) -> int:
    """Scalar inverse (not in the reference API surface; r is prime so Fermat
    applies).  Provided because MSM-style protocols need it."""
    if a % R == 0:
        raise ZeroDivisionError("cannot invert 0")
    return pow(a, R - 2, R)


# ---------------------------------------------------------------------------
# Byte codecs: canonical 32-byte little-endian
# ---------------------------------------------------------------------------


def fe_to_bytes(a: int) -> bytes:
    return int(a % P).to_bytes(32, "little")


def fe_from_bytes(b: bytes) -> int:
    """The 256-bit little-endian value, reduced mod p."""
    if len(b) != 32:
        raise ValueError(f"expected 32 bytes, got {len(b)}")
    return int.from_bytes(b, "little") % P


def fe_from_bytes_raw(b: bytes) -> int:
    """The raw 256-bit load, pre-reduction (for canonicality checks)."""
    return int.from_bytes(b, "little")


def scalar_to_bytes(a: int) -> bytes:
    return int(a % R).to_bytes(32, "little")


def scalar_from_bytes(b: bytes) -> int:
    """Canonical load; reference *asserts* s < r (scalar.rs:445-467)."""
    v = int.from_bytes(b, "little")
    if v >= R:
        raise ValueError("non-canonical scalar encoding")
    return v


def scalar_from_bytes_wide(b: bytes) -> int:
    """512-bit reduction mod r.  Reference leaves this unimplemented
    (scalar.rs:470-474); we provide it."""
    assert len(b) == 64
    return int.from_bytes(b, "little") % R


def scalar_bits(k: int, n: int = 256) -> list[int]:
    """LSB-first bit vector (scalar.rs:352-366)."""
    return [(k >> i) & 1 for i in range(n)]


def compute_naf(k: int, n: int = 256) -> list[int]:
    """Non-adjacent form, LSB-first (scalar.rs:370-389).

    NAF(k) needs up to bitlen(k)+1 digits (the recoding can carry one bit
    past the MSB), so k must satisfy k < 2^(n-1); larger inputs raise
    instead of silently truncating (VERDICT r2 item 7)."""
    if not 0 <= k < (1 << (n - 1)):
        raise ValueError(f"compute_naf: k needs {k.bit_length() + 1} digits > n={n}")
    res = [0] * n
    i = 0
    while k >= 1:
        if k & 1:
            ki = 2 - (k % 4)
            res[i] = ki
            k -= ki
        k >>= 1
        i += 1
    return res


def compute_window_naf(k: int, width: int, n: int = 256) -> list[int]:
    """Windowed NAF, LSB-first (scalar.rs:391-415).  As with compute_naf,
    the recoding may spill one digit past the MSB: require k < 2^(n-1)."""
    if not 0 <= k < (1 << (n - 1)):
        raise ValueError(f"compute_window_naf: k needs {k.bit_length() + 1} digits > n={n}")
    res = [0] * n
    i = 0
    while k >= 1:
        if k & 1:
            ki = k % (1 << width)
            if ki >= 1 << (width - 1):
                ki -= 1 << width
            res[i] = ki
            k -= ki
        k >>= 1
        i += 1
    return res


# ---------------------------------------------------------------------------
# Edwards points: extended (X, Y, Z, T), x = X/Z, y = Y/Z, xy = T/Z
# ---------------------------------------------------------------------------

ExtPoint = tuple[int, int, int, int]

IDENTITY: ExtPoint = (0, 1, 1, 0)


def point_add(p: ExtPoint, q: ExtPoint) -> ExtPoint:
    """Unified HWCD a = -1 addition; complete on this curve."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = fmul(X1, X2)
    B = fmul(Y1, Y2)
    C = fmul(EDWARDS_D, fmul(T1, T2))
    D = fmul(Z1, Z2)
    E = fsub(fsub(fmul(fadd(X1, Y1), fadd(X2, Y2)), A), B)
    F = fsub(D, C)
    G = fadd(D, C)
    H = fadd(B, A)
    return (fmul(E, F), fmul(G, H), fmul(F, G), fmul(E, H))


def point_neg(p: ExtPoint) -> ExtPoint:
    X, Y, Z, T = p
    return (fneg(X), Y, Z, fneg(T))


def point_sub(p: ExtPoint, q: ExtPoint) -> ExtPoint:
    return point_add(p, point_neg(q))


def point_double(p: ExtPoint) -> ExtPoint:
    """dbl-2008-hwcd doubling (4M+4S)."""
    X, Y, Z, _ = p
    A = fsquare(X)
    B = fsquare(Y)
    C = fmul(2, fsquare(Z))
    D = fneg(A)  # a = -1
    E = fsub(fsub(fsquare(fadd(X, Y)), A), B)
    G = fadd(D, B)
    F = fsub(G, C)
    H = fsub(D, B)
    return (fmul(E, F), fmul(G, H), fmul(F, G), fmul(E, H))


def point_eq(p: ExtPoint, q: ExtPoint) -> bool:
    """Projective equality X1/Z1 == X2/Z2 and Y1/Z1 == Y2/Z2."""
    X1, Y1, Z1, _ = p
    X2, Y2, Z2, _ = q
    return fmul(X1, Z2) == fmul(X2, Z1) and fmul(Y1, Z2) == fmul(Y2, Z1)


def scalar_mul(p: ExtPoint, k: int) -> ExtPoint:
    """LSB-first double-and-add by the raw integer k >= 0 (not reduced
    mod r)."""
    if k < 0:
        raise ValueError("scalar_mul needs k >= 0")
    q = IDENTITY
    n = p
    while k:
        if k & 1:
            q = point_add(q, n)
        n = point_double(n)
        k >>= 1
    return q


def ltr_bin_mul(p: ExtPoint, k: int, nbits: int = 250) -> ExtPoint:
    """MSB-first fixed-ladder form (edwards.rs:122-134) - the TPU-shaped one.

    NOTE: the reference iterates only 249 bits (edwards.rs:129), silently
    dropping bit 249 of scalars in [2^249, r); canonical scalars need 250 bits
    (r < 2^250), so we use 250."""
    q = IDENTITY
    for i in reversed(range(nbits)):
        q = point_double(q)
        if (k >> i) & 1:
            q = point_add(q, p)
    return q


def mul_by_cofactor(p: ExtPoint) -> ExtPoint:
    return scalar_mul(p, 8)


def mul_by_pow_2(p: ExtPoint, k: int) -> ExtPoint:
    return scalar_mul(p, 1 << k)


def point_to_affine(p: ExtPoint) -> tuple[int, int]:
    X, Y, Z, _ = p
    zi = finv(Z)
    return (fmul(X, zi), fmul(Y, zi))


def point_from_affine(xy: tuple[int, int]) -> ExtPoint:
    x, y = xy
    return (x, y, 1, fmul(x, y))


def find_xx(y: int) -> int:
    """xx = (y^2 - 1) / (d*y^2 - a)."""
    ys = fsquare(y)
    return fdiv(fsub(ys, 1), fsub(fmul(EDWARDS_D, ys), EDWARDS_A))


def point_from_y(y: int, sign: int) -> ExtPoint | None:
    x = mod_sqrt(find_xx(y), sign)
    if x is None:
        return None
    return (x, y, 1, fmul(x, y))


def edwards_compress(p: ExtPoint) -> bytes:
    """CompressedEdwardsY (edwards.rs:613-629): 255-bit y || sign(x) where the
    sign bit is 0 iff x equals the raw Tonelli root of xx."""
    x, y = point_to_affine(p)
    raw = mod_sqrt_ts(find_xx(y))
    sign = 0 if raw == x else 1
    b = bytearray(fe_to_bytes(y))
    b[31] |= sign << 7
    return bytes(b)


def edwards_decompress(b: bytes) -> ExtPoint | None:
    """CompressedEdwardsY::decompress (edwards.rs:313-326)."""
    sign = b[31] >> 7
    yb = bytearray(b)
    yb[31] &= 0b0000_1111
    y = fe_from_bytes(bytes(yb))
    return point_from_y(y, sign)


def point_is_valid(p: ExtPoint) -> bool:
    """Curve equation in projective form (edwards.rs:733-748) plus extended
    coordinate consistency T*Z == X*Y."""
    X, Y, Z, T = p
    xs, ys, zs = fsquare(X), fsquare(Y), fsquare(Z)
    left = fmul(fadd(fmul(EDWARDS_A, xs), ys), zs)
    right = fadd(fsquare(zs), fmul(EDWARDS_D, fmul(xs, ys)))
    return left == right and fmul(T, Z) == fmul(X, Y)


def edwards_to_montgomery_u(p: ExtPoint) -> int:
    """u = (Z + Y) / (Z - Y); the Montgomery u-coordinate of an Edwards point."""
    _, Y, Z, _ = p
    return fdiv(fadd(Z, Y), fsub(Z, Y))


def montgomery_u_to_edwards_y(u: int) -> int:
    """y = (u - 1) / (u + 1): inverse of the map above."""
    return fdiv(fsub(u, 1), fadd(u, 1))


# Basepoint: y = 3/5 (mod p), x the raw root (sign 0).
BASEPOINT: ExtPoint = point_from_y(fdiv(3, 5), 0)

# 4-torsion coset representatives exactly as the reference lists them
# (constants.rs:141-184): (1,0), (INV_SQRT_A, 0), (0,-1), (SQRT_M1, 0).
FOUR_COSET_GROUP: list[ExtPoint] = [
    (1, 0, 1, 0),
    (INV_SQRT_A, 0, 1, 0),
    (0, P - 1, 1, 0),
    (SQRT_M1, 0, 1, 0),
]


def coset4(p: ExtPoint) -> list[ExtPoint]:
    """The four Edwards points representing the same Ristretto point
    (edwards.rs:603-610)."""
    return [p] + [point_add(p, t) for t in FOUR_COSET_GROUP[:3]]


def ristretto_is_valid(p: ExtPoint) -> bool:
    """Order-L check plus curve membership (ristretto.rs:205-222)."""
    return point_is_valid(p) and point_eq(scalar_mul(p, R), IDENTITY)

# ---------------------------------------------------------------------------
# Ristretto
# ---------------------------------------------------------------------------


def ristretto_compress(p: ExtPoint) -> bytes:
    """Ristretto encode."""
    X, Y, Z, T = p
    u1 = fmul(fadd(Z, Y), fsub(Z, Y))
    u2 = fmul(X, Y)
    _, I = inv_sqrt(fmul(u1, fsquare(u2)))
    D1 = fmul(u1, I)
    D2 = fmul(u2, I)
    Zinv = fmul(fmul(D1, D2), T)
    if not is_positive(fmul(T, Zinv)):
        x, y = fmul(SQRT_M1, Y), fmul(SQRT_M1, X)
        D = fmul(D1, INV_SQRT_A_MINUS_D)
    else:
        x, y = X, Y
        D = D2
    if not is_positive(fmul(x, Zinv)):
        y = fneg(y)
    s = fmul(fsub(Z, y), D)
    if not is_positive(s):
        s = fneg(s)
    return fe_to_bytes(s)


def ristretto_decompress(b: bytes) -> ExtPoint | None:
    """Ristretto decode; None for an invalid encoding."""
    s = int.from_bytes(b, "little") % P
    if fe_to_bytes(s) != bytes(b) or not is_positive(s):
        return None
    ss = fsquare(s)
    u1 = fsub(1, ss)
    u2 = fadd(1, ss)
    u2_sq = fsquare(u2)
    v = fsub(fneg(fmul(EDWARDS_D, fsquare(u1))), u2_sq)
    ok, I = inv_sqrt(fmul(v, u2_sq))
    if not ok:
        return None
    Dx = fmul(I, u2)
    Dy = fmul(I, fmul(Dx, v))
    x = fmul(fadd(s, s), Dx)
    if not is_positive(x):
        x = fneg(x)
    y = fmul(u1, Dy)
    t = fmul(x, y)
    if not is_positive(t) or y == 0:
        return None
    return (x, y, 1, t)


def ristretto_eq(p: ExtPoint, q: ExtPoint) -> bool:
    """Coset-aware equality: X1*Y2 == Y1*X2 or X1*X2 == Y1*Y2
    (ristretto.rs:166-176)."""
    X1, Y1, _, _ = p
    X2, Y2, _, _ = q
    return fmul(X1, Y2) == fmul(Y1, X2) or fmul(X1, X2) == fmul(Y1, Y2)


def elligator_ristretto_flavor(r0: int) -> ExtPoint:
    """The Ristretto Elligator map."""
    d = EDWARDS_D
    c = P - 1
    r = fmul(SQRT_M1, fsquare(r0))
    N_s = fmul(fadd(r, 1), ONE_MINUS_D_SQ)
    D = fmul(fsub(c, fmul(d, r)), fadd(r, d))
    Ns_D_is_sq, s = sqrt_ratio_i(N_s, D)
    s_prim = fmul(s, r0)
    if is_positive(s_prim):
        s_prim = fneg(s_prim)
    if not Ns_D_is_sq:
        s = s_prim
        c = r
    N_t = fsub(fmul(fmul(c, fsub(r, 1)), D_MINUS_ONE_SQ), D)
    s_sq = fsquare(s)
    W0 = fmul(fadd(s, s), D)
    W1 = fmul(N_t, SQRT_AD_MINUS_ONE)
    W2 = fsub(1, s_sq)
    W3 = fadd(1, s_sq)
    return (fmul(W0, W3), fmul(W2, W1), fmul(W1, W3), fmul(W0, W2))


def from_uniform_bytes(b: bytes) -> ExtPoint:
    """Hash-to-group: Elligator on each 32-byte half, then add."""
    if len(b) != 64:
        raise ValueError(f"expected 64 bytes, got {len(b)}")
    return point_add(elligator_ristretto_flavor(fe_from_bytes(b[:32])),
                     elligator_ristretto_flavor(fe_from_bytes(b[32:])))


# ---------------------------------------------------------------------------
# MSM
# ---------------------------------------------------------------------------


def msm(points: list[ExtPoint], scalars: list[int]) -> ExtPoint:
    """sum(k_i * P_i)."""
    acc = IDENTITY
    for p, k in zip(points, scalars):
        acc = point_add(acc, scalar_mul(p, k))
    return acc


# ---------------------------------------------------------------------------
# Limb codecs: radix 2^12 x 22 limbs, and the reference's 5 x 52 bits
# ---------------------------------------------------------------------------

RADIX_BITS = 12
NUM_LIMBS = 22


def int_to_limbs(a: int, n: int = NUM_LIMBS, w: int = RADIX_BITS) -> list[int]:
    if a < 0 or a >> (w * n):
        raise ValueError(f"value does not fit in {n} limbs of {w} bits")
    mask = (1 << w) - 1
    return [(a >> (w * i)) & mask for i in range(n)]


def limbs_to_int(limbs, w: int = RADIX_BITS) -> int:
    return sum(int(v) << (w * i) for i, v in enumerate(limbs))


def limbs52_to_int(limbs) -> int:
    return limbs_to_int(limbs, w=52)

def int_to_limbs52(a: int) -> list[int]:
    """The reference's 5x52-bit layout (field.rs:29-32), for verification."""
    return int_to_limbs(a, n=5, w=52)
