"""The Sonny curve's Ristretto group in plain Python integers: the
benchmark's frozen reference.

A direct copy of the arithmetic a user of the library would check against:
field arithmetic mod p, scalars mod r, Edwards points in extended
coordinates with the unified a = -1 HWCD addition, the Ristretto encode,
decode and Elligator map.  It imports nothing, so no change to the program
under test can change what the benchmark calls right.
"""

from __future__ import annotations

P = 2**252 + 27742317777372353535851937790883648493
R = 2**249 + 14490550575682688738086195780655237219   # the group's order

# ---------------------------------------------------------------------------
# Field mod p
# ---------------------------------------------------------------------------


def fmul(a: int, b: int) -> int:
    return (a * b) % P


def fsquare(a: int) -> int:
    return (a * a) % P


def fneg(a: int) -> int:
    return (-a) % P


def finv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("cannot invert 0")
    return pow(a, P - 2, P)


def is_positive(a: int) -> bool:
    """Decaf non-negativity: the least residue lies in [0, (p-1)/2]."""
    return (a % P) <= (P - 1) // 2


def fabs(a: int) -> int:
    a %= P
    return a if is_positive(a) else P - a


_C6 = pow(6, (P - 1) // 4, P)                 # a square root of -1
SQRT_M1 = _C6 if is_positive(_C6) else P - _C6


def _sqrt_raw(a: int) -> int | None:
    """A square root of a (p == 5 mod 8), or None for a non-residue."""
    a %= P
    if a == 0:
        return 0
    beta = pow(a, (P + 3) // 8, P)
    if beta * beta % P == a:
        return beta
    beta = beta * _C6 % P
    return beta if beta * beta % P == a else None


def sqrt_ratio_i(u: int, v: int) -> tuple[bool, int]:
    """(True, +sqrt(u/v)) if u/v is a square, (True, 0) if u == 0,
    (False, 0) if v == 0 != u, else (False, +sqrt(i u / v))."""
    u %= P
    v %= P
    if u == 0:
        return True, 0
    if v == 0:
        return False, 0
    ratio = fmul(u, finv(v))
    root = _sqrt_raw(ratio)
    if root is not None:
        return True, fabs(root)
    return False, fabs(_sqrt_raw(fmul(SQRT_M1, ratio)))


def fe_to_bytes(a: int) -> bytes:
    return (a % P).to_bytes(32, "little")


EDWARDS_D = fmul(fneg(126296), finv(126297))
INV_SQRT_A_MINUS_D = fabs(_sqrt_raw(finv((P - 1 - EDWARDS_D) % P)))
SQRT_AD_MINUS_ONE = fabs(_sqrt_raw((fneg(EDWARDS_D) - 1) % P))
ONE_MINUS_D_SQ = (1 - fsquare(EDWARDS_D)) % P
D_MINUS_ONE_SQ = fsquare(EDWARDS_D - 1)

# ---------------------------------------------------------------------------
# Edwards points, extended (X, Y, Z, T)
# ---------------------------------------------------------------------------

IDENTITY = (0, 1, 1, 0)


def point_add(p, q):
    """Unified HWCD addition for a = -1; complete on this curve."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = X1 * X2 % P
    B = Y1 * Y2 % P
    C = EDWARDS_D * (T1 * T2 % P) % P
    D = Z1 * Z2 % P
    E = ((X1 + Y1) * (X2 + Y2) - A - B) % P
    F = (D - C) % P
    G = (D + C) % P
    H = (B + A) % P
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def point_double(p):
    return point_add(p, p)


def scalar_mul(p, k: int):
    """k p by double-and-add over the bits of k >= 0."""
    acc, base = IDENTITY, p
    while k:
        if k & 1:
            acc = point_add(acc, base)
        base = point_double(base)
        k >>= 1
    return acc


def _basepoint():
    y = fmul(3, finv(5))
    xx = fmul((y * y - 1) % P, finv((EDWARDS_D * y * y + 1) % P))
    x = _sqrt_raw(xx)
    return (x, y, 1, fmul(x, y))


BASEPOINT = _basepoint()

# ---------------------------------------------------------------------------
# Ristretto
# ---------------------------------------------------------------------------


def ristretto_compress(p) -> bytes:
    X, Y, Z, T = p
    u1 = fmul(Z + Y, Z - Y)
    u2 = fmul(X, Y)
    _, inv = sqrt_ratio_i(1, fmul(u1, fsquare(u2)))
    d1 = fmul(u1, inv)
    d2 = fmul(u2, inv)
    z_inv = fmul(fmul(d1, d2), T)
    if not is_positive(fmul(T, z_inv)):
        x, y = fmul(SQRT_M1, Y), fmul(SQRT_M1, X)
        den = fmul(d1, INV_SQRT_A_MINUS_D)
    else:
        x, y, den = X, Y, d2
    if not is_positive(fmul(x, z_inv)):
        y = fneg(y)
    return fe_to_bytes(fabs(fmul(Z - y, den)))


def ristretto_decompress(b: bytes):
    """The point of a Ristretto encoding, or None where it is invalid
    (non-canonical, negative, or not on the group)."""
    s = int.from_bytes(b, "little") % P
    if fe_to_bytes(s) != bytes(b) or not is_positive(s):
        return None
    ss = fsquare(s)
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sq = fsquare(u2)
    v = (fneg(fmul(EDWARDS_D, fsquare(u1))) - u2_sq) % P
    ok, inv = sqrt_ratio_i(1, fmul(v, u2_sq))
    if not ok:
        return None
    dx = fmul(inv, u2)
    dy = fmul(inv, fmul(dx, v))
    x = fabs(fmul(2 * s, dx))
    y = fmul(u1, dy)
    t = fmul(x, y)
    if not is_positive(t) or y == 0:
        return None
    return (x, y, 1, t)


def elligator(r0: int):
    """The Ristretto Elligator map of a field element."""
    d = EDWARDS_D
    c = P - 1
    r = fmul(SQRT_M1, fsquare(r0))
    n_s = fmul(r + 1, ONE_MINUS_D_SQ)
    den = fmul((c - fmul(d, r)) % P, r + d)
    square, s = sqrt_ratio_i(n_s, den)
    s_prim = fmul(s, r0)
    if is_positive(s_prim):
        s_prim = fneg(s_prim)
    if not square:
        s, c = s_prim, r
    n_t = (fmul(fmul(c, r - 1), D_MINUS_ONE_SQ) - den) % P
    s_sq = fsquare(s)
    w0 = fmul(2 * s, den)
    w1 = fmul(n_t, SQRT_AD_MINUS_ONE)
    w2 = (1 - s_sq) % P
    w3 = (1 + s_sq) % P
    return (fmul(w0, w3), fmul(w2, w1), fmul(w1, w3), fmul(w0, w2))


def from_uniform_bytes(b: bytes):
    """Hash to the group: Elligator on each 32-byte half (each read as a
    256-bit value mod p), then their sum."""
    if len(b) != 64:
        raise ValueError(f"expected 64 bytes, got {len(b)}")
    return point_add(elligator(int.from_bytes(b[:32], "little") % P),
                     elligator(int.from_bytes(b[32:], "little") % P))


def scalar_from_bytes_wide(b: bytes) -> int:
    """A 64-byte little-endian value mod r."""
    return int.from_bytes(b, "little") % R


# ---------------------------------------------------------------------------
# Fast multiples of the basepoint
# ---------------------------------------------------------------------------


class BasepointTable:
    """k B for many k by a byte-wise table: entry [i][d] = d 256^i B, so
    that k B is the sum of 32 entries, one for each byte of k < 2^256."""

    def __init__(self):
        self.rows = []
        base = BASEPOINT
        for _ in range(32):
            row = [IDENTITY, base]
            for _ in range(254):
                row.append(point_add(row[-1], base))
            self.rows.append(row)
            base = point_add(row[-1], base)          # 256 * base

    def mul(self, k: int):
        acc = IDENTITY
        for row, byte in zip(self.rows, (k % R).to_bytes(32, "little")):
            if byte:
                acc = point_add(acc, row[byte])
        return acc
