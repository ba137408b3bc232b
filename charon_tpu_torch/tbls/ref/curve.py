"""BLS12-381 curve groups G1 (over Fp) and G2 (over Fp2), affine arithmetic.

Reference analogue: kryptology curve layer consumed by tbls/tss.go.
Points are `(x, y)` tuples of field elements or ``None`` for infinity —
generic over FQ / FQ2 / FQ12 so the same functions serve the pairing's
untwisted Fp12 points.

Serialisation follows the ZCash BLS12-381 format used across eth2
(48-byte compressed G1, 96-byte compressed G2; flag bits C=0x80, I=0x40,
S=0x20), matching the reference's wire types (tbls/tblsconv/tblsconv.go:29-173).
"""

from __future__ import annotations

from .fields import FQ, FQ2, FQ12, P, R

# Curve: y^2 = x^3 + 4; twist E'/Fp2: y^2 = x^3 + 4(u+1)  (M-twist).
B1 = FQ(4)
B2 = FQ2([4, 4])
B12 = FQ12([4] + [0] * 11)

G1_GEN = (
    FQ(0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB),
    FQ(0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1),
)
G2_GEN = (
    FQ2([
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ]),
    FQ2([
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ]),
)

# G1 cofactor (standard constant, self-checked in tests via order relations).
H1 = 0x396C8C005555E1568C00AAAB0000AAAB

Point = tuple | None


def is_on_curve(pt: Point, b) -> bool:
    if pt is None:
        return True
    x, y = pt
    return y * y - x * x * x == b


def neg(pt: Point) -> Point:
    if pt is None:
        return None
    x, y = pt
    return (x, -y)


def double(pt: Point) -> Point:
    if pt is None:
        return None
    x, y = pt
    if y.is_zero():
        return None
    m = (3 * (x * x)) / (2 * y)
    nx = m * m - 2 * x
    ny = m * (x - nx) - y
    return (nx, ny)


def add(p1: Point, p2: Point) -> Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            return double(p1)
        return None
    m = (y2 - y1) / (x2 - x1)
    nx = m * m - x1 - x2
    ny = m * (x1 - nx) - y1
    return (nx, ny)


def multiply(pt: Point, n: int) -> Point:
    return multiply_raw(pt, n % R)


def multiply_raw(pt: Point, n: int) -> Point:
    """Scalar multiplication WITHOUT reduction mod R (for cofactor clearing)."""
    result = None
    addend = pt
    while n:
        if n & 1:
            result = add(result, addend)
        addend = double(addend)
        n >>= 1
    return result


# ---------------------------------------------------------------------------
# G2 cofactor — derived, not memorised.
# ---------------------------------------------------------------------------

def _derive_g2_cofactor() -> int:
    """#E'(Fp2)/R for the correct sextic twist.

    #E(Fp) = p + 1 - t with trace t = x + 1 (BLS12 family, x = -|BLS_X|).
    Over Fp2 the trace is t2 = t^2 - 2p.  The sextic twists of E/Fp2 have
    orders p^2 + 1 - (±3f ± t2)/2 where t2^2 - 4 p^2 = -3 f^2; pick the one
    divisible by R (that's the twist the generator lives on).
    """
    from math import isqrt

    t = -0xD201000000010000 + 1
    t2 = t * t - 2 * P
    f2, rem = divmod(4 * P * P - t2 * t2, 3)
    assert rem == 0
    f = isqrt(f2)
    assert f * f == f2
    for cand_t in ((3 * f + t2) // 2, (-3 * f + t2) // 2, (3 * f - t2) // 2,
                   (-3 * f - t2) // 2, t2):
        order = P * P + 1 - cand_t
        if order % R == 0:
            return order // R
    raise AssertionError("no twist order divisible by R")


H2 = _derive_g2_cofactor()


def clear_cofactor_g1(pt: Point) -> Point:
    return multiply_raw(pt, H1)


def clear_cofactor_g2(pt: Point) -> Point:
    return multiply_raw(pt, H2)


def in_g1(pt: Point) -> bool:
    return is_on_curve(pt, B1) and multiply_raw(pt, R) is None


def in_g2(pt: Point) -> bool:
    return is_on_curve(pt, B2) and multiply_raw(pt, R) is None


# ---------------------------------------------------------------------------
# ZCash serialisation
# ---------------------------------------------------------------------------

_C_FLAG = 0x80
_I_FLAG = 0x40
_S_FLAG = 0x20


def g1_to_bytes(pt: Point) -> bytes:
    if pt is None:
        return bytes([_C_FLAG | _I_FLAG]) + b"\x00" * 47
    x, y = pt
    out = bytearray(x.n.to_bytes(48, "big"))
    out[0] |= _C_FLAG
    if y.sgn():
        out[0] |= _S_FLAG
    return bytes(out)


def g1_from_bytes(data: bytes, subgroup_check: bool = True) -> Point:
    if len(data) != 48:
        raise ValueError("G1 compressed point must be 48 bytes")
    flags = data[0]
    if not flags & _C_FLAG:
        raise ValueError("uncompressed G1 not supported on the wire")
    if flags & _I_FLAG:
        if any(data[1:]) or flags & ~( _C_FLAG | _I_FLAG):
            raise ValueError("malformed infinity encoding")
        return None
    x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
    if x >= P:
        raise ValueError("G1 x not a field element")
    xf = FQ(x)
    y2 = xf * xf * xf + B1
    y = y2.sqrt()
    if y is None:
        raise ValueError("G1 x not on curve")
    if y.sgn() != (1 if flags & _S_FLAG else 0):
        y = -y
    pt = (xf, y)
    if subgroup_check and not in_g1(pt):
        raise ValueError("G1 point not in prime-order subgroup")
    return pt


def g2_to_bytes(pt: Point) -> bytes:
    if pt is None:
        return bytes([_C_FLAG | _I_FLAG]) + b"\x00" * 95
    x, y = pt
    c0, c1 = x.coeffs
    out = bytearray(c1.to_bytes(48, "big") + c0.to_bytes(48, "big"))
    out[0] |= _C_FLAG
    if y.sgn():
        out[0] |= _S_FLAG
    return bytes(out)


def g2_from_bytes(data: bytes, subgroup_check: bool = True) -> Point:
    if len(data) != 96:
        raise ValueError("G2 compressed point must be 96 bytes")
    flags = data[0]
    if not flags & _C_FLAG:
        raise ValueError("uncompressed G2 not supported on the wire")
    if flags & _I_FLAG:
        if any(data[1:]) or flags & ~(_C_FLAG | _I_FLAG):
            raise ValueError("malformed infinity encoding")
        return None
    c1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
    c0 = int.from_bytes(data[48:], "big")
    if c0 >= P or c1 >= P:
        raise ValueError("G2 x not a field element")
    xf = FQ2([c0, c1])
    y2 = xf * xf * xf + B2
    y = y2.sqrt()
    if y is None:
        raise ValueError("G2 x not on curve")
    if y.sgn() != (1 if flags & _S_FLAG else 0):
        y = -y
    pt = (xf, y)
    if subgroup_check and not in_g2(pt):
        raise ValueError("G2 point not in prime-order subgroup")
    return pt
