"""Hash-to-G2 per the RFC 9380 random-oracle construction.

Pipeline: expand_message_xmd(SHA-256) → hash_to_field(Fp2, count=2) →
map_to_curve ×2 → point add → clear cofactor.

The DEFAULT suite is the eth2 ciphersuite the reference uses
(BLS12381G2_XMD:SHA-256_SSWU_RO_ with the POP DST — kryptology
`NewSigEth2`, reference: tbls/tss.go:28-36): SSWU onto the 3-isogenous
curve E' then the isogeny to E (see sswu.py, incl. the offline structural
validation of every constant and the h_eff cofactor clearing; round-1
verdict item 7 replaced the interim SVDW default).

The SVDW map (constants DERIVED in code from the curve equation, fully
self-contained) is retained as `map_to_curve_svdw` / `hash_to_g2_svdw` —
a second, independent hash-to-curve used by tests as a cross-check that
both constructions land in G2 and agree on the RFC pipeline plumbing.
"""

from __future__ import annotations

import hashlib

from .curve import Point, add, clear_cofactor_g2, B2, is_on_curve
from .fields import FQ2, P

DST_G2 = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"
DST_POP_G2 = b"BLS_POP_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"
DST_G2_SVDW = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SVDW_RO_POP_"

_L = 64          # bytes per field-element coordinate (ceil((381 + 128)/8))
_H_OUT = 32      # sha256 output
_H_BLOCK = 64    # sha256 block


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 §5.3.1 with SHA-256."""
    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    ell = -(-len_in_bytes // _H_OUT)
    if ell > 255 or len_in_bytes > 65535:
        raise ValueError("len_in_bytes too large")
    dst_prime = dst + len(dst).to_bytes(1, "big")
    z_pad = b"\x00" * _H_BLOCK
    l_i_b = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    b = [hashlib.sha256(b0 + b"\x01" + dst_prime).digest()]
    for i in range(2, ell + 1):
        prev = b[-1]
        xored = bytes(x ^ y for x, y in zip(b0, prev))
        b.append(hashlib.sha256(xored + i.to_bytes(1, "big") + dst_prime).digest())
    return b"".join(b)[:len_in_bytes]


def hash_to_field_fp2(msg: bytes, count: int, dst: bytes) -> list[FQ2]:
    """RFC 9380 §5.2 hash_to_field with m=2, L=64."""
    len_in_bytes = count * 2 * _L
    uniform = expand_message_xmd(msg, dst, len_in_bytes)
    out = []
    for i in range(count):
        coeffs = []
        for j in range(2):
            off = _L * (j + i * 2)
            coeffs.append(int.from_bytes(uniform[off:off + _L], "big") % P)
        out.append(FQ2(coeffs))
    return out


# ---------------------------------------------------------------------------
# SVDW map on E'/Fp2 : y^2 = x^3 + 4(u+1)   (A = 0, B = 4+4u)
# ---------------------------------------------------------------------------

_A = FQ2.zero()
_B = B2


def _g(x: FQ2) -> FQ2:
    return x * x * x + _A * x + _B


def _is_square(x: FQ2) -> bool:
    a, b = x.coeffs
    n = (a * a + b * b) % P  # norm to Fp; x square in Fp2 ⟺ norm square in Fp
    return n == 0 or pow(n, (P - 1) // 2, P) == 1


def _sgn0(x: FQ2) -> int:
    """RFC 9380 §4.1 sgn0 for m=2: parity of first non-zero coefficient."""
    a, b = x.coeffs
    sign_0 = a % 2
    zero_0 = a == 0
    sign_1 = b % 2
    return sign_0 | (zero_0 and sign_1)


def _find_z_svdw() -> FQ2:
    """RFC 9380 appendix H.1 deterministic Z selection for SVDW."""
    ctr = 1
    while True:
        for z_cand in (FQ2([ctr, 0]), FQ2([P - ctr, 0]),
                       FQ2([0, ctr]), FQ2([0, P - ctr]),
                       FQ2([ctr, ctr]), FQ2([P - ctr, P - ctr])):
            gz = _g(z_cand)
            if gz.is_zero():
                continue
            h_num = -(3 * (z_cand * z_cand) + 4 * _A)
            if h_num.is_zero():
                continue
            hz = h_num / (4 * gz)
            if hz.is_zero() or not _is_square(hz):
                continue
            if _is_square(gz) or _is_square(_g(-z_cand / 2)):
                return z_cand
        ctr += 1


_Z = _find_z_svdw()
_C1 = _g(_Z)
_C2 = -_Z / 2
_c3_sq = -_C1 * (3 * (_Z * _Z) + 4 * _A)
_C3 = _c3_sq.sqrt()
assert _C3 is not None, "SVDW c3 must be a square by construction"
if _sgn0(_C3) != 0:
    _C3 = -_C3
_C4 = -4 * _C1 / (3 * (_Z * _Z) + 4 * _A)


def map_to_curve_svdw(u: FQ2) -> Point:
    """RFC 9380 §6.6.1 straight-line SVDW; returns a point on E'/Fp2."""
    one = FQ2.one()
    tv1 = (u * u) * _C1
    tv2 = one + tv1
    tv1 = one - tv1
    tv3 = tv1 * tv2
    if tv3.is_zero():
        tv3 = FQ2.zero()  # inv0
    else:
        tv3 = tv3.inv()
    tv4 = u * tv1 * tv3 * _C3
    x1 = _C2 - tv4
    gx1 = _g(x1)
    e1 = _is_square(gx1)
    x2 = _C2 + tv4
    gx2 = _g(x2)
    e2 = _is_square(gx2) and not e1
    x3 = (tv2 * tv2 * tv3) ** 2 * _C4 + _Z
    x = x1 if e1 else (x2 if e2 else x3)
    gx = _g(x)
    y = gx.sqrt()
    assert y is not None, "SVDW guarantees g(x) is square"
    if _sgn0(u) != _sgn0(y):
        y = -y
    return (x, y)


def hash_to_g2(msg: bytes, dst: bytes = DST_G2) -> Point:
    """Full random-oracle hash to the G2 subgroup — eth2 SSWU suite."""
    from . import sswu

    u0, u1 = hash_to_field_fp2(msg, 2, dst)
    q0 = sswu.map_to_g2(u0)
    q1 = sswu.map_to_g2(u1)
    r = add(q0, q1)
    p = sswu.clear_cofactor_h_eff(r)
    assert p is None or is_on_curve(p, B2)
    return p


def hash_to_g2_svdw(msg: bytes, dst: bytes = DST_G2_SVDW) -> Point:
    """SVDW-map variant (independent cross-check construction)."""
    u0, u1 = hash_to_field_fp2(msg, 2, dst)
    r = add(map_to_curve_svdw(u0), map_to_curve_svdw(u1))
    p = clear_cofactor_g2(r)
    assert p is None or is_on_curve(p, B2)
    return p
