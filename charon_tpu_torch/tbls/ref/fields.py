"""Pure-Python BLS12-381 field tower — the CPU correctness oracle.

This is the reference implementation every batched JAX/Pallas kernel in
charon_tpu_torch.ops is differentially tested against (SURVEY.md §4 lesson (e)).
It is a copy of the JAX package's oracle, so the port imports nothing of
that package.
It plays the role kryptology's `curves/native/bls12381` plays for the
reference implementation (reference: tbls/tss.go:21-23) — but is written
from the curve specification, optimised for auditability, not speed.

Field tower:
    Fp            381-bit prime field
    Fp2 = Fp[u]/(u^2 + 1)
    Fp12 = Fp[w]/(w^12 - 2 w^6 + 2)      (u = w^6 - 1, so Fp2 ⊂ Fp12)

The single-variable Fp12 representation (rather than a 2-3-2 tower) keeps
the pairing code short and obviously correct; the JAX kernels use the fast
2-3-2 tower and are checked against this.
"""

from __future__ import annotations

# BLS12-381 parameters.
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001  # curve (subgroup) order
BLS_X = 0xD201000000010000  # |x|; the BLS parameter is -x (negative)
BLS_X_IS_NEGATIVE = True

assert P % 4 == 3  # enables cheap Fp square roots


# ---------------------------------------------------------------------------
# Fp
# ---------------------------------------------------------------------------

class FQ:
    """Element of the 381-bit base field Fp."""

    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n % P

    def __add__(self, o):
        return FQ(self.n + _val(o))

    __radd__ = __add__

    def __sub__(self, o):
        return FQ(self.n - _val(o))

    def __rsub__(self, o):
        return FQ(_val(o) - self.n)

    def __mul__(self, o):
        return FQ(self.n * _val(o))

    __rmul__ = __mul__

    def __neg__(self):
        return FQ(-self.n)

    def __truediv__(self, o):
        return self * FQ(_val(o)).inv()

    def __rtruediv__(self, o):
        return FQ(_val(o)) * self.inv()

    def __pow__(self, e: int):
        return FQ(pow(self.n, e, P))

    def __eq__(self, o):
        if not isinstance(o, (FQ, int)):
            return NotImplemented
        return self.n == _val(o) % P

    def __hash__(self):
        return hash(self.n)

    def __repr__(self):
        return f"FQ(0x{self.n:x})"

    def inv(self) -> "FQ":
        return FQ(pow(self.n, -1, P))

    def is_zero(self) -> bool:
        return self.n == 0

    def sqrt(self) -> "FQ | None":
        """Square root if one exists (p ≡ 3 mod 4)."""
        c = pow(self.n, (P + 1) // 4, P)
        return FQ(c) if c * c % P == self.n else None

    def sgn(self) -> int:
        """Lexicographic sign used by the ZCash serialisation format."""
        return 1 if self.n > (P - 1) // 2 else 0

    @classmethod
    def zero(cls):
        return cls(0)

    @classmethod
    def one(cls):
        return cls(1)


def _val(o) -> int:
    return o.n if isinstance(o, FQ) else int(o)


# ---------------------------------------------------------------------------
# Generic polynomial extension FQP, specialised to FQ2 and FQ12
# ---------------------------------------------------------------------------

def _poly_rounded_div(a: list[int], b: list[int]) -> list[int]:
    """Division (quotient) of polynomials over Fp, coefficients little-endian."""
    dega = _deg(a)
    degb = _deg(b)
    temp = list(a)
    out = [0] * len(a)
    binv = pow(b[degb], -1, P)
    for i in range(dega - degb, -1, -1):
        out[i] = (out[i] + temp[degb + i] * binv) % P
        for c in range(degb + 1):
            temp[c + i] = (temp[c + i] - out[i] * b[c]) % P
    return out[: _deg(out) + 1]


def _deg(p: list[int]) -> int:
    d = len(p) - 1
    while d and p[d] % P == 0:
        d -= 1
    return d


class FQP:
    """Element of Fp[x] / (x^deg + modulus_coeffs(x))."""

    degree: int = 0
    modulus_coeffs: tuple[int, ...] = ()

    __slots__ = ("coeffs",)

    def __init__(self, coeffs):
        assert len(coeffs) == self.degree
        self.coeffs = tuple(int(c) % P for c in coeffs)

    # -- ring ops ----------------------------------------------------------
    def __add__(self, o):
        o = self._coerce(o)
        return type(self)([a + b for a, b in zip(self.coeffs, o.coeffs)])

    def __sub__(self, o):
        o = self._coerce(o)
        return type(self)([a - b for a, b in zip(self.coeffs, o.coeffs)])

    def __neg__(self):
        return type(self)([-a for a in self.coeffs])

    def __mul__(self, o):
        if isinstance(o, (int, FQ)):
            v = _val(o)
            return type(self)([c * v for c in self.coeffs])
        o = self._coerce(o)
        deg = self.degree
        b = [0] * (deg * 2 - 1)
        for i, a in enumerate(self.coeffs):
            if a:
                for j, c in enumerate(o.coeffs):
                    b[i + j] += a * c
        # reduce by x^deg = -modulus_coeffs(x)
        for exp in range(deg * 2 - 2, deg - 1, -1):
            top = b[exp] % P
            b[exp] = 0
            if top:
                off = exp - deg
                for i, m in enumerate(self.modulus_coeffs):
                    if m:
                        b[off + i] -= top * m
        return type(self)(b[:deg])

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, (int, FQ)):
            return self * pow(_val(o), -1, P)
        return self * self._coerce(o).inv()

    def __pow__(self, e: int):
        result = type(self).one()
        base = self
        if e < 0:
            base = base.inv()
            e = -e
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def __eq__(self, o):
        if isinstance(o, (int, FQ)):
            return self == self._coerce(o)
        if not isinstance(o, type(self)):
            return NotImplemented
        return self.coeffs == o.coeffs

    def __hash__(self):
        return hash(self.coeffs)

    def __repr__(self):
        return f"{type(self).__name__}({[hex(c) for c in self.coeffs]})"

    def _coerce(self, o):
        if isinstance(o, type(self)):
            return o
        if isinstance(o, (int, FQ)):
            return type(self)([_val(o)] + [0] * (self.degree - 1))
        raise TypeError(f"cannot coerce {o!r} to {type(self).__name__}")

    def inv(self):
        """Inverse by extended Euclid over Fp[x]."""
        deg = self.degree
        lm, hm = [1] + [0] * deg, [0] * (deg + 1)
        low = list(self.coeffs) + [0]
        high = list(self.modulus_coeffs) + [1]
        while _deg(low):
            r = _poly_rounded_div(high, low)
            r += [0] * (deg + 1 - len(r))
            nm, new = list(hm), list(high)
            for i in range(deg + 1):
                for j in range(deg + 1 - i):
                    nm[i + j] -= lm[i] * r[j]
                    new[i + j] -= low[i] * r[j]
            nm = [x % P for x in nm]
            new = [x % P for x in new]
            lm, low, hm, high = nm, new, lm, low
        if _val(low[0]) == 0:
            raise ZeroDivisionError("inverse of zero element")
        linv = pow(low[0], -1, P)
        return type(self)([c * linv for c in lm[: deg]])

    def is_zero(self) -> bool:
        return all(c == 0 for c in self.coeffs)

    def conjugate_p6(self):
        """f^(p^6): for FQ12 this negates odd powers of w (w^(p^6) = -w)."""
        return type(self)(
            [c if i % 2 == 0 else P - c if c else 0 for i, c in enumerate(self.coeffs)]
        )

    @classmethod
    def one(cls):
        return cls([1] + [0] * (cls.degree - 1))

    @classmethod
    def zero(cls):
        return cls([0] * cls.degree)


class FQ2(FQP):
    """Fp2 = Fp[u]/(u^2 + 1), element c0 + c1·u."""

    degree = 2
    modulus_coeffs = (1, 0)

    def sqrt(self) -> "FQ2 | None":
        """Complex-method square root in Fp2 (valid since u^2 = -1)."""
        a, b = self.coeffs
        if b == 0:
            r = FQ(a).sqrt()
            if r is not None:
                return FQ2([r.n, 0])
            r = FQ(-a).sqrt()
            # (c·u)^2 = -c^2 = a  when c^2 = -a
            return FQ2([0, r.n]) if r is not None else None
        n = (a * a + b * b) % P  # norm
        s = FQ(n).sqrt()
        if s is None:
            return None
        inv2 = pow(2, -1, P)
        x2 = (a + s.n) * inv2 % P
        x = FQ(x2).sqrt()
        if x is None:
            x2 = (a - s.n) * inv2 % P
            x = FQ(x2).sqrt()
            if x is None:
                return None
        y = b * pow(2 * x.n, -1, P) % P
        cand = FQ2([x.n, y])
        return cand if cand * cand == self else None

    def sgn(self) -> int:
        """Lexicographic sign per ZCash format: compare c1 first, then c0."""
        a, b = self.coeffs
        if b:
            return 1 if b > (P - 1) // 2 else 0
        return 1 if a > (P - 1) // 2 else 0

    def frobenius(self) -> "FQ2":
        """x^p = conjugate in Fp2."""
        a, b = self.coeffs
        return FQ2([a, -b if b else 0])


class FQ12(FQP):
    """Fp12 = Fp[w]/(w^12 - 2 w^6 + 2); u = w^6 - 1 embeds Fp2."""

    degree = 12
    modulus_coeffs = (2, 0, 0, 0, 0, 0, -2, 0, 0, 0, 0, 0)


def fq2_to_fq12(x: FQ2) -> FQ12:
    """Embed Fp2 into Fp12 via u = w^6 - 1."""
    a, b = x.coeffs
    return FQ12([(a - b) % P, 0, 0, 0, 0, 0, b, 0, 0, 0, 0, 0])


# w, and the untwist factors 1/w^2, 1/w^3 used by the M-twist untwisting map.
W = FQ12([0, 1] + [0] * 10)
W2_INV = (W * W).inv()
W3_INV = (W * W * W).inv()
