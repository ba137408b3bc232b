"""Ed25519 (RFC 8032): key generation from a 32-byte seed, signing and
verification, in plain Python over `hashlib`'s SHA-512.

The node identities of the mesh (`p2p/identity.py`) sign handshakes,
QBFT messages and operator entries with it.  Verification accepts and
rejects exactly what OpenSSL's `ossl_ed25519_verify` does (the library
behind the JAX package's `cryptography` calls):

- a signature of other than 64 bytes or a key of other than 32 is
  refused;
- S ≥ L is refused;
- the key A is decoded with its y taken mod p and the sign bit applied
  to whichever root comes out (so a non-canonical A, a small-order A
  and x = 0 with the sign bit set are accepted as OpenSSL accepts them);
  a y with no x is refused;
- R is never decoded: the encoding of [S]B − [h]A must equal R's bytes,
  which refuses every non-canonical R.

Points are extended twisted-Edwards coordinates (X:Y:Z:T) over
p = 2²⁵⁵ − 19; [s]B walks a fixed-base table of the base point's 16ᵏ
multiples (64 additions, no doublings), [h]A a 4-bit window.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, P - 2, P) % P
D2 = 2 * D % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

_IDENT = (0, 1, 1, 0)


def _add(p1, p2):
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = p2
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * D2 * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return e * f % P, g * h % P, f * g % P, e * h % P


def _dbl(p1):
    x1, y1, z1, _ = p1
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    h = a + b
    e = h - (x1 + y1) * (x1 + y1) % P
    g = a - b
    f = c + g
    return e * f % P, g * h % P, f * g % P, e * h % P


def _encode(pt) -> bytes:
    x, y, z, _ = pt
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _decode(s: bytes):
    """OpenSSL's `ge_frombytes_vartime`: y mod p, x from the curve
    equation with the sign bit's parity, None when y has no x."""
    v = int.from_bytes(s, "little")
    sign = v >> 255
    y = (v & ((1 << 255) - 1)) % P
    u = (y * y - 1) % P
    w = (D * y * y + 1) % P
    x2 = u * pow(w, P - 2, P) % P
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P:
        x = x * SQRT_M1 % P
        if (x * x - x2) % P:
            return None
    if (x & 1) != sign:
        x = (P - x) % P
    return x, y, 1, x * y % P


_BY = 4 * pow(5, P - 2, P) % P
_BX = pow((_BY * _BY - 1) * pow(D * _BY * _BY + 1, P - 2, P), (P + 3) // 8,
          P)
if (_BX * _BX - (_BY * _BY - 1) * pow(D * _BY * _BY + 1, P - 2, P)) % P:
    _BX = _BX * SQRT_M1 % P
if _BX & 1:
    _BX = P - _BX
BASE = (_BX, _BY, 1, _BX * _BY % P)

_TABLE: list = []


def _base_table() -> list:
    """[j · 16ⁱ]B for i < 64, j < 16 (built on first use; threads that
    race to build it build the same table, and the name is rebound whole)."""
    global _TABLE
    if not _TABLE:
        table, step = [], BASE
        for _ in range(64):
            row = [_IDENT, step]
            for _ in range(14):
                row.append(_add(row[-1], step))
            table.append(row)
            step = _add(row[-1], step)
        _TABLE = table
    return _TABLE


def _mul_base(s: int):
    table = _base_table()
    acc = _IDENT
    for i in range(64):
        nib = (s >> (4 * i)) & 15
        if nib:
            acc = _add(acc, table[i][nib])
    return acc


def _mul(s: int, pt):
    win = [_IDENT, pt]
    for _ in range(14):
        win.append(_add(win[-1], pt))
    acc = _IDENT
    for i in range(63, -1, -1):
        acc = _dbl(_dbl(_dbl(_dbl(acc))))
        nib = (s >> (4 * i)) & 15
        if nib:
            acc = _add(acc, win[nib])
    return acc


def _neg(pt):
    x, y, z, t = pt
    return (P - x) % P, y, z, (P - t) % P


def _h(*parts: bytes) -> int:
    return int.from_bytes(hashlib.sha512(b"".join(parts)).digest(),
                          "little")


def _expand(seed: bytes) -> tuple[int, bytes]:
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def public_key(seed: bytes) -> bytes:
    """The 32-byte public key of a 32-byte private seed."""
    if len(seed) != 32:
        raise ValueError("an Ed25519 private key is 32 bytes")
    a, _ = _expand(seed)
    return _encode(_mul_base(a))


def sign(seed: bytes, msg: bytes, pub: bytes | None = None) -> bytes:
    """RFC 8032 §5.1.6: the 64-byte signature R ‖ S of `msg`."""
    if len(seed) != 32:
        raise ValueError("an Ed25519 private key is 32 bytes")
    a, prefix = _expand(seed)
    if pub is None:
        pub = _encode(_mul_base(a))
    r = _h(prefix, msg) % L
    rb = _encode(_mul_base(r))
    k = _h(rb, pub, msg) % L
    return rb + ((r + k * a) % L).to_bytes(32, "little")


def verify(pub: bytes, sig: bytes, msg: bytes) -> bool:
    """True when `sig` is a valid signature of `msg` under `pub`, with
    OpenSSL's accept and reject rules (module docstring)."""
    if len(pub) != 32 or len(sig) != 64:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    a = _decode(pub)
    if a is None:
        return False
    k = _h(sig[:32], pub, msg) % L
    return _encode(_add(_mul_base(s), _mul(k, _neg(a)))) == sig[:32]
