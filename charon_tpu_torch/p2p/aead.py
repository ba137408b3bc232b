"""X25519 (RFC 7748) and ChaCha20-Poly1305 (RFC 8439) for the mesh's
handshake and frames.

X25519 is the Montgomery ladder over p = 2²⁵⁵ − 19 in plain Python: the
scalar clamped, u's top bit masked and u taken mod p, as RFC 7748 says.
`x25519` raises ValueError on an all-zero shared secret (a small-order
peer key), as OpenSSL does, so the handshake fails there too.

ChaCha20 runs its blocks side by side in numpy (one uint32 lane a block:
a 64 kB frame is 1,025 lanes of the same 80 quarter-round steps);
Poly1305 is plain Python integers.  `ChaCha20Poly1305` has the
encrypt/decrypt interface of `cryptography`'s class of that name;
`decrypt` raises `InvalidTag` on a forged or damaged frame.
"""

from __future__ import annotations

import hmac
import secrets
import struct

import numpy as np

P = 2**255 - 19
_A24 = 121665


class InvalidTag(ValueError):
    """The Poly1305 tag does not authenticate the ciphertext."""


# ---------------------------------------------------------------------------
# X25519
# ---------------------------------------------------------------------------

def x25519(k: bytes, u: bytes) -> bytes:
    """The 32-byte u-coordinate of [clamp(k)]u; ValueError on wrong
    lengths or an all-zero result."""
    if len(k) != 32 or len(u) != 32:
        raise ValueError("X25519 keys are 32 bytes")
    n = int.from_bytes(k, "little")
    n &= (1 << 254) - 8
    n |= 1 << 254
    x1 = (int.from_bytes(u, "little") & ((1 << 255) - 1)) % P
    x2, z2, x3, z3, swap = 1, 0, x1, 1, 0
    for t in range(254, -1, -1):
        bit = (n >> t) & 1
        if swap ^ bit:
            x2, x3, z2, z3 = x3, x2, z3, z2
        swap = bit
        a = x2 + z2
        aa = a * a % P
        b = x2 - z2
        bb = b * b % P
        e = aa - bb
        c = x3 + z3
        d = x3 - z3
        da = d * a % P
        cb = c * b % P
        x3 = (da + cb) * (da + cb) % P
        z3 = x1 * (da - cb) * (da - cb) % P
        x2 = aa * bb % P
        z2 = e * (aa + _A24 * e) % P
    if swap:
        x2, z2 = x3, z3
    out = x2 * pow(z2, P - 2, P) % P
    if out == 0:
        raise ValueError("X25519: all-zero shared secret")
    return out.to_bytes(32, "little")


_NINE = (9).to_bytes(32, "little")


def x25519_public(k: bytes) -> bytes:
    """The public key of the private scalar bytes `k`."""
    return x25519(k, _NINE)


def x25519_generate() -> tuple[bytes, bytes]:
    """A fresh ephemeral pair (private, public)."""
    k = secrets.token_bytes(32)
    return k, x25519_public(k)


# ---------------------------------------------------------------------------
# ChaCha20
# ---------------------------------------------------------------------------

_SIGMA = np.frombuffer(b"expand 32-byte k", "<u4").astype(np.uint32)


def _rotl(v: np.ndarray, n: int) -> np.ndarray:
    return (v << np.uint32(n)) | (v >> np.uint32(32 - n))


def _rounds(a, b, c, d) -> None:
    """One quarter-round over four [4, blocks] rows, in place."""
    a += b
    d ^= a
    d[:] = _rotl(d, 16)
    c += d
    b ^= c
    b[:] = _rotl(b, 12)
    a += b
    d ^= a
    d[:] = _rotl(d, 8)
    c += d
    b ^= c
    b[:] = _rotl(b, 7)


def chacha20_blocks(key: bytes, counter: int, nonce: bytes,
                    n: int) -> bytes:
    """n keystream blocks (64 bytes each) from block `counter` on."""
    init = np.empty((16, n), np.uint32)
    init[0:4] = _SIGMA[:, None]
    init[4:12] = np.frombuffer(key, "<u4")[:, None]
    init[12] = (np.arange(n, dtype=np.uint64) + counter).astype(np.uint32)
    init[13:16] = np.frombuffer(nonce, "<u4")[:, None]
    x = init.copy()
    a, b, c, d = x[0:4], x[4:8], x[8:12], x[12:16]
    for _ in range(10):
        _rounds(a, b, c, d)
        b[:] = np.roll(b, -1, axis=0)
        c[:] = np.roll(c, -2, axis=0)
        d[:] = np.roll(d, -3, axis=0)
        _rounds(a, b, c, d)
        b[:] = np.roll(b, 1, axis=0)
        c[:] = np.roll(c, 2, axis=0)
        d[:] = np.roll(d, 3, axis=0)
    x += init
    return x.T.astype("<u4").tobytes()


def _xor(data: bytes, stream: bytes) -> bytes:
    if not data:
        return b""
    return (np.frombuffer(data, np.uint8)
            ^ np.frombuffer(stream, np.uint8, count=len(data))).tobytes()


# ---------------------------------------------------------------------------
# Poly1305 and the AEAD
# ---------------------------------------------------------------------------

_P1305 = (1 << 130) - 5
_CLAMP = 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF


def poly1305(key: bytes, msg: bytes) -> bytes:
    """The 16-byte tag of `msg` (a multiple of 16 bytes long, as the AEAD
    pads it) under the one-time `key`."""
    r = int.from_bytes(key[:16], "little") & _CLAMP
    s = int.from_bytes(key[16:32], "little")
    acc = 0
    top = 1 << 128
    fb = int.from_bytes
    for i in range(0, len(msg), 16):
        acc = (acc + fb(msg[i:i + 16], "little") + top) * r % _P1305
    return ((acc + s) & (top - 1)).to_bytes(16, "little")


def _pad16(n: int) -> bytes:
    return bytes(-n % 16)


class ChaCha20Poly1305:
    """RFC 8439 AEAD with a 32-byte key and 12-byte nonces."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = bytes(key)

    def _stream(self, nonce: bytes, nbytes: int) -> tuple[bytes, bytes]:
        if len(nonce) != 12:
            raise ValueError("Nonce must be 12 bytes")
        blocks = chacha20_blocks(self._key, 0, nonce, 1 + -(-nbytes // 64))
        return blocks[:32], blocks[64:64 + nbytes]

    @staticmethod
    def _tag(otk: bytes, aad: bytes, ct: bytes) -> bytes:
        mac = (aad + _pad16(len(aad)) + ct + _pad16(len(ct))
               + struct.pack("<QQ", len(aad), len(ct)))
        return poly1305(otk, mac)

    def encrypt(self, nonce: bytes, data: bytes,
                associated_data: bytes | None) -> bytes:
        aad = associated_data or b""
        otk, stream = self._stream(nonce, len(data))
        ct = _xor(data, stream)
        return ct + self._tag(otk, aad, ct)

    def decrypt(self, nonce: bytes, data: bytes,
                associated_data: bytes | None) -> bytes:
        if len(data) < 16:
            raise InvalidTag("ciphertext shorter than its tag")
        aad = associated_data or b""
        ct, tag = data[:-16], data[-16:]
        otk, stream = self._stream(nonce, len(ct))
        if not hmac.compare_digest(self._tag(otk, aad, ct), tag):
            raise InvalidTag("Poly1305 tag mismatch")
        return _xor(ct, stream)
