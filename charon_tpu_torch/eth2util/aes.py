"""AES-128 encryption (FIPS-197) and CTR mode, for EIP-2335 keystores.

Only the forward cipher is needed: CTR decrypts by encrypting the same
counter blocks.  The S-box is derived, not typed: each byte's inverse in
GF(2⁸) modulo x⁸ + x⁴ + x³ + x + 1 (0 ↦ 0), then FIPS-197's affine map
b ⊕ rotl(b, 1..4) ⊕ 0x63.  The counter is the whole 16-byte block read
as one big-endian integer, incremented modulo 2¹²⁸ (the convention of
OpenSSL's CTR mode, which the JAX package's keystores use).
"""

from __future__ import annotations


def _xtime(b: int) -> int:
    b <<= 1
    return (b ^ 0x11B) if b & 0x100 else b


def _make_sbox() -> bytes:
    # 3 generates GF(2⁸)*: inverses from its power (exp) and log tables
    exp, log = [0] * 255, [0] * 256
    x = 1
    for i in range(255):
        exp[i], log[x] = x, i
        x ^= _xtime(x)          # x · 3
    inv = [0] + [exp[-log[a] % 255] for a in range(1, 256)]
    box = []
    for x in inv:
        s = x
        for k in range(1, 5):
            s ^= ((x << k) | (x >> (8 - k))) & 0xFF
        box.append(s ^ 0x63)
    return bytes(box)


SBOX = _make_sbox()
_X2 = bytes(_xtime(b) for b in range(256))


def expand_key(key: bytes) -> list[list[int]]:
    """The 11 round keys of a 16-byte key, 16 bytes each."""
    if len(key) != 16:
        raise ValueError("AES-128 key must be 16 bytes")
    words = [list(key[i:i + 4]) for i in range(0, 16, 4)]
    rcon = 1
    for i in range(4, 44):
        w = list(words[i - 1])
        if i % 4 == 0:
            w = [SBOX[b] for b in w[1:] + w[:1]]
            w[0] ^= rcon
            rcon = _xtime(rcon)
        words.append([x ^ y for x, y in zip(words[i - 4], w)])
    return [sum(words[4 * r:4 * r + 4], []) for r in range(11)]


def encrypt_block(round_keys: list[list[int]], block: bytes) -> bytes:
    """One 16-byte block under the expanded key (state column-major)."""
    s = [b ^ k for b, k in zip(block, round_keys[0])]
    for r in range(1, 11):
        s = [SBOX[b] for b in s]
        # ShiftRows: row i of column c comes from column c + i
        s = [s[(4 * (c + i) + i) % 16] for c in range(4) for i in range(4)]
        if r < 10:
            out = []
            for c in range(4):
                a0, a1, a2, a3 = s[4 * c:4 * c + 4]
                t = a0 ^ a1 ^ a2 ^ a3
                out += [a0 ^ t ^ _X2[a0 ^ a1], a1 ^ t ^ _X2[a1 ^ a2],
                        a2 ^ t ^ _X2[a2 ^ a3], a3 ^ t ^ _X2[a3 ^ a0]]
            s = out
        s = [b ^ k for b, k in zip(s, round_keys[r])]
    return bytes(s)


def ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    """AES-128-CTR of `data` (encryption and decryption alike)."""
    if len(iv) != 16:
        raise ValueError("CTR initial counter block must be 16 bytes")
    rk = expand_key(key)
    ctr0 = int.from_bytes(iv, "big")
    out = bytearray()
    for i in range(0, len(data), 16):
        block = ((ctr0 + i // 16) % (1 << 128)).to_bytes(16, "big")
        ks = encrypt_block(rk, block)
        out += bytes(x ^ y for x, y in zip(data[i:i + 16], ks))
    return bytes(out)
