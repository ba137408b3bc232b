"""Minimal-but-real SSZ: serialisation + hash-tree-root for the types the
duty pipeline needs.

The reference leans on fastssz codegen for hot HTR paths
(reference: go.mod:12, used e.g. by core/parsigdb/memory.go:204-210 for
dedup roots); here HTR is a small, spec-faithful host implementation
(SHA-256 merkleisation, 32-byte chunks, power-of-two padding, length
mix-in for lists/bitlists).  A copy of the JAX package's
eth2util/ssz.py: the roots must stay byte-identical to it.

Supported types: uint8/16/32/64/256, ByteVector(n), ByteList(limit),
Bitlist(limit), Vector, List, Container — the subset covering attestation
data, checkpoints, deposits, exits, registrations and cluster hashing.
"""

from __future__ import annotations

import hashlib
from typing import Any

_ZERO_CHUNK = bytes(32)
_zero_hashes = [_ZERO_CHUNK]
for _ in range(64):
    _zero_hashes.append(
        hashlib.sha256(_zero_hashes[-1] + _zero_hashes[-1]).digest())


def _sha(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


def _merkleize(chunks: list[bytes], limit: int | None = None) -> bytes:
    """Merkleise chunks, virtually padded with zero chunks to `limit`
    (or to the next power of two when limit is None)."""
    count = max(len(chunks), 1)
    if limit is None:
        limit = count
    if limit < len(chunks):
        raise ValueError("chunk count exceeds limit")
    depth = max(limit - 1, 0).bit_length()
    nodes = list(chunks) or [_ZERO_CHUNK]
    for level in range(depth):
        if len(nodes) % 2:
            nodes.append(_zero_hashes[level])
        nodes = [_sha(nodes[i], nodes[i + 1]) for i in range(0, len(nodes), 2)]
    return nodes[0]


def _mix_in_length(root: bytes, length: int) -> bytes:
    return _sha(root, length.to_bytes(32, "little"))


def _pack_bytes(data: bytes) -> list[bytes]:
    if not data:
        return []
    pad = (-len(data)) % 32
    data = data + b"\x00" * pad
    return [data[i : i + 32] for i in range(0, len(data), 32)]


class SSZType:
    """Base: subclasses implement serialize() and hash_tree_root()."""

    def serialize(self, value) -> bytes:
        raise NotImplementedError

    def hash_tree_root(self, value) -> bytes:
        raise NotImplementedError

    def is_fixed_size(self) -> bool:
        return True

    def fixed_size(self) -> int:
        raise NotImplementedError


class UintN(SSZType):
    def __init__(self, bits: int):
        assert bits in (8, 16, 32, 64, 128, 256)
        self.bits = bits

    def serialize(self, value) -> bytes:
        return int(value).to_bytes(self.bits // 8, "little")

    def hash_tree_root(self, value) -> bytes:
        return _merkleize(_pack_bytes(self.serialize(value)))

    def fixed_size(self) -> int:
        return self.bits // 8


uint8 = UintN(8)
uint16 = UintN(16)
uint32 = UintN(32)
uint64 = UintN(64)
uint256 = UintN(256)


class Boolean(SSZType):
    def serialize(self, value) -> bytes:
        return b"\x01" if value else b"\x00"

    def hash_tree_root(self, value) -> bytes:
        return _merkleize(_pack_bytes(self.serialize(value)))

    def fixed_size(self) -> int:
        return 1


boolean = Boolean()


class ByteVector(SSZType):
    def __init__(self, length: int):
        self.length = length

    def serialize(self, value) -> bytes:
        b = bytes(value)
        if len(b) != self.length:
            raise ValueError(f"expected {self.length} bytes, got {len(b)}")
        return b

    def hash_tree_root(self, value) -> bytes:
        return _merkleize(_pack_bytes(self.serialize(value)))

    def fixed_size(self) -> int:
        return self.length


Bytes4 = ByteVector(4)
Bytes20 = ByteVector(20)
Bytes32 = ByteVector(32)
Bytes48 = ByteVector(48)
Bytes96 = ByteVector(96)


class ByteList(SSZType):
    def __init__(self, limit: int):
        self.limit = limit

    def serialize(self, value) -> bytes:
        b = bytes(value)
        if len(b) > self.limit:
            raise ValueError("byte list exceeds limit")
        return b

    def is_fixed_size(self) -> bool:
        return False

    def hash_tree_root(self, value) -> bytes:
        b = self.serialize(value)
        root = _merkleize(_pack_bytes(b), (self.limit + 31) // 32)
        return _mix_in_length(root, len(b))


class Bitlist(SSZType):
    """Value is a (bits: bytes, bit_length: int) pair or a list[bool]."""

    def __init__(self, limit: int):
        self.limit = limit

    @staticmethod
    def from_bools(bools) -> tuple[bytes, int]:
        n = len(bools)
        out = bytearray((n // 8) + 1)
        for i, bit in enumerate(bools):
            if bit:
                out[i // 8] |= 1 << (i % 8)
        return bytes(out), n

    @staticmethod
    def to_bools(value) -> list[bool]:
        data, n = Bitlist._normalise(value)
        return [bool(data[i // 8] >> (i % 8) & 1) for i in range(n)]

    @staticmethod
    def _normalise(value) -> tuple[bytes, int]:
        if isinstance(value, tuple):
            return value
        return Bitlist.from_bools(list(value))

    @staticmethod
    def to_ssz_bytes(value) -> bytes:
        """SSZ wire form with delimiter bit (the beacon-API hex payload)."""
        data, n = Bitlist._normalise(value)
        out = bytearray(data[: n // 8 + 1])
        while len(out) < n // 8 + 1:
            out.append(0)
        out[n // 8] |= 1 << (n % 8)
        return bytes(out)

    @staticmethod
    def from_ssz_bytes(raw: bytes) -> tuple[bytes, int]:
        """Inverse of to_ssz_bytes: strip the delimiter bit."""
        if not raw or raw[-1] == 0:
            raise ValueError("bitlist missing delimiter bit")
        top = raw[-1].bit_length() - 1  # delimiter position in last byte
        n = (len(raw) - 1) * 8 + top
        data = bytearray(raw)
        data[-1] &= (1 << top) - 1  # clear the delimiter
        payload = bytes(data[: n // 8 + 1]) if n else b"\x00"
        return payload, n

    def serialize(self, value) -> bytes:
        data, n = self._normalise(value)
        out = bytearray(data[: n // 8 + 1])
        while len(out) < n // 8 + 1:
            out.append(0)
        out[n // 8] |= 1 << (n % 8)  # delimiter bit
        return bytes(out)

    def is_fixed_size(self) -> bool:
        return False

    def hash_tree_root(self, value) -> bytes:
        data, n = self._normalise(value)
        if n > self.limit:
            raise ValueError("bitlist exceeds limit")
        nbytes = (n + 7) // 8
        payload = bytes(data[:nbytes])
        if n % 8:  # clear bits above length
            mask = (1 << (n % 8)) - 1
            payload = payload[:-1] + bytes([payload[-1] & mask])
        root = _merkleize(_pack_bytes(payload), (self.limit + 255) // 256)
        return _mix_in_length(root, n)


class Vector(SSZType):
    def __init__(self, elem: SSZType, length: int):
        self.elem = elem
        self.length = length

    def serialize(self, value) -> bytes:
        if len(value) != self.length:
            raise ValueError("vector length mismatch")
        return b"".join(self.elem.serialize(v) for v in value)

    def is_fixed_size(self) -> bool:
        return self.elem.is_fixed_size()

    def fixed_size(self) -> int:
        return self.length * self.elem.fixed_size()

    def hash_tree_root(self, value) -> bytes:
        if isinstance(self.elem, UintN):
            return _merkleize(_pack_bytes(self.serialize(value)))
        return _merkleize([self.elem.hash_tree_root(v) for v in value])


class List(SSZType):
    def __init__(self, elem: SSZType, limit: int):
        self.elem = elem
        self.limit = limit

    def serialize(self, value) -> bytes:
        if len(value) > self.limit:
            raise ValueError("list exceeds limit")
        if self.elem.is_fixed_size():
            return b"".join(self.elem.serialize(v) for v in value)
        parts = [self.elem.serialize(v) for v in value]
        offset = 4 * len(parts)
        head, body = b"", b""
        for part in parts:
            head += offset.to_bytes(4, "little")
            body += part
            offset += len(part)
        return head + body

    def is_fixed_size(self) -> bool:
        return False

    def hash_tree_root(self, value) -> bytes:
        if isinstance(self.elem, UintN):
            per_chunk = 32 // self.elem.fixed_size()
            limit = (self.limit + per_chunk - 1) // per_chunk
            root = _merkleize(_pack_bytes(self.serialize(value)), limit)
        else:
            root = _merkleize([self.elem.hash_tree_root(v) for v in value],
                              self.limit)
        return _mix_in_length(root, len(value))


class Container(SSZType):
    """Field spec: [(name, SSZType)].  Values may be dataclasses, dicts, or
    objects with matching attributes."""

    def __init__(self, fields: list[tuple[str, SSZType]]):
        self.fields = fields

    @staticmethod
    def _get(value, name: str):
        if isinstance(value, dict):
            return value[name]
        return getattr(value, name)

    def serialize(self, value) -> bytes:
        fixed_parts, var_parts = [], []
        for name, typ in self.fields:
            v = self._get(value, name)
            if typ.is_fixed_size():
                fixed_parts.append(typ.serialize(v))
                var_parts.append(None)
            else:
                fixed_parts.append(None)
                var_parts.append(typ.serialize(v))
        fixed_len = sum(len(p) if p is not None else 4 for p in fixed_parts)
        head, body = b"", b""
        offset = fixed_len
        for fpart, vpart in zip(fixed_parts, var_parts):
            if fpart is not None:
                head += fpart
            else:
                head += offset.to_bytes(4, "little")
                body += vpart
                offset += len(vpart)
        return head + body

    def is_fixed_size(self) -> bool:
        return all(t.is_fixed_size() for _, t in self.fields)

    def fixed_size(self) -> int:
        return sum(t.fixed_size() for _, t in self.fields)

    def hash_tree_root(self, value) -> bytes:
        return _merkleize(
            [typ.hash_tree_root(self._get(value, name))
             for name, typ in self.fields])


def hash_tree_root(typ: SSZType, value: Any) -> bytes:
    return typ.hash_tree_root(value)
