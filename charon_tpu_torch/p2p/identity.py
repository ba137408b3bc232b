"""Per-node asymmetric identity keys.

The reference gives every node a secp256k1 ENR key used for three things:
p2p channel identity (libp2p/noise), ENR records in the cluster definition,
and per-message ECDSA signatures on consensus messages
(reference: p2p/k1.go, p2p/enr.go, core/consensus/component.go:343-353).

Here the identity is Ed25519 (signing) with handshake confidentiality from
ephemeral X25519 (see transport.py).  The pubkey is pinned in the cluster
definition's operator ENR field as `ed25519:<hex>`, so a malicious insider
cannot forge another member's frames or consensus messages — restoring the
⌊(n−1)/3⌋ byzantine tolerance QBFT assumes.

The JAX package's p2p/identity.py over the port's own Ed25519
(`p2p/ed25519.py`) in place of `cryptography`'s: the same keys, ENRs and
signature bytes, and the same verdicts.
"""

from __future__ import annotations

import hashlib
import secrets

from . import ed25519

ENR_PREFIX = "ed25519:"


class NodeIdentity:
    """An Ed25519 identity keypair for one cluster node."""

    def __init__(self, priv32: bytes):
        self._priv = bytes(priv32)
        self.pubkey: bytes = ed25519.public_key(self._priv)

    @classmethod
    def generate(cls, seed: bytes | None = None) -> "NodeIdentity":
        """Fresh identity; with `seed`, deterministic (tests/fixtures only)."""
        if seed is None:
            return cls(secrets.token_bytes(32))
        return cls(hashlib.sha256(b"charon-tpu-identity" + seed).digest())

    @classmethod
    def from_bytes(cls, priv32: bytes) -> "NodeIdentity":
        if len(priv32) != 32:
            raise ValueError("an Ed25519 private key is 32 bytes")
        return cls(priv32)

    def to_bytes(self) -> bytes:
        return self._priv

    def sign(self, data: bytes) -> bytes:
        return ed25519.sign(self._priv, data, self.pubkey)

    def enr(self, host: str = "", port: int = 0) -> str:
        """ENR-equivalent record: identity pubkey + optional endpoint
        (the reference packs ip/tcp/secp256k1 fields into an ENR;
        p2p/enr.go)."""
        rec = ENR_PREFIX + self.pubkey.hex()
        if host:
            rec += f"@{host}:{port}"
        return rec


def verify(pubkey32: bytes, sig: bytes, data: bytes) -> bool:
    return ed25519.verify(pubkey32, sig, data)


def enr_parse(enr: str) -> tuple[bytes, str, int]:
    """`ed25519:<hex>[@host:port]` → (pubkey, host, port)."""
    if not enr.startswith(ENR_PREFIX):
        raise ValueError(f"not a charon-tpu ENR: {enr[:16]!r}")
    rest = enr[len(ENR_PREFIX):]
    host, port = "", 0
    if "@" in rest:
        rest, _, ep = rest.partition("@")
        h, _, p = ep.rpartition(":")
        host, port = h, int(p)
    pub = bytes.fromhex(rest)
    if len(pub) != 32:
        raise ValueError("bad identity pubkey length")
    return pub, host, port
