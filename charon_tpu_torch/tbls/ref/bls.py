"""BLS signatures on BLS12-381 (eth2 layout: G1 pubkeys, G2 signatures),
pure-Python oracle path — a copy of the JAX package's tbls/ref/bls.py:
keys, signing, verifying, aggregates and proofs of possession."""

from __future__ import annotations

import hashlib
import secrets

from . import curve as c
from .curve import Point
from .fields import R
from .hash_to_curve import DST_G2, DST_POP_G2, hash_to_g2


def keygen(seed: bytes | None = None) -> int:
    """A secret key: from OS entropy, or with a seed from an HKDF-style
    expand, so key generation is deterministic for tests (not the EIP-2333
    tree, which is out of scope for the DV middleware)."""
    if seed is None:
        while True:
            sk = secrets.randbelow(R)
            if sk:
                return sk
    salt = b"charon-tpu-keygen"
    counter = 0
    while True:
        okm = hashlib.sha256(salt + seed + counter.to_bytes(4, "big")).digest()
        okm += hashlib.sha256(okm + salt + b"\x01").digest()
        sk = int.from_bytes(okm[:48], "big") % R
        if sk:
            return sk
        counter += 1


def sk_to_pk(sk: int) -> Point:
    return c.multiply(c.G1_GEN, sk)


def sign(sk: int, msg: bytes, dst: bytes = DST_G2) -> Point:
    return c.multiply(hash_to_g2(msg, dst), sk)


def verify(pk: Point, msg: bytes, sig: Point, dst: bytes = DST_G2) -> bool:
    """e(−g1, sig) · e(pk, H(msg)) == 1, with subgroup membership implied
    by deserialisation (points passed in memory are assumed checked)."""
    from .pairing import multi_pairing_is_one

    if pk is None or sig is None:
        return False
    return multi_pairing_is_one([
        (c.neg(c.G1_GEN), sig),
        (pk, hash_to_g2(msg, dst)),
    ])


def aggregate_signatures(sigs: list[Point]) -> Point:
    acc = None
    for s in sigs:
        acc = c.add(acc, s)
    return acc


def aggregate_pubkeys(pks: list[Point]) -> Point:
    acc = None
    for p in pks:
        acc = c.add(acc, p)
    return acc


def verify_aggregate(pks: list[Point], msg: bytes, sig: Point,
                     dst: bytes = DST_G2) -> bool:
    """Every key in `pks` signed the same msg."""
    return verify(aggregate_pubkeys(pks), msg, sig, dst)


def pop_prove(sk: int) -> Point:
    """Proof of possession: the key's own pubkey bytes signed under the
    POP DST."""
    pk_bytes = c.g1_to_bytes(sk_to_pk(sk))
    return c.multiply(hash_to_g2(pk_bytes, DST_POP_G2), sk)


def pop_verify(pk: Point, proof: Point) -> bool:
    from .pairing import multi_pairing_is_one

    if pk is None or proof is None:
        return False
    return multi_pairing_is_one([
        (c.neg(c.G1_GEN), proof),
        (pk, hash_to_g2(c.g1_to_bytes(pk), DST_POP_G2)),
    ])
