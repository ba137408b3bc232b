"""BLS signatures on BLS12-381 (eth2 layout: G1 pubkeys, G2 signatures),
pure-Python oracle path — the signing and verifying part of the JAX
package's tbls/ref/bls.py."""

from __future__ import annotations

from . import curve as c
from .curve import Point
from .hash_to_curve import DST_G2, hash_to_g2


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
