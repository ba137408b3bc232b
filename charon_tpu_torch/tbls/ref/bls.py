"""BLS signatures on BLS12-381 (eth2 layout: G1 pubkeys, G2 signatures),
pure-Python oracle path — the signing half of the JAX package's
tbls/ref/bls.py (verification needs the pairing, which comes with the
verify slice)."""

from __future__ import annotations

from . import curve as c
from .curve import Point
from .hash_to_curve import DST_G2, hash_to_g2


def sk_to_pk(sk: int) -> Point:
    return c.multiply(c.G1_GEN, sk)


def sign(sk: int, msg: bytes, dst: bytes = DST_G2) -> Point:
    return c.multiply(hash_to_g2(msg, dst), sk)
