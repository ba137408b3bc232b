"""Shamir secret sharing and Lagrange interpolation over the BLS12-381
scalar field Fr — backend-independent integer math.

Reference analogue: kryptology `sharing` consumed by tbls/tss.go:220-290
(SplitSecret / CombineShares) and the Lagrange combination inside
Aggregate (tbls/tss.go:142-149).
"""

from __future__ import annotations

import secrets

from .ref.fields import R


def split_secret(secret: int, threshold: int, num_shares: int,
                 rng=None) -> tuple[dict[int, int], list[int]]:
    """t-of-n split.  Returns ({share_index: share}, polynomial coefficients).

    Share indices are 1-based (index 0 would leak the secret).  The returned
    coefficients allow callers to build Feldman verification commitments
    a_j·G1 (reference: tbls/tss.go:62-116 derives pubshares from them).
    """
    if not 1 <= threshold <= num_shares:
        raise ValueError(f"invalid threshold {threshold} of {num_shares}")
    randbelow = rng.randrange if rng is not None else (
        lambda n: secrets.randbelow(n))
    coeffs = [secret % R] + [randbelow(R) for _ in range(threshold - 1)]
    shares = {i: _eval_poly(coeffs, i) for i in range(1, num_shares + 1)}
    return shares, coeffs


def _eval_poly(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


def lagrange_coeffs_at_zero(indices: list[int]) -> dict[int, int]:
    """λ_i = Π_{j≠i} j/(j−i) mod r, so f(0) = Σ λ_i f(i)."""
    if len(set(indices)) != len(indices):
        raise ValueError("duplicate share indices")
    out = {}
    for i in indices:
        num, den = 1, 1
        for j in indices:
            if j == i:
                continue
            num = num * j % R
            den = den * (j - i) % R
        out[i] = num * pow(den, -1, R) % R
    return out



def combine_shares(shares: dict[int, int]) -> int:
    """Recover the secret from ≥ t shares (the caller supplies exactly the
    shares to use)."""
    lam = lagrange_coeffs_at_zero(list(shares))
    return sum(lam[i] * s for i, s in shares.items()) % R
