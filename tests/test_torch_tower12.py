"""The port's Fp6/Fp12 tower (charon_tpu_torch.ops.tower) against the JAX
package's ops/tower.py, bit for bit: f6_mul, f12_mul, f12_sqr,
f12_mul_by_014, f12_conj, f12_frob, f12_inv and f12_eq, on seeded random
limbs and on all-LMAX limbs (every op is defined, and bit-identical, for
any redundant residues).  Also the oracle packing round trip and the
Frobenius constants.
"""

import numpy as np
import pytest
import torch

import jax

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.ops import fp as jfp
from charon_tpu.ops import tower as jtower
from charon_tpu.tbls.ref.fields import FQ12
from charon_tpu_torch import convert
from charon_tpu_torch.ops import tower as ttower

ROWS = 8


def _limbs(shape: tuple, seed: int, pattern: str) -> np.ndarray:
    """[ROWS, *shape] limbs, JAX (rows-first, limb-last) layout."""
    if pattern == "lmax":
        return np.full((ROWS,) + shape, jfp.LMAX, np.int32)
    rng = np.random.default_rng(seed)
    return rng.integers(0, jfp.LMAX + 1, (ROWS,) + shape, dtype=np.int32)


F6, F12, F2 = (3, 2, 32), (2, 3, 2, 32), (2, 32)


def _port(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(convert.elems_from_jax(a))


def _same(port: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(convert.elems_to_jax(port.numpy()),
                                  np.asarray(want))


@pytest.mark.parametrize("pattern", ["random", "lmax"])
def test_f6_mul(pattern):
    a, b = _limbs(F6, 1, pattern), _limbs(F6, 2, pattern)
    _same(ttower.f6_mul(_port(a), _port(b)), jax.jit(jtower.f6_mul)(a, b))


@pytest.mark.parametrize("pattern", ["random", "lmax"])
def test_f12_mul(pattern):
    a, b = _limbs(F12, 3, pattern), _limbs(F12, 4, pattern)
    _same(ttower.f12_mul(_port(a), _port(b)), jax.jit(jtower.f12_mul)(a, b))


@pytest.mark.parametrize("pattern", ["random", "lmax"])
def test_f12_sqr(pattern):
    a = _limbs(F12, 5, pattern)
    _same(ttower.f12_sqr(_port(a)), jax.jit(jtower.f12_sqr)(a))


@pytest.mark.parametrize("pattern", ["random", "lmax"])
def test_f12_mul_by_014(pattern):
    a = _limbs(F12, 6, pattern)
    c0, c1, c4 = (_limbs(F2, 7 + k, pattern) for k in range(3))
    _same(ttower.f12_mul_by_014(_port(a), _port(c0), _port(c1), _port(c4)),
          jax.jit(jtower.f12_mul_by_014)(a, c0, c1, c4))


@pytest.mark.parametrize("pattern", ["random", "lmax"])
def test_f12_conj_and_frob(pattern):
    a = _limbs(F12, 10, pattern)
    _same(ttower.f12_conj(_port(a)), jax.jit(jtower.f12_conj)(a))
    _same(ttower.f12_frob(_port(a)), jax.jit(jtower.f12_frob)(a))


def test_f12_inv():
    a = _limbs(F12, 11, "random")
    got = ttower.f12_inv(_port(a))
    _same(got, jax.jit(jtower.f12_inv)(a))
    one = ttower.f12_mul(got, _port(a))
    assert ttower.f12_eq(one, torch.from_numpy(
        np.ascontiguousarray(np.broadcast_to(
            ttower.F12_ONE[..., None], ttower.F12_ONE.shape + (ROWS,))))
    ).all()


def test_f12_eq():
    a = _limbs(F12, 12, "random")
    b = a.copy()
    b[1::2, 1, 2, 0, 5] += 1                        # odd rows differ
    # row 0: the same value in another representative (limb 0 + p's low
    # limbs would overflow; adding p as a whole is exact in 12-bit limbs
    # only after a carry, so take the JAX canonical form instead)
    canon = np.asarray(jax.jit(jfp.canon_std)(a.reshape(-1, 32))).reshape(
        a.shape)
    for x, y in ((a, b), (a, canon)):
        got = ttower.f12_eq(_port(x), _port(y)).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            jax.jit(jtower.f12_eq)(x, y)))
    assert ttower.f12_eq(_port(a), _port(canon)).all()
    assert not ttower.f12_eq(_port(a), _port(b)).numpy()[1::2].any()


def test_oracle_packing_and_frobenius_constants():
    rng = np.random.default_rng(13)
    from charon_tpu.tbls.ref.fields import P
    xs = [FQ12([int(v) for v in rng.integers(0, 2**62, 12)]) for _ in range(3)]
    xs[0] = FQ12([P - 1 - k for k in range(12)])
    packed = ttower.f12_pack(xs)
    np.testing.assert_array_equal(convert.elems_to_jax(packed),
                                  jtower.f12_pack(xs))
    assert [list(u.coeffs) for u in ttower.f12_unpack(packed)] == \
        [[c % P for c in x.coeffs] for x in xs]
    for name in ("FROB_G1", "FROB_G2", "FROB_GW"):
        np.testing.assert_array_equal(getattr(ttower, name),
                                      getattr(jtower, name))
    np.testing.assert_array_equal(ttower.F12_ONE, jtower.F12_ONE_M)
