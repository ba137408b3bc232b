"""The op library's last functions — ops/fp.py (`pack`, `sqr_many`,
`to_mont`, `from_mont`), ops/tower.py (`f6_sqr`, `f6_mul_by_01_many`,
`f6_mul_by_1`, `f6_select`, `f2_unpack`) and ops/curve.py (`inf_point`,
`on_curve`, `sum_points`, `msm`, `g1_unpack`, `g2_unpack`) — against the
JAX package's, bit for bit on seeded inputs (the port's layout through
convert.py), and `multichip.entry()`'s step against the oracle.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.ops import curve as jcurve
from charon_tpu.ops import fp as jfp
from charon_tpu.ops import tower as jtower
from charon_tpu_torch import convert, multichip
from charon_tpu_torch.ops import curve as tcurve
from charon_tpu_torch.ops import fp as tfp
from charon_tpu_torch.ops import tower as ttower
from charon_tpu_torch.tbls import shamir
from charon_tpu_torch.tbls.ref import curve as refcurve

N = 16
LMAX = jfp.LMAX


def _limbs(shape, seed):
    """Random redundant limbs [N, *shape] in [0, LMAX] (JAX's layout)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, LMAX + 1, (N,) + shape, dtype=np.int32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(convert.elems_from_jax(np.asarray(a)))


def _same(port: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(convert.elems_to_jax(port.numpy()),
                                  np.asarray(ref))


def _jax(fn, *args):
    """A JAX function of arrays, jitted: one XLA compile of the whole,
    which costs less than its ops dispatched one by one."""
    return jax.jit(fn)(*[jnp.asarray(a) for a in args])


def _values(xs) -> list:
    """Oracle points or field elements (either package's classes) → ints."""
    def val(e):
        return (e.n,) if hasattr(e, "n") else tuple(e.coeffs)

    return [None if p is None else
            (tuple(val(c) for c in p) if isinstance(p, tuple) else val(p))
            for p in xs]


@pytest.mark.parametrize("fn", ["pack", "sqr_many", "to_mont", "from_mont"])
def test_fp_functions_bit_identical(fn):
    rng = np.random.default_rng(1)
    if fn == "pack":
        xs = [0, 1, jfp.P - 1, jfp.P, jfp.P + 5, 2 * jfp.P + 7] + [
            int.from_bytes(rng.bytes(56), "big") for _ in range(10)]
        np.testing.assert_array_equal(tfp.pack(xs).T, jfp.pack(xs))
        return
    a, b = _limbs((32,), 2), _limbs((32,), 3)
    if fn == "sqr_many":
        got = tfp.sqr_many([_t(a), _t(b)])
        want = jfp.sqr_many([jnp.asarray(a), jnp.asarray(b)])
        for g, w in zip(got, want, strict=True):
            _same(g, w)
        return
    _same(getattr(tfp, fn)(_t(a)), getattr(jfp, fn)(jnp.asarray(a)))


@pytest.mark.parametrize("fn", ["f6_sqr", "f6_mul_by_01_many", "f6_mul_by_1",
                                "f6_select", "f2_unpack"])
def test_tower_functions_bit_identical(fn):
    a, b = _limbs((3, 2, 32), 4), _limbs((3, 2, 32), 5)
    d0, d1 = _limbs((2, 32), 6), _limbs((2, 32), 7)
    if fn == "f6_sqr":
        _same(ttower.f6_sqr(_t(a)), _jax(jtower.f6_sqr, a))
    elif fn == "f6_mul_by_01_many":
        got = ttower.f6_mul_by_01_many([(_t(a), _t(d0), _t(d1)),
                                        (_t(b), _t(d1), _t(d0))])
        want = _jax(lambda a, b, d0, d1: jtower.f6_mul_by_01_many(
            [(a, d0, d1), (b, d1, d0)]), a, b, d0, d1)
        for g, w in zip(got, want, strict=True):
            _same(g, w)
        _same(ttower.f6_mul_by_01(_t(a), _t(d0), _t(d1)), want[0])
    elif fn == "f6_mul_by_1":
        _same(ttower.f6_mul_by_1(_t(a), _t(d1)),
              _jax(jtower.f6_mul_by_1, a, d1))
    elif fn == "f6_select":
        cond = np.random.default_rng(8).integers(0, 2, N).astype(bool)
        _same(ttower.f6_select(torch.from_numpy(cond), _t(a), _t(b)),
              jtower.f6_select(jnp.asarray(cond), jnp.asarray(a),
                               jnp.asarray(b)))
    else:
        assert _values(ttower.f2_unpack(_t(d0))) \
            == _values(jtower.f2_unpack(d0))


def _doubled(F, pts: np.ndarray) -> np.ndarray:
    """JAX-layout points → their doubles (Z ≠ 1), by the port's plain
    doubling (the inputs only)."""
    return convert.elems_to_jax(tcurve.double_point(F, _t(pts)).numpy())


def _g2_points(seed: int) -> np.ndarray:
    """JAX-layout projective G2 points [N, 3, 2, 32]: affine points, their
    doubles and ∞."""
    rng = np.random.default_rng(seed)
    aff = jcurve.g2_pack([refcurve.multiply(refcurve.G2_GEN,
                                            int(rng.integers(2, 1 << 30)))
                          for _ in range(N // 2 - 1)] + [None])
    return np.concatenate([aff, _doubled(tcurve.F2_OPS, aff)])


@pytest.mark.parametrize("fn", ["inf_point", "on_curve", "sum_points", "msm",
                                "g1_unpack", "g2_unpack"])
def test_curve_functions_bit_identical(fn):
    F2J, F2T = jcurve.F2_OPS, tcurve.F2_OPS
    if fn == "inf_point":
        for shape in ((), (5,), (2, 5)):
            got = tcurve.inf_point(F2T, shape).numpy()
            want = np.asarray(jcurve.inf_point(F2J, shape))
            # the port's rows are its last axis (one row for no batch)
            got = (np.moveaxis(got, -1, len(shape) - 1) if shape
                   else got[..., 0])
            np.testing.assert_array_equal(got, want)
        g1 = tcurve.inf_point(tcurve.FP_OPS, (3,)).numpy()
        np.testing.assert_array_equal(
            np.moveaxis(g1, -1, 0),
            np.asarray(jcurve.inf_point(jcurve.FP_OPS, (3,))))
    elif fn == "on_curve":
        pts = _g2_points(9)
        bad = pts.copy()
        bad[:4, 1, 0, 0] += 1                     # y off the curve
        for p in (pts, bad):
            np.testing.assert_array_equal(
                tcurve.on_curve(F2T, _t(p)).numpy(),
                np.asarray(_jax(lambda q: jcurve.on_curve(F2J, q), p)))
        assert tcurve.on_curve(F2T, _t(pts)).all()
        assert not tcurve.on_curve(F2T, _t(bad))[:4].any()
    elif fn == "sum_points":
        # [V = 2, 5 points, ...]: the tree carries the odd point twice
        pts = _g2_points(10)[:10].reshape(2, 5, 3, 2, 32)
        want = _jax(lambda p: jcurve.sum_points(F2J, p, axis=1), pts)
        got = tcurve.sum_points(F2T, torch.from_numpy(
            np.moveaxis(pts, 0, -1).copy()), axis=0)
        _same(got, want)
    elif fn == "msm":
        # [V = 2, T = 3] points with 7-bit scalars (an odd width: a zero
        # bit in front)
        pts = _g2_points(11)[:6].reshape(2, 3, 3, 2, 32)
        bits = np.random.default_rng(12).integers(
            0, 2, (2, 3, 7)).astype(np.int32)
        want = _jax(lambda p, b: jcurve.msm(F2J, p, b, axis=1), pts, bits)
        got = tcurve.msm(F2T, torch.from_numpy(
            np.moveaxis(pts, 0, -1).copy()), torch.from_numpy(
            np.ascontiguousarray(bits.transpose(2, 1, 0))), axis=0)
        _same(got, want)
    elif fn == "g1_unpack":
        rng = np.random.default_rng(13)
        pts = [refcurve.multiply(refcurve.G1_GEN, int(rng.integers(2, 999)))
               for _ in range(5)] + [None]
        j = jcurve.g1_pack(pts)
        for p in (j, _doubled(tcurve.FP_OPS, j)):      # Z = 1, Z ≠ 1
            assert _values(tcurve.g1_unpack(_t(p))) \
                == _values(jcurve.g1_unpack(jnp.asarray(p)))
        assert _values(tcurve.g1_unpack(_t(j))) == _values(pts)
    else:
        p = _g2_points(14)
        assert _values(tcurve.g2_unpack(_t(p))) \
            == _values(jcurve.g2_unpack(jnp.asarray(p)))


def test_entry_step_equals_the_oracle():
    """`multichip.entry()`'s combine step (the JAX entry's: 4 validators'
    partials (7 + v + t)·G2 for shares 1..3) through the port's msm."""
    fn, (pts, bits) = multichip.entry("cpu")
    assert tuple(pts.shape) == (3, 3, 2, 32, 4)
    assert tuple(bits.shape) == (256, 3, 4)
    lam = shamir.lagrange_coeffs_at_zero([1, 2, 3])
    want = []
    for v in range(4):
        acc = None
        for t in range(3):
            acc = refcurve.add(acc, refcurve.multiply(
                refcurve.G2_GEN, (7 + v + t) * lam[t + 1]))
        want.append(acc)
    assert tcurve.g2_unpack(fn(pts, bits)) == want
