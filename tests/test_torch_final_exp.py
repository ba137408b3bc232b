"""Kernel K11's plain version (charon_tpu_torch.ops.cuda_final_exp.
final_exp_plain) against the JAX package's ops/pairing.final_exponentiate
and the port's plain tower copy, by value (the canonical form of all 12
coefficients: the K5 tower reduces in another order, so the residues
differ bit for bit), on random Fp12 rows and on Miller rows of real pairs,
where e(P, Q)·e(−P, Q) must be one.  The lane split's stages against the
sequential K5 bodies bit for bit; the wrapper's CPU route; the re-check's
final exponentiation through the wrapper.  K11's verdict "= 1" (on the
card the kernel's lanes 0–11 test f − 1's coefficients; on the CPU
`pairing.is_one` of the plain result) against the JAX package's
`f12_eq(final_exponentiate(f), 1)` on products that are one and rows
that are not.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.ops import fp as jfp
from charon_tpu.ops import pairing as jpair
from charon_tpu.ops import tower as jtower
from charon_tpu.tbls.ref import curve as refcurve
from charon_tpu_torch import convert
from charon_tpu_torch.ops import cuda_final_exp as cfe
from charon_tpu_torch.ops import cuda_pairing as cp
from charon_tpu_torch.ops import curve as tcurve
from charon_tpu_torch.ops import fp as tfp
from charon_tpu_torch.ops import pairing as tpair
from charon_tpu_torch.ops import tower as ttower

P1 = refcurve.multiply(refcurve.G1_GEN, 7)
Q1 = refcurve.multiply(refcurve.G2_GEN, 11)


def _canon(f: torch.Tensor) -> np.ndarray:
    """[2, 3, 2, 32, R] → canonical limbs [12, 32, R]."""
    return tfp.canon_std(f.reshape(12, 32, f.shape[-1])).numpy()


@pytest.fixture(scope="module")
def rows() -> torch.Tensor:
    """Two random Fp12 rows (one all-LMAX) and the Miller rows of (P, Q)
    and (−P, Q): [2, 3, 2, 32, 4]."""
    rng = np.random.default_rng(41)
    rand = rng.integers(0, jfp.LMAX + 1, (2, 3, 2, 32, 2), dtype=np.int32)
    rand[..., 1] = jfp.LMAX
    p = torch.from_numpy(tcurve.g1_pack([P1, refcurve.neg(P1)]))
    q = torch.from_numpy(tcurve.g2_pack([Q1, Q1]))
    miller = tpair.miller_loop(p, q)
    return torch.cat([torch.from_numpy(rand), miller], dim=-1)


@pytest.fixture(scope="module")
def plain(rows) -> torch.Tensor:
    return cfe.final_exp_plain(rows)


def test_plain_version_equals_jax_by_value(rows, plain):
    want = jax.jit(jpair.final_exponentiate)(
        jnp.asarray(convert.elems_to_jax(rows.numpy())))
    got = _canon(plain)
    ref = _canon(torch.from_numpy(convert.elems_from_jax(np.asarray(want))))
    np.testing.assert_array_equal(got, ref)


def test_plain_version_equals_the_port_tower_by_value(rows, plain):
    np.testing.assert_array_equal(
        _canon(plain), _canon(tpair.final_exponentiate(rows)))


def test_pairs_of_opposite_points_multiply_to_one(plain):
    e = plain[..., 2:]
    prod = ttower.f12_mul(e[..., :1], e[..., 1:])
    assert tpair.is_one(prod).tolist() == [True]
    assert tpair.is_one(e).tolist() == [False, False]


def _f12(seed: int, r: int = 3) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, jfp.LMAX + 1, (12, 32, r),
                                         dtype=np.int32))


@pytest.mark.parametrize("stage", ["sqr", "mul"])
def test_lane_split_stages_equal_the_k5_bodies(stage):
    """The plain version batches a squaring's 12 (a product's 18) Fp2
    products along the rows as the kernel spreads them over lanes; each
    equals the sequential K5 body bit for bit."""
    f, g = _f12(51), _f12(52)
    split = cfe._unstack(f.reshape(2, 3, 2, 32, 3))
    if stage == "sqr":
        got, want = cfe._sqr(split), cp._f12_sqr(f)
    else:
        got = cfe._mul(split, cfe._unstack(g.reshape(2, 3, 2, 32, 3)))
        want = cp._f12_mul(f, g)
    np.testing.assert_array_equal(cfe._stack(got).reshape(12, 32, 3).numpy(),
                                  want.numpy())


@pytest.mark.parametrize("op", ["frob", "conj", "inv"])
def test_unary_stages_equal_the_tower_by_value(op):
    f = _f12(53).reshape(2, 3, 2, 32, 3)
    got = cfe._stack(getattr(cfe, f"_{op}")(cfe._unstack(f)))
    want = {"frob": ttower.f12_frob, "conj": ttower.f12_conj,
            "inv": ttower.f12_inv}[op](f)
    np.testing.assert_array_equal(_canon(got), _canon(want))


def test_wrapper_takes_the_plain_path_on_the_cpu(rows, plain):
    cfe.reset_launches()
    got = cfe.final_exp(rows[..., 2:3].contiguous())
    np.testing.assert_array_equal(got.numpy(), plain[..., 2:3].numpy())
    assert cfe.LAUNCHES == {"final_exp": 0}
    with pytest.raises(ValueError):
        cfe.final_exp(rows.to("meta"))
    with pytest.raises(ValueError):
        cfe.final_exp(rows.reshape(12, 32, 4))
    with pytest.raises(TypeError):
        cfe.final_exp(rows.long())


def test_recheck_final_exponentiation_goes_through_the_wrapper(monkeypatch):
    """pairing_product_is_one's final exponentiation is K11's wrapper, one
    call over all the rows."""
    calls = []
    real = cfe.final_exp

    def spy(f):
        calls.append(tuple(f.shape))
        return real(f)

    monkeypatch.setattr(cfe, "final_exp", spy)
    ps = torch.stack([torch.from_numpy(tcurve.g1_pack([P1])),
                      torch.from_numpy(tcurve.g1_pack([refcurve.neg(P1)]))])
    q = torch.from_numpy(tcurve.g2_pack([Q1]))
    assert tpair.pairing_product_is_one(ps, torch.stack([q, q])).tolist() \
        == [True]
    assert calls == [(2, 3, 2, 32, 1)]


def test_verdict_equals_jax_is_one(rows, plain):
    """The verdict row of `final_exp_is_one` against JAX's is-one of its
    final exponentiation: one for e(P, Q)·e(−P, Q) and for an Fp element
    (fixed by the easy part), not one for the random rows and the lone
    Miller rows."""
    one_prod = ttower.f12_mul(rows[..., 2:3], rows[..., 3:4])
    fp_row = torch.zeros_like(one_prod)
    fp_row[0, 0, 0, :, 0] = torch.from_numpy(tfp.to_limbs(123456789))
    # four rows, the shape of `rows`: JAX's jit compiled it already
    f = torch.cat([one_prod, rows[..., 0:1], rows[..., 2:3], fp_row],
                  dim=-1).contiguous()
    cfe.reset_launches()
    got, verdict = cfe.final_exp_is_one(f)
    assert cfe.LAUNCHES == {"final_exp": 0}
    np.testing.assert_array_equal(got.numpy(),
                                  cfe.final_exp_plain(f).numpy())
    jf = jnp.asarray(convert.elems_to_jax(f.numpy()))
    je = jax.jit(jpair.final_exponentiate)(jf)
    jone = jtower.f12_eq(je, jnp.broadcast_to(
        jnp.asarray(jtower.F12_ONE_M), je.shape))
    assert verdict.tolist() == np.asarray(jone).tolist() == [
        True, False, False, True]
    assert verdict.tolist() == tpair.is_one(got).tolist()


# ---------------------------------------------------------------------------
# the cyclotomic squaring of the redesigned K11
# ---------------------------------------------------------------------------

from charon_tpu_torch.ops.cuda_g2 import (_f2add, _f2small, _f2sqr,  # noqa: E402
                                          _f2sub)


def _cyclotomic(seed: int) -> list:
    """The easy part of random Fp12 rows (and an all-LMAX one): values in
    the cyclotomic subgroup."""
    f = _f12(seed).reshape(2, 3, 2, 32, 3)
    f[..., 0] = jfp.LMAX
    x = cfe._unstack(f)
    x = cfe._mul(cfe._conj(x), cfe._inv(x))
    return cfe._mul(cfe._frob(cfe._frob(x)), x)


def test_cyclotomic_squaring_equals_f12_sqr_on_cyclotomic_inputs():
    x = _cyclotomic(61)
    got = cfe._stack(cfe._cyc_sqr(x))
    np.testing.assert_array_equal(_canon(got),
                                  _canon(ttower.f12_sqr(cfe._stack(x))))
    # off the subgroup Granger–Scott's formula is not the square
    f = _f12(62).reshape(2, 3, 2, 32, 3)
    assert not np.array_equal(
        _canon(cfe._stack(cfe._cyc_sqr(cfe._unstack(f)))),
        _canon(ttower.f12_sqr(f)))


def test_cyclotomic_squaring_stages_equal_the_sequential_body():
    """The plain version batches the nine Fp2 squarings (the kernel's
    groups) and the six combinations along the rows; each equals the
    one-at-a-time sequence on the K5 bodies bit for bit."""
    f = cfe._unstack(_f12(63).reshape(2, 3, 2, 32, 3))
    s = []
    for a, b in cfe._CYC_PAIRS:
        s += [_f2sqr(f[a]), _f2sqr(f[b]), _f2sqr(_f2add(f[a], f[b]))]
    want = []
    for m, (k, part, sg) in enumerate(cfe._CYC_OUT):
        s0, s1, s2 = s[3 * k:3 * k + 3]
        if part == "R":
            x = _f2add(s0, cp._f2_mul_xi(s1))
        else:
            x = _f2sub(s2, _f2add(s0, s1))
            if part == "XI":
                x = cp._f2_mul_xi(x)
        d = _f2sub(x, f[m]) if sg < 0 else _f2add(x, f[m])
        want.append(_f2add(_f2small(d, 2), x))
    np.testing.assert_array_equal(cfe._stack(cfe._cyc_sqr(f)).numpy(),
                                  cfe._stack(want).numpy())


def test_output_limbs_within_lmax(plain):
    assert int(plain.min()) >= 0 and int(plain.max()) <= jfp.LMAX
