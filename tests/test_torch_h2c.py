"""The port's hash-to-G2 kernels' plain versions (charon_tpu_torch.ops.
cuda_h2c: K7 sqr/mul/sqr4/sqr4mul, K8 sswu, K9 iso3/psi; cuda_g2: K10
dblsel and addsel) against the JAX package's pallas_h2c / pallas_g2
DIRECT forms, bit for bit, at S = 1 (128 rows), on random and all-LMAX
limbs; and the pieces around them: the constant table, the pow and |x|
window schedules, the host packing with K24's flags from the plain
prologue (`sswu_flags_plain`; a u = 0 row included), the exactness
helpers, the inversion chain and the layout conversions.

JAX runs the kernel bodies as its own tests do on the CPU: DIRECT mode,
set and restored by a fixture.  (The whole pipeline is compared in
tests/test_torch_h2c_pipeline.py, the verify path in
tests/test_torch_h2c_verify.py.)
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.ops import fp as jfp
from charon_tpu.ops import pallas_g2, pallas_h2c
from charon_tpu.tbls.ref.fields import P
from charon_tpu.tbls.ref.hash_to_curve import DST_G2
from charon_tpu_torch import convert
from charon_tpu_torch.ops import cuda_g2, cuda_h2c
from charon_tpu_torch.ops.fp import canon_std
from charon_tpu_torch.tbls.ref.fields import FQ2

ROWS = 128  # S = 1


@pytest.fixture(autouse=True)
def direct_mode():
    pallas_g2.DIRECT = True
    yield
    pallas_g2.DIRECT = False


def _consts():
    return (jnp.asarray(pallas_g2.fold_consts()),
            jnp.asarray(pallas_h2c.h2c_consts()))


def _limbs(planes: int, pattern: str, seed: int) -> np.ndarray:
    if pattern == "lmax":
        return np.full((planes, 32, ROWS), jfp.LMAX, np.int32)
    rng = np.random.default_rng(seed)
    return rng.integers(0, jfp.LMAX + 1, (planes, 32, ROWS), dtype=np.int32)


def _jax(a: np.ndarray):
    return jnp.asarray(convert.planes_to_jax(a))


def _same(port: torch.Tensor, jax_tiled) -> None:
    np.testing.assert_array_equal(
        port.numpy(), convert.planes_from_jax(np.asarray(jax_tiled)))


_BODIES = {
    "h2c_sqr": (cuda_h2c.sqr_plain, (2,)),
    "h2c_mul": (cuda_h2c.mul_plain, (2, 2)),
    "h2c_sqr4": (cuda_h2c.sqr4_plain, (2,)),
    "h2c_sqr4mul": (cuda_h2c.sqr4mul_plain, (2, 2)),
    "h2c_iso3": (cuda_h2c.iso3_plain, (4,)),
    "h2c_psi": (cuda_h2c.psi_plain, (6,)),
}


@pytest.mark.parametrize("pattern", ["random", "lmax"])
@pytest.mark.parametrize("name", sorted(_BODIES))
def test_plain_body_bit_identical(name, pattern):
    fn, planes = _BODIES[name]
    args = [_limbs(n, pattern, 10 + k) for k, n in enumerate(planes)]
    got = fn(*[torch.from_numpy(a) for a in args])
    _same(got, pallas_h2c._DIRECT_FNS[name](*_consts(),
                                           *[_jax(a) for a in args]))


@pytest.mark.parametrize("pattern", ["random", "lmax"])
def test_sswu_plain_bit_identical(pattern):
    u = _limbs(2, pattern, 20)
    w = (np.random.default_rng(21).integers(0, 4, ROWS) == 0).astype(np.int32)
    got = cuda_h2c.sswu_plain(torch.from_numpy(u), torch.from_numpy(w))
    _same(got, pallas_h2c._DIRECT_FNS["h2c_sswu"](
        *_consts(), _jax(u), jnp.asarray(w.reshape(1, ROWS))))


@pytest.mark.parametrize("pattern", ["random", "lmax"])
@pytest.mark.parametrize("name", ["dblsel", "addsel"])
def test_g2_sel_plain_bit_identical(name, pattern):
    pts = [_limbs(6, pattern, 30 + k) for k in range(4)]
    w = np.random.default_rng(34).integers(0, 4, ROWS).astype(np.int32)
    w[:4] = np.arange(4)                            # every window appears
    fn = cuda_g2.dblsel_plain if name == "dblsel" else cuda_g2.addsel_plain
    got = fn(*[torch.from_numpy(p) for p in pts], torch.from_numpy(w))
    _same(got, pallas_g2._DIRECT_FNS[name](
        jnp.asarray(pallas_g2.fold_consts()), *[_jax(p) for p in pts],
        jnp.asarray(w.reshape(1, ROWS))))


def test_constant_table_equals_jax():
    np.testing.assert_array_equal(
        cuda_h2c.h2c_consts(),
        convert.h2c_consts_from_jax(pallas_h2c.h2c_consts()))
    np.testing.assert_array_equal(
        convert.h2c_consts_to_jax(cuda_h2c.h2c_consts()),
        pallas_h2c.h2c_consts())
    np.testing.assert_array_equal(cuda_h2c._F2_MINUS_ONE,
                                  pallas_h2c._F2_MINUS_ONE)
    np.testing.assert_array_equal(cuda_g2._INF_PLANES, pallas_g2._INF_PLANES)


def test_window_schedules_equal_jax():
    for e in (cuda_h2c.EXP_SQRT_A1, cuda_h2c.EXP_SQRT_B, cuda_h2c.EXP_INV,
              1, 15, 16, 255):
        assert cuda_h2c._pow_digits(e) == pallas_h2c._pow_digits(e)
    assert (cuda_h2c.EXP_SQRT_A1, cuda_h2c.EXP_SQRT_B, cuda_h2c.EXP_INV) == \
        (pallas_h2c.EXP_SQRT_A1, pallas_h2c.EXP_SQRT_B, pallas_h2c.EXP_INV)
    assert cuda_h2c._Z_WINDOWS == pallas_h2c._Z_WINDOWS


def test_pack_messages_equals_jax_with_a_u0_row():
    msgs = [b"", b"abc", b"charon-tpu-torch h2c: 7"]
    m = len(msgs)
    # JAX pads to m + 1: its last message row is u = 0 (both u values)
    j_u, j_exc, j_sgn = pallas_h2c.pack_messages(msgs, DST_G2, m + 1)
    u = cuda_h2c.pack_messages(msgs)
    exc, sgn = (t.numpy() for t in cuda_h2c.sswu_flags_plain(
        torch.from_numpy(u)))
    ju, jexc, jsgn = convert.h2c_inputs_from_jax(j_u, j_exc, j_sgn)
    real = np.r_[0:m, m + 1:2 * m + 1]            # the u-major real rows
    np.testing.assert_array_equal(u, ju[..., real])
    np.testing.assert_array_equal(exc, jexc[real])
    np.testing.assert_array_equal(sgn, jsgn[real])
    # a u = 0 row gets the exceptional flag and sgn0 = 0, as JAX's pad rows
    u0 = cuda_h2c._pack_u([FQ2.zero(), FQ2([3, 7])])
    exc0, sgn0 = (t.numpy() for t in cuda_h2c.sswu_flags_plain(
        torch.from_numpy(u0)))
    np.testing.assert_array_equal(u0[..., 0], ju[..., m])
    assert (exc0[0], sgn0[0]) == (jexc[m], jsgn[m]) == (1, 0)
    assert exc0[1] == 0


def _rows_f2(values) -> np.ndarray:
    """Fp2 values (c0, c1) → [2, 32, len] limb planes, REDUNDANT forms
    (value + p where it fits) in every second row."""
    out = np.zeros((2, 32, len(values)), np.int32)
    for k, (c0, c1) in enumerate(values):
        for j, c in enumerate((c0 % P, c1 % P)):
            out[j, :, k] = jfp.to_limbs(c + P if k % 2 else c)
    return out


def test_exactness_helpers_equal_jax():
    rng = np.random.default_rng(40)
    vals = [(0, 0), (0, 1), (0, 2), (1, 0), (2, 0), (P - 1, 0), (P - 1, 5),
            (0, P - 1)]
    vals += [(int(a), int(b)) for a, b in rng.integers(0, 2**62, (8, 2))]
    a = _rows_f2(vals)
    b = _rows_f2(vals[1:] + vals[:1])
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    n = len(vals)

    def jt(x):
        pad = np.zeros((2, 32, ROWS), np.int32)
        pad[..., :n] = x
        return _jax(pad)

    def jrow(x):
        return np.asarray(x).reshape(-1)[:n]

    np.testing.assert_array_equal(cuda_h2c.f2_sgn0_rows(ta).numpy(),
                                  jrow(pallas_h2c.f2_sgn0_rows(jt(a))))
    np.testing.assert_array_equal(cuda_h2c.f2_is_zero_rows(ta).numpy(),
                                  jrow(pallas_h2c.f2_is_zero_rows(jt(a))))
    np.testing.assert_array_equal(cuda_h2c.f2_eq_rows(ta, ta).numpy(),
                                  np.ones(n, bool))
    np.testing.assert_array_equal(cuda_h2c.f2_eq_rows(ta, tb).numpy(),
                                  jrow(pallas_h2c.f2_eq_rows(jt(a), jt(b))))
    minus_one = pallas_h2c._F2_MINUS_ONE
    np.testing.assert_array_equal(
        cuda_h2c.f2_eq_const_rows(ta, cuda_h2c._F2_MINUS_ONE).numpy(),
        jrow(pallas_h2c.f2_eq_const_rows(jt(a), minus_one)))
    fc = jnp.asarray(pallas_g2.fold_consts())
    _same(cuda_h2c._f2_neg_t(ta), pallas_h2c._f2_neg_t(fc, jt(a))[..., :n])
    p = _limbs(6, "random", 41)
    _same(cuda_h2c._pt_neg_t(torch.from_numpy(p)),
          pallas_h2c._pt_neg_t(fc, _jax(p)))


def test_inversion_chain_bit_identical():
    """The K7 launch sequence (`f2_inv_steps`) is JAX's chain bit for bit;
    K18's inverse program (`f2_inv_rows`, the norm's pow in Fp alone)
    computes the same values in other redundant limbs: bit for bit after
    canonicalisation."""
    a = _limbs(2, "random", 50)
    a[..., 0] = 0                                     # inv(0) = 0
    want = pallas_h2c.f2_inv_rows(*_consts(), _jax(a))
    _same(cuda_h2c.f2_inv_steps(torch.from_numpy(a)), want)
    got = cuda_h2c.f2_inv_rows(torch.from_numpy(a))
    jw = torch.from_numpy(convert.planes_from_jax(np.asarray(want)))
    for c in range(2):
        assert torch.equal(canon_std(got[c]), canon_std(jw[c]))
    assert bool(cuda_h2c.f2_is_zero_rows(got)[0])


def test_h2c_layout_conversions():
    u = cuda_h2c._pack_u([FQ2([k, 3 * k + 1]) for k in range(ROWS)])
    exc, sgn = (t.numpy() for t in cuda_h2c.sswu_flags_plain(
        torch.from_numpy(u)))
    tiled = convert.h2c_inputs_to_jax(u, exc, sgn)
    assert tiled[0].shape == (2, 32, 1, 128) and tiled[1].shape == (1, 128)
    back = convert.h2c_inputs_from_jax(*tiled)
    for x, y in zip(back, (u, exc, sgn)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        convert.h2c_inputs_from_jax(pallas_h2c.tile_u_rows(
            convert.elems_to_jax(u)), exc, sgn)[0], u)


def test_cpu_tensors_take_the_plain_path():
    cuda_h2c.reset_launches()
    cuda_g2.reset_launches()
    a = torch.from_numpy(_limbs(2, "random", 60))
    p = torch.from_numpy(_limbs(6, "random", 61))
    w = torch.zeros(ROWS, dtype=torch.int32)
    cuda_h2c.h2c_sqr4mul(cuda_h2c.h2c_sqr(a), cuda_h2c.h2c_mul(a, a))
    cuda_h2c.h2c_psi(p)
    cuda_g2.dblsel(p, p, p, p, w)
    cuda_g2.addsel(p, p, p, p, w)
    assert all(n == 0 for n in cuda_h2c.LAUNCHES.values())
    assert all(n == 0 for n in cuda_g2.LAUNCHES.values())
    for fn, args in ((cuda_h2c.h2c_sqr, (a,)), (cuda_h2c.h2c_psi, (p,)),
                     (cuda_h2c.h2c_sswu, (a, w)),
                     (cuda_g2.dblsel, (p, p, p, p, w))):
        with pytest.raises(ValueError):
            fn(*[t.to("meta") for t in args])
