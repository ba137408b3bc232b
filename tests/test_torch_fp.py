"""The port's Fp layer (charon_tpu_torch.ops.fp, kernel K1's plain versions)
against the JAX package's ops/fp.py, bit for bit.

Inputs are made with numpy from fixed seeds and handed to both; the port
takes them in its own layout (limbs × rows) through convert.py.  Integer
field arithmetic, so the tolerance is exact equality — on random limbs, on
the adversarial all-LMAX pattern of tests/test_ops_fp.py, and through deep
op chains.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.ops import fp as jfp
from charon_tpu_torch import convert
from charon_tpu_torch.ops import cuda_fp, fp as tfp

N = 64
LMAX = jfp.LMAX


def _pattern(kind: str, seed: int) -> np.ndarray:
    """[N, 32] int32 limbs: random in [0, LMAX], all LMAX, or canonical
    residues (value < p) — the three shapes of input the ops take."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, LMAX + 1, (N, 32), dtype=np.int32)
    if kind == "lmax":
        return np.full((N, 32), LMAX, np.int32)
    vals = [int.from_bytes(rng.bytes(48), "big") % jfp.P for _ in range(N)]
    vals[:3] = [0, 1, jfp.P - 1]
    return np.stack([jfp.to_limbs(v) for v in vals])


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(convert.elems_from_jax(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return convert.elems_to_jax(t.numpy())


def _same(port: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(_np(port), np.asarray(ref))


PATTERNS = [("random", "random"), ("lmax", "lmax"), ("random", "lmax"),
            ("canon", "random")]


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
@pytest.mark.parametrize("pa,pb", PATTERNS)
def test_binary_ops_bit_identical(op, pa, pb):
    a, b = _pattern(pa, 1), _pattern(pb, 2)
    ref = getattr(jfp, op)(jnp.asarray(a), jnp.asarray(b))
    _same(getattr(tfp, op)(_t(a), _t(b)), ref)


@pytest.mark.parametrize("kind", ["random", "lmax", "canon"])
def test_neg_bit_identical(kind):
    a = _pattern(kind, 3)
    _same(tfp.neg(_t(a)), jfp.neg(jnp.asarray(a)))


@pytest.mark.parametrize("k", [2, 3, 8, 12, 16])
@pytest.mark.parametrize("kind", ["random", "lmax"])
def test_mul_small_bit_identical(k, kind):
    a = _pattern(kind, 4)
    _same(tfp.mul_small(_t(a), k), jfp.mul_small(jnp.asarray(a), k))


def test_deep_chain_of_max_limb_products():
    """Products and sums of all-LMAX operands, fed back 12 times: every
    intermediate stays a valid redundant residue and bit-identical."""
    a = _pattern("lmax", 0)
    b = _pattern("random", 5)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = _t(a), _t(b)
    for _ in range(12):
        ja, jb = jfp.mul(ja, jb), jfp.sub(jfp.add(ja, jb), jfp.neg(ja))
        ta, tb = tfp.mul(ta, tb), tfp.sub(tfp.add(ta, tb), tfp.neg(ta))
    _same(ta, ja)
    _same(tb, jb)
    assert int(ta.max()) <= LMAX and int(tb.max()) <= LMAX


def test_inv_bit_identical_and_inverse():
    a = _pattern("canon", 6)[:8]
    inv = tfp.inv(_t(a))
    _same(inv, jfp.inv(jnp.asarray(a)))
    prod = tfp.canon_std(tfp.mul(inv, _t(a)))
    want = [0] + [1] * 7          # row 0 is 0: inv(0) = 0 by convention
    assert tfp.unpack(prod.numpy()) == want


@pytest.mark.parametrize("kind", ["random", "lmax", "canon"])
def test_boundary_ops_bit_identical(kind):
    a = _pattern(kind, 7)
    b = a.copy()
    b[::2] = _pattern("random", 8)[::2]           # half the rows differ
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    _same(tfp.canon_std(_t(a)), jfp.canon_std(ja))
    np.testing.assert_array_equal(tfp.is_zero(_t(a)).numpy(),
                                  np.asarray(jfp.is_zero(ja)))
    np.testing.assert_array_equal(tfp.eq(_t(a), _t(b)).numpy(),
                                  np.asarray(jfp.eq(ja, jb)))
    std = np.asarray(jfp.canon_std(ja))
    np.testing.assert_array_equal(tfp.sgn(_t(std)).numpy(),
                                  np.asarray(jfp.sgn(jnp.asarray(std))))


def test_eq_sees_values_not_limbs():
    """x and x + p have different limbs but one value."""
    x = _pattern("canon", 9)
    xp = np.stack([jfp.to_limbs(jfp.from_limbs(r) + jfp.P) for r in x])
    assert tfp.eq(_t(x), _t(xp)).all()
    assert tfp.is_zero(_t(np.stack([jfp.P_LIMBS] * 2))).all()


def test_constant_tables_equal_jax():
    np.testing.assert_array_equal(tfp.FOLDC, jfp.FOLDC)
    np.testing.assert_array_equal(tfp.SPREAD48P, jfp.SPREAD48P)
    np.testing.assert_array_equal(tfp.PMULT, jfp.PMULT)


def test_wrapper_takes_plain_path_on_cpu_tensors():
    """A CPU tensor goes to the plain version and counts no launch."""
    cuda_fp.reset_launches()
    a, b = _t(_pattern("random", 10)), _t(_pattern("random", 11))
    torch.testing.assert_close(cuda_fp.mul(a, b), tfp.mul_plain(a, b),
                               rtol=0, atol=0)
    torch.testing.assert_close(cuda_fp.mul_small(a, 12),
                               tfp.mul_small_plain(a, 12), rtol=0, atol=0)
    assert all(n == 0 for n in cuda_fp.LAUNCHES.values())


def test_wrapper_refuses_what_the_kernel_does_not_take():
    a = _t(_pattern("random", 12))
    with pytest.raises(TypeError):
        cuda_fp._check("fp_mul", a.long(), a.long())
    with pytest.raises(ValueError):
        cuda_fp._check("fp_mul", a, a[:, :8].contiguous())
    with pytest.raises(ValueError):
        cuda_fp._check("fp_mul", a.t(), a.t())            # [N, 32]: wrong axis
    with pytest.raises(ValueError):
        cuda_fp.mul(a.to("meta"), a.to("meta"))           # neither cpu nor cuda
    with pytest.raises(ValueError):
        cuda_fp.mul_small(a, 17)
