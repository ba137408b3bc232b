"""The port's pairing kernels' plain versions (charon_tpu_torch.ops.
cuda_pairing: K4 pp_dbl/pp_add, K5 pp_sqr/pp_mul014/pp_f12mul, K6
g1_dblsel) against the JAX package's pallas_pairing DIRECT forms, bit for
bit, at 128 rows on random and all-LMAX limbs; the layout helpers; the
fold's row-offset operands.  (The launch sequences are compared in
tests/test_torch_miller.py.)

JAX runs the kernel bodies as its own tests do on the CPU: DIRECT mode,
set and restored by a fixture.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.ops import fp as jfp
from charon_tpu.ops import pallas_g2
from charon_tpu.ops import pallas_pairing as pp
from charon_tpu_torch import convert
from charon_tpu_torch.ops import cuda_pairing as cp

ROWS = 128  # S = 1


@pytest.fixture(autouse=True)
def direct_mode():
    pallas_g2.DIRECT = True
    yield
    pallas_g2.DIRECT = False


def _fc():
    return jnp.asarray(pallas_g2.fold_consts())


def _limbs(n: int, seed: int, pattern: str = "random") -> np.ndarray:
    """[n, 32, ROWS] limbs in [0, LMAX]: the kernels' arithmetic is defined
    (and bit-identical) for any redundant residues."""
    if pattern == "lmax":
        return np.full((n, 32, ROWS), jfp.LMAX, np.int32)
    rng = np.random.default_rng(seed)
    return rng.integers(0, jfp.LMAX + 1, (n, 32, ROWS), dtype=np.int32)


def _jax(a: np.ndarray):
    return jnp.asarray(convert.planes_to_jax(a))


def _same(port: torch.Tensor, jax_tiled) -> None:
    np.testing.assert_array_equal(
        port.numpy(), convert.planes_from_jax(np.asarray(jax_tiled)))


_CASES = {
    # name: (port fn, plane counts of the inputs)
    "pp_dbl": (cp.pp_dbl, (6,)),
    "pp_add": (cp.pp_add, (6, 4)),
    "pp_sqr": (cp.pp_sqr, (12,)),
    "pp_mul014": (cp.pp_mul014, (12, 6, 3)),
    "pp_f12mul": (cp.pp_f12mul, (12, 12)),
}


@pytest.mark.parametrize("pattern", ["random", "lmax"])
@pytest.mark.parametrize("name", sorted(_CASES))
def test_kernel_plain_version_bit_identical(name, pattern):
    fn, planes = _CASES[name]
    args = [_limbs(n, 10 * k + len(name), pattern)
            for k, n in enumerate(planes)]
    want = pp._DIRECT_FNS[name](_fc(), *[_jax(a) for a in args])
    _same(fn(*[torch.from_numpy(a) for a in args]), want)


@pytest.mark.parametrize("pattern", ["random", "lmax"])
def test_g1_dblsel_plain_version_bit_identical(pattern):
    acc, t1, t2, t3 = (_limbs(3, 40 + k, pattern) for k in range(4))
    w = np.random.default_rng(44).integers(0, 4, ROWS, dtype=np.int32)
    w[:4] = np.arange(4)                          # every window appears
    want = pp._DIRECT_FNS["pp_g1_dblsel"](
        _fc(), _jax(acc), _jax(t1), _jax(t2), _jax(t3),
        jnp.asarray(w.reshape(1, ROWS)))
    got = cp.g1_dblsel(*[torch.from_numpy(a) for a in (acc, t1, t2, t3)],
                       torch.from_numpy(w))
    _same(got, want)


def test_layout_helpers():
    f = _limbs(12, 50)
    np.testing.assert_array_equal(
        convert.f12_from_jax(convert.f12_to_jax(f, tiled=False)), f)
    np.testing.assert_array_equal(
        convert.f12_from_jax(convert.f12_to_jax(f)), f)
    np.testing.assert_array_equal(
        np.asarray(pp.untile_f12(jnp.asarray(convert.f12_to_jax(f)))),
        convert.f12_to_jax(f, tiled=False))
    g = _limbs(3, 51)
    np.testing.assert_array_equal(
        convert.g1_from_jax(convert.g1_to_jax(g, tiled=False)), g)
    np.testing.assert_array_equal(
        convert.g1_from_jax(convert.g1_to_jax(g)), g)
    assert cp.LOOP_BITS == pp.LOOP_BITS
    np.testing.assert_array_equal(cp._F12_ONE, pp._F12_ONE_PLANES)
    np.testing.assert_array_equal(cp._G1_INF, pp._G1_INF_PLANES)


def test_fold_reads_row_slices_of_one_tensor():
    """K5 F12MUL takes the two halves of one tensor as its operands (the
    fold's row-offset views); the product equals that of copies."""
    f = torch.from_numpy(_limbs(12, 52))
    got = cp.pp_f12mul(f[..., :64], f[..., 64:])
    want = cp.pp_f12mul(f[..., :64].contiguous(), f[..., 64:].contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_path():
    cp.reset_launches()
    xyz = torch.from_numpy(_limbs(6, 53))
    out = cp.pp_dbl(xyz)
    cp.pp_sqr(cp.pp_mul014(cp.f12_one(ROWS, "cpu"), out[6:],
                           torch.from_numpy(_limbs(3, 54))))
    assert all(n == 0 for n in cp.LAUNCHES.values())
    with pytest.raises(ValueError):
        cp.pp_dbl(xyz.to("meta"))
