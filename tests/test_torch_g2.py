"""The port's G2 group-law kernels' plain versions (charon_tpu_torch.ops.
cuda_g2: K2 dbl/add, K3 Straus head/tail) against the JAX package's
pallas_g2 DIRECT forms, bit for bit, at S = 8 (1,024 rows).

JAX runs the kernel bodies as its own tests do on the CPU: DIRECT mode,
set and restored by a fixture.  Rows cover the complete-formula edges
(infinity operands, P + P, P + (−P)) and digits −4..3; the constant
tables and layout conversions are pinned.  (The Straus MSM is compared
in tests/test_torch_straus.py.)
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.ops import codec as jcodec
from charon_tpu.ops import curve as jcurve
from charon_tpu.ops import fp as jfp
from charon_tpu.ops import pallas_g2
from charon_tpu.tbls.ref import curve as refcurve
from charon_tpu_torch import convert
from charon_tpu_torch.ops import build, codec as tcodec, cuda_g2

ROWS = 1024  # S = 8


@pytest.fixture(autouse=True)
def direct_mode():
    pallas_g2.DIRECT = True
    yield
    pallas_g2.DIRECT = False


def _fc():
    return jnp.asarray(pallas_g2.fold_consts())


def _ref_points(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    pts = [refcurve.multiply(refcurve.G2_GEN, int(k))
           for k in rng.integers(1, 2**30, size=n)]
    for i in range(0, n, 9):
        pts[i] = None                       # infinity rows
    return pts


def _rows(pts: list, rows: int = ROWS) -> np.ndarray:
    """[rows, 3, 2, 32] limb-last rows cycling through `pts`."""
    base = jcurve.g2_pack(pts)
    return np.tile(base, (-(-rows // len(pts)), 1, 1, 1))[:rows]


def _random_limbs(seed: int, rows: int = ROWS) -> np.ndarray:
    """Arbitrary limbs in [0, LMAX]: the kernels' arithmetic is defined
    (and bit-identical) for any redundant residues, on the curve or not."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, jfp.LMAX + 1, (rows, 3, 2, 32), dtype=np.int32)


def _jax_tiled(rows_np: np.ndarray):
    return jnp.asarray(pallas_g2.tile_points(rows_np))


def _port(rows_np: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(convert.points_from_jax(rows_np))


def _same(port: torch.Tensor, jax_tiled) -> None:
    np.testing.assert_array_equal(
        port.numpy(), convert.points_from_jax(np.asarray(jax_tiled)))


def _inputs(kind: str, seed: int) -> np.ndarray:
    return (_rows(_ref_points(16, seed)) if kind == "curve"
            else _random_limbs(seed))


@pytest.mark.parametrize("kind", ["curve", "random"])
def test_dbl_bit_identical(kind):
    p = _inputs(kind, 1)
    _same(cuda_g2.dbl(_port(p)), pallas_g2.dbl(_fc(), _jax_tiled(p)))


@pytest.mark.parametrize("case", ["distinct", "p_plus_p", "p_plus_neg_p",
                                  "random"])
def test_add_bit_identical(case):
    a = _inputs("random" if case == "random" else "curve", 2)
    if case == "distinct":
        b = _rows(_ref_points(16, 3))
    elif case == "p_plus_p":
        b = a.copy()
    elif case == "p_plus_neg_p":
        b = np.asarray(jcurve.neg_point(jcurve.F2_OPS, jnp.asarray(a)))
    else:
        b = _random_limbs(3)
    _same(cuda_g2.add(_port(a), _port(b)),
          pallas_g2.add(_fc(), _jax_tiled(a), _jax_tiled(b)))


def _tables(seed: int):
    """Window tables P, 2P, 3P, 4P (DIRECT kernels) as JAX tiled arrays."""
    p = _jax_tiled(_rows(_ref_points(16, seed)))
    p2 = pallas_g2.dbl(_fc(), p)
    p3 = pallas_g2.add(_fc(), p2, p)
    p4 = pallas_g2.dbl(_fc(), p2)
    return p, p2, p3, p4


def _digits(seed: int, rows: int = ROWS) -> np.ndarray:
    rng = np.random.default_rng(seed)
    d = rng.integers(-4, 4, rows, dtype=np.int32)
    d[:8] = np.arange(-4, 4)                       # every digit appears
    return d


@pytest.mark.parametrize("head", [True, False])
def test_straus_step_bit_identical(head):
    tabs = _tables(4)
    acc = _rows(_ref_points(16, 5))
    w = _digits(6)
    fn = pallas_g2.dbl3sel_s if head else pallas_g2.addsel_s
    ref = fn(_fc(), _jax_tiled(acc), *tabs,
             jnp.asarray(w.reshape(ROWS // 128, 128)))
    port_tabs = tuple(torch.from_numpy(convert.points_from_jax(np.asarray(t)))
                      for t in tabs)
    got = cuda_g2.straus_step(_port(acc), port_tabs, 0, torch.from_numpy(w),
                              head)
    _same(got, ref)


def test_straus_step_reads_at_a_row_offset():
    """K3 reads share t's rows of the full tables through row0: the result
    equals the step on the sliced tables."""
    tabs = [torch.from_numpy(convert.points_from_jax(np.asarray(t)))
            for t in _tables(7)]
    acc = _port(_rows(_ref_points(16, 8), 256))
    w = torch.from_numpy(_digits(9))
    got = cuda_g2.straus_step(acc, tabs, 512, w, False)
    want = cuda_g2.straus_step(
        acc, [t[..., 512:768].contiguous() for t in tabs], 0,
        w[512:768].contiguous(), False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_signed_digit_rows_bit_identical():
    rng = np.random.default_rng(10)
    bits = rng.integers(0, 2, (64, 256)).astype(np.int32)
    bits[0] = 0
    bits[1] = 1
    bits[2, ::3] = 1
    np.testing.assert_array_equal(cuda_g2.signed_digit_rows(bits),
                                  pallas_g2.signed_digit_rows(bits))


def test_constant_tables_equal_jax():
    fc = pallas_g2.fold_consts()
    assert (fc == fc[:, :, :1]).all()              # lane-invariant
    np.testing.assert_array_equal(cuda_g2.fold_consts(), fc[:, :, 0])
    np.testing.assert_array_equal(cuda_g2.OFF1, pallas_g2._OFF1)
    np.testing.assert_array_equal(cuda_g2.OFF2, pallas_g2._OFF2)
    np.testing.assert_array_equal(tcodec._PSI_CX_M, jcodec._PSI_CX_M)
    np.testing.assert_array_equal(tcodec._PSI_CY_M, jcodec._PSI_CY_M)
    np.testing.assert_array_equal(tcodec._ABS_Z_BITS, jcodec._ABS_Z_BITS)
    assert tcodec._Z_SIGNED == jcodec._Z_SIGNED


def test_committed_constant_header_matches_tables():
    header = build.CSRC / "fp381_consts.cuh"
    assert header.read_text() == build.render_consts_header()


def test_point_layout_conversions():
    rows = _random_limbs(13)
    tiled = pallas_g2.tile_points(rows)
    port = convert.points_from_jax(rows)
    np.testing.assert_array_equal(convert.points_from_jax(tiled), port)
    np.testing.assert_array_equal(convert.points_to_jax(port), tiled)
    np.testing.assert_array_equal(convert.points_to_jax(port, tiled=False),
                                  rows)
    d = _digits(14).reshape(1, -1)
    np.testing.assert_array_equal(
        convert.digits_from_jax(convert.digits_to_jax(d)), d)


def test_cpu_tensors_take_the_plain_path():
    cuda_g2.reset_launches()
    p = _port(_random_limbs(15))
    cuda_g2.add(cuda_g2.dbl(p), p)
    assert all(n == 0 for n in cuda_g2.LAUNCHES.values())
    with pytest.raises(ValueError):
        cuda_g2.dbl(p.to("meta"))
