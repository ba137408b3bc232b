"""The port's Miller-loop launch sequences (charon_tpu_torch.ops.
cuda_pairing) on the kernels' plain versions, against the JAX package's
pallas_pairing host loops in DIRECT mode: the Miller rows of two real
pairs plus ∞-masked padding against `miller_product_tiled` (bit for bit),
the fold to one row against the JAX tower's product (canonical values:
the two multiply in another order), and the RLC scalar multiplication
against `g1_scalar_mul_rows` (bit for bit).
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
from charon_tpu.ops import pallas_g2
from charon_tpu.ops import pallas_pairing as pp
from charon_tpu.ops import tower as jtower
from charon_tpu.tbls.ref import curve as refcurve
from charon_tpu_torch import convert
from charon_tpu_torch.ops import cuda_pairing as cp
from charon_tpu_torch.ops import fp as tfp

ROWS = 128  # S = 1


@pytest.fixture(autouse=True)
def direct_mode():
    pallas_g2.DIRECT = True
    yield
    pallas_g2.DIRECT = False


def _fc():
    return jnp.asarray(pallas_g2.fold_consts())


def _same(port: torch.Tensor, jax_tiled) -> None:
    np.testing.assert_array_equal(
        port.numpy(), convert.planes_from_jax(np.asarray(jax_tiled)))


def _pairs():
    """Two real (P, Q) pairs on rows 0 and 1; every other row pairs ∞
    with ∞ (padding), masked to one before the fold."""
    ps = [refcurve.multiply(refcurve.G1_GEN, 5),
          refcurve.multiply(refcurve.G1_GEN, 2**70 + 9)]
    qs = [refcurve.multiply(refcurve.G2_GEN, 11),
          refcurve.multiply(refcurve.G2_GEN, 3**40)]
    p_rows = jcurve.g1_pack(ps + [None] * (ROWS - 2))
    q_rows = jcurve.g2_pack(qs + [None] * (ROWS - 2))
    drop = np.arange(ROWS) >= 2
    return p_rows, q_rows, drop


@pytest.fixture(scope="module")
def miller():
    """(port masked rows, JAX masked rows, port fold, JAX limb-last rows)."""
    pallas_g2.DIRECT = True
    try:
        p_rows, q_rows, drop = _pairs()
        p_side = pp.g1_proj_rows(jnp.asarray(p_rows))
        q_side = pp.g2_affine_rows(jnp.asarray(q_rows))
        want = pp.miller_product_tiled(
            _fc(), pp.tile_planes(p_side), pp.tile_planes(q_side),
            jnp.asarray(drop.reshape(1, ROWS)))
        p_t = torch.from_numpy(convert.g1_from_jax(np.asarray(p_side)))
        q_t = torch.from_numpy(np.ascontiguousarray(
            convert.elems_from_jax(np.asarray(q_side))))
        drop_t = torch.from_numpy(drop)
        rows = cp.mask_rows(cp.miller_rows(p_t, q_t), drop_t)
        folded = cp.fold_product(rows)
        return rows, want, folded
    finally:
        pallas_g2.DIRECT = False


def test_miller_rows_bit_identical(miller):
    rows, want, _ = miller
    _same(rows, want)
    one = np.asarray(cp._F12_ONE)
    assert (rows.numpy()[:, :, 2:] == one[:, :, None]).all()


def test_fold_equals_the_jax_tower_product(miller):
    rows, want, folded = miller
    assert tuple(folded.shape) == (12, 32, 1)
    f = jnp.asarray(convert.f12_to_jax(
        convert.f12_from_jax(np.asarray(want)), tiled=False))
    k = f.shape[0]
    while k > 1:
        k //= 2
        f = jax.jit(jtower.f12_mul)(f[:k], f[k:2 * k])
    want_std = np.asarray(jax.jit(jfp.canon_std)(f.reshape(-1, 32)))
    got_std = tfp.canon_std(folded).numpy()          # [12, 32, 1]
    np.testing.assert_array_equal(got_std[:, :, 0], want_std)


def test_g1_scalar_mul_rows_bit_identical():
    rng = np.random.default_rng(7)
    pts = [refcurve.multiply(refcurve.G1_GEN, int(k))
           for k in rng.integers(1, 2**40, 8)]
    base = np.tile(jcurve.g1_pack(pts), (ROWS // 8, 1, 1))
    bits = rng.integers(0, 2, (ROWS, 64)).astype(np.int32)
    bits[0] = 0                                   # r = 0 → ∞
    j_base = jnp.asarray(base)
    p2 = jcurve.double_point(jcurve.FP_OPS, j_base)
    p3 = jcurve.add_points(jcurve.FP_OPS, p2, j_base)
    tabs = [pp.tile_planes(t) for t in (j_base, p2, p3)]
    want = pp.g1_scalar_mul_rows(_fc(), *tabs,
                                 pallas_g2.windows_from_bits(bits))
    port_tabs = [torch.from_numpy(convert.g1_from_jax(np.array(t)))
                 for t in tabs]
    windows = cp.windows_from_bits(bits)
    np.testing.assert_array_equal(
        windows, convert.digits_from_jax(pallas_g2.windows_from_bits(bits)))
    got = cp.g1_scalar_mul_rows(*port_tabs, torch.from_numpy(windows))
    _same(got, want)
