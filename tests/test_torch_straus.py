"""The port's Straus MSM (charon_tpu_torch.ops.cuda_g2.straus_combine:
K2 tables, then the window loop — on the CPU the iterated plain K3
steps) and K16's HEAD and TAIL programs looped as the kernel loops them
(miller_program.straus_run_plain) against the JAX package's
pallas_g2.straus_combine in DIRECT mode, bit for bit, with the window loop
truncated (the JAX loop's one-off compile dominates this file's time: one
JAX run serves both).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.ops import pallas_g2
from charon_tpu_torch import convert
from charon_tpu_torch.ops import cuda_g2
from charon_tpu_torch.ops import miller_program as mp

from test_torch_g2 import ROWS, _fc, _jax_tiled, _port, _ref_points, _rows, _same


@pytest.fixture(autouse=True)
def direct_mode():
    pallas_g2.DIRECT = True
    yield
    pallas_g2.DIRECT = False


T = 2


@pytest.fixture(scope="module")
def combined():
    """(points, digits, JAX's straus_combine): a t-major batch of T = 2
    shares × 1,024 rows of real points with ∞ rows, windows truncated to
    3."""
    nwin = 3
    pts = _rows(_ref_points(24, 11), T * ROWS)
    rng = np.random.default_rng(12)
    digits = rng.integers(-4, 4, (nwin, T * ROWS), dtype=np.int32)
    pallas_g2.DIRECT = True
    try:
        ref = pallas_g2.straus_combine(
            _fc(), _jax_tiled(pts),
            jnp.asarray(convert.digits_to_jax(digits)), T)
    finally:
        pallas_g2.DIRECT = False
    return pts, digits, ref


def test_straus_combine_truncated_windows_bit_identical(combined):
    """The Straus MSM (tables + window loop)."""
    pts, digits, ref = combined
    got = cuda_g2.straus_combine(_port(pts), torch.from_numpy(digits), T)
    _same(got, ref)


def test_straus_programs_equal_jax_straus_combine(combined):
    """K16's programs at their default lanes, on the same tables."""
    pts, digits, ref = combined
    got = mp.straus_run_plain(*mp.straus_programs(),
                              cuda_g2.straus_tables(_port(pts)),
                              torch.from_numpy(digits), T)
    _same(got, ref)
