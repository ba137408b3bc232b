"""The port's Straus MSM (charon_tpu_torch.ops.cuda_g2.straus_combine:
K2 tables, then the K3 window loop) against the JAX package's
pallas_g2.straus_combine in DIRECT mode, bit for bit, with the window loop
truncated (the JAX loop's one-off compile dominates this file's time).
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

from test_torch_g2 import ROWS, _fc, _jax_tiled, _port, _ref_points, _rows, _same


@pytest.fixture(autouse=True)
def direct_mode():
    pallas_g2.DIRECT = True
    yield
    pallas_g2.DIRECT = False


def test_straus_combine_truncated_windows_bit_identical():
    """The Straus MSM (tables + window loop) over a t-major batch of
    T = 2 shares × 1,024 rows, windows truncated to 3."""
    t, nwin = 2, 3
    pts = _rows(_ref_points(24, 11), t * ROWS)
    rng = np.random.default_rng(12)
    digits = rng.integers(-4, 4, (nwin, t * ROWS), dtype=np.int32)
    ref = pallas_g2.straus_combine(_fc(), _jax_tiled(pts),
                                   jnp.asarray(convert.digits_to_jax(digits)),
                                   t)
    got = cuda_g2.straus_combine(_port(pts), torch.from_numpy(digits), t)
    _same(got, ref)
