"""The port's plain pairing (charon_tpu_torch.ops.pairing): the Miller loop
against the JAX package's ops/pairing.miller_loop bit for bit, the pairing
against the cube of the pure-Python oracle's (`charon_tpu.tbls.ref.
pairing`), the kernels' Miller rows against the plain loop after
the final exponentiation (a row is the plain value's conjugate, up to an
Fp2 factor), and the per-row product check on a valid and a forged
signature.
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
from charon_tpu.ops import pairing as jpair
from charon_tpu.tbls.ref import bls as jbls
from charon_tpu.tbls.ref import curve as refcurve
from charon_tpu.tbls.ref import pairing as refpair
from charon_tpu_torch import convert
from charon_tpu_torch.ops import cuda_pairing as cp
from charon_tpu_torch.ops import fp as tfp
from charon_tpu_torch.ops import pairing as tpair
from charon_tpu_torch.ops import tower as ttower

P1 = refcurve.multiply(refcurve.G1_GEN, 3)
Q1 = refcurve.multiply(refcurve.G2_GEN, 5)


def _g1(pts) -> torch.Tensor:
    return torch.from_numpy(convert.g1_from_jax(jcurve.g1_pack(pts)))


def _g2(pts) -> torch.Tensor:
    return torch.from_numpy(convert.elems_from_jax(jcurve.g2_pack(pts)))


def _canon(f: torch.Tensor) -> np.ndarray:
    """[2, 3, 2, 32, R] → canonical limbs [12, 32, R]."""
    return tfp.canon_std(f.reshape(12, 32, f.shape[-1])).numpy()


@pytest.fixture(scope="module")
def plain_pairs():
    """The plain Miller loop and pairing over two rows: (P1, Q1) and
    (∞, Q1)."""
    p, q = _g1([P1, None]), _g2([Q1, Q1])
    f = tpair.miller_loop(p, q)
    return p, q, f, tpair.final_exponentiate(f)


def test_miller_loop_bit_identical_to_jax(plain_pairs):
    _, _, f, _ = plain_pairs
    want = jax.jit(jpair.miller_loop)(
        jnp.asarray(jcurve.g1_pack([P1, None])),
        jnp.asarray(jcurve.g2_pack([Q1, Q1])))
    np.testing.assert_array_equal(convert.elems_to_jax(f.numpy()),
                                  np.asarray(want))


def test_pairing_is_the_oracle_cubed(plain_pairs):
    _, _, _, e = plain_pairs
    want = refpair.pairing(P1, Q1) ** 3
    packed = ttower.f12_pack([want])                 # [2, 3, 2, 32, 1]
    np.testing.assert_array_equal(_canon(e)[..., :1],
                                  packed.reshape(12, 32, 1))
    # an ∞ member pairs to one
    assert tpair.is_one(e).numpy().tolist() == [False, True]


def test_kernel_rows_equal_the_plain_loop_after_final_exp(plain_pairs):
    p, q, _, e = plain_pairs
    p_side = cp.g1_proj_rows(p[..., :1].contiguous())
    q_side = cp.g2_affine_rows(q[..., :1].contiguous())
    row = cp.miller_rows(p_side, q_side).reshape(2, 3, 2, 32, 1)
    got = tpair.final_exponentiate(ttower.f12_conj(row))
    np.testing.assert_array_equal(_canon(got), _canon(e)[..., :1])


def test_product_check_accepts_a_signature_and_rejects_a_forgery():
    msg = b"charon-tpu-torch pairing math"
    sk = 0x1234567
    pk = jbls.sk_to_pk(sk)
    sig = jbls.sign(sk, msg)
    forged = jbls.sign(sk + 1, msg)
    from charon_tpu.tbls.ref.hash_to_curve import hash_to_g2
    hm = hash_to_g2(msg)
    neg_g1 = refcurve.neg(refcurve.G1_GEN)
    ps = torch.stack([_g1([neg_g1, neg_g1]), _g1([pk, pk])])
    qs = torch.stack([_g2([sig, forged]), _g2([hm, hm])])
    got = tpair.pairing_product_is_one(ps, qs).numpy().tolist()
    assert got == [True, False]
    assert got == [jbls.verify(pk, msg, sig), jbls.verify(pk, msg, forged)]
