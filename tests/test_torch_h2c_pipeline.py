"""The port's whole device hash-to-G2 pipeline (cuda_h2c.hash_to_g2_rows:
SSWU, the two square-root chains, the inversion chain, sign fix, isogeny,
the two-point addition and the ψ cofactor clearing, their group law in
two K22 programs) on the CPU, with the kernels' plain versions, against
the JAX package's pallas_h2c.hash_to_g2_rows in DIRECT mode, bit for bit,
at pad = 128 messages (256 u rows), and after normalisation against the
JAX package's pure-Python `hash_to_g2`.

One batch holds the five RFC 9380 J.10.1 messages under the QUUX DST,
eleven random messages under the eth2 DST, and 112 padding messages whose
u values are 0 (the exceptional SSWU row: JAX's packing flags it on the
host, the port's K24 derives the flag from u).  The pipeline runs once per
package, in a module-scoped fixture.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.ops import pallas_g2, pallas_h2c
from charon_tpu.tbls.ref import curve as jrc, sswu as jsswu
from charon_tpu.tbls.ref.fields import FQ2 as JFQ2
from charon_tpu.tbls.ref.hash_to_curve import DST_G2, hash_to_g2
from charon_tpu_torch import convert
from charon_tpu_torch.ops import cuda_g2, cuda_h2c, curve as tcurve, fp
from charon_tpu_torch.tbls import backend_cuda

PAD = 128
J101_DST = b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_RO_"
J101_MSGS = [b"", b"abc", b"abcdef0123456789", b"q128_" + b"q" * 128,
             b"a512_" + b"a" * 512]
RANDOM_MSGS = [bytes(np.random.default_rng(k).integers(0, 256, 8 + 5 * k,
                                                       dtype=np.uint8))
               for k in range(11)]
MSGS = [(m, J101_DST) for m in J101_MSGS] + [(m, DST_G2)
                                             for m in RANDOM_MSGS]


def _packed():
    """JAX pack_messages rows of both DSTs spliced into one pad-128 batch:
    message k takes row k of each u half; the rest stay u = 0."""
    j101 = pallas_h2c.pack_messages(J101_MSGS, J101_DST, PAD)
    eth = pallas_h2c.pack_messages(RANDOM_MSGS, DST_G2, PAD)
    n5, nr = len(J101_MSGS), len(RANDOM_MSGS)
    out = []
    for j, e in zip(j101, eth):
        a = j.copy()
        for half in (0, PAD):
            a[half + n5:half + n5 + nr] = e[half:half + nr]
        out.append(a)
    return tuple(out)


@pytest.fixture(scope="module")
def outputs():
    u_rows, exc, sgn = _packed()
    pallas_g2.DIRECT = True
    try:
        fc = jnp.asarray(pallas_g2.fold_consts())
        hc = jnp.asarray(pallas_h2c.h2c_consts())
        ju, jexc, jsgn = convert.h2c_inputs_to_jax(
            *convert.h2c_inputs_from_jax(u_rows, exc, sgn))
        want = np.asarray(pallas_h2c.hash_to_g2_rows(
            fc, hc, jnp.asarray(ju), jnp.asarray(jexc), jnp.asarray(jsgn)))
    finally:
        pallas_g2.DIRECT = False
    pu, pexc, psgn = convert.h2c_inputs_from_jax(u_rows, exc, sgn)
    flags = [t.numpy() for t in cuda_h2c.sswu_flags_plain(
        torch.from_numpy(pu))]
    np.testing.assert_array_equal(flags[0], pexc)
    np.testing.assert_array_equal(flags[1], psgn)
    calls, saved = [], {k: getattr(cuda_g2, k) for k in ("g2_law", "dbl",
                                                         "add")}

    def spy(name):
        def wrapper(*args, **kw):
            calls.append(f"{name} {args[0]}" if name == "g2_law" else name)
            return saved[name](*args, **kw)
        return wrapper

    try:
        for k in saved:
            setattr(cuda_g2, k, spy(k))
        got = cuda_h2c.hash_to_g2_rows(torch.from_numpy(pu))
    finally:
        for k, fn in saved.items():
            setattr(cuda_g2, k, fn)
    return got, want, calls


def test_pipeline_bit_identical_to_jax(outputs):
    """A check of values, not of raw limbs, whatever the name says:
    every coordinate plane equals JAX's bit for bit after `canon_std`.
    The port's root and inversion programs (K18) split the Fp2 products
    JAX runs whole, so they compute the same values in other redundant
    limbs.  The normalised output, canonical, is held bit for bit in
    `test_normalised_points_equal_the_oracle` and in
    test_torch_h2c_chains.py."""
    got, want, _ = outputs
    assert tuple(got.shape) == (6, 32, PAD)
    want = torch.from_numpy(convert.points_from_jax(want))
    for c in range(6):
        assert torch.equal(fp.canon_std(got[c]), fp.canon_std(want[c])), c


def test_normalised_points_equal_the_oracle(outputs):
    got, _, _ = outputs
    planes = backend_cuda._affine_planes(cuda_g2.as_points(got)).numpy()
    for k, (msg, dst) in enumerate(MSGS):
        want = tcurve.g2_pack([_to_port(hash_to_g2(msg, dst))])[..., 0]
        np.testing.assert_array_equal(planes[..., k], want,
                                      err_msg=f"message {k}")


def test_u0_padding_rows_equal_the_oracle(outputs):
    """u₀ = u₁ = 0: h_eff·(map(0) + map(0)), the exceptional SSWU branch."""
    got, _, _ = outputs
    planes = backend_cuda._affine_planes(cuda_g2.as_points(got)).numpy()
    q = jsswu.map_to_g2(JFQ2.zero())
    want = tcurve.g2_pack([_to_port(jsswu.clear_cofactor_h_eff(
        jrc.add(q, q)))])[..., 0]
    for k in range(len(MSGS), PAD):
        np.testing.assert_array_equal(planes[..., k], want)


def test_group_law_runs_two_k22_programs_and_no_k2(outputs):
    """The halves' sum with its double, and the clearing's additions, are
    one K22 program each (`cuda_g2.g2_law`); K2 runs nowhere."""
    _, _, calls = outputs
    assert calls == ["g2_law pre", "g2_law post"]


def _to_port(pt):
    """A JAX-package oracle point → the port oracle's FQ2 types."""
    from charon_tpu_torch.tbls.ref.fields import FQ2

    if pt is None:
        return None
    return tuple(FQ2([int(c) for c in v.coeffs]) for v in pt)
