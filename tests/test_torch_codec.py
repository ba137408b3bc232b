"""The port's G2 codec (charon_tpu_torch.ops.codec) against the JAX
package's ops/codec.py, bit for bit: byte split, device decompression
(Fp2 square root + ψ subgroup check), normalisation and compression.

Rows: valid signatures, ∞, malformed flag bytes, x ≥ p, an x off the
curve, and the cofactor point of `codec._find_g2_cofactor_point` (on the
curve, outside G2).  Every row — the rejected ones too — runs the same
field arithmetic in both, so points and flags compare exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.ops import codec as jcodec
from charon_tpu.tbls.ref import curve as refcurve
from charon_tpu.tbls.ref.fields import FQ2, P
from charon_tpu_torch import convert
from charon_tpu_torch.ops import codec as tcodec


def _raw_rows() -> tuple[np.ndarray, list[str]]:
    rows, kinds = [], []

    def put(b: bytes, kind: str) -> None:
        rows.append(np.frombuffer(b, np.uint8))
        kinds.append(kind)

    for k in (5, 77, 2**200 + 3):
        put(refcurve.g2_to_bytes(refcurve.multiply(refcurve.G2_GEN, k)),
            "valid")
    put(refcurve.g2_to_bytes(None), "inf")
    good = refcurve.g2_to_bytes(refcurve.multiply(refcurve.G2_GEN, 9))
    put(bytes([good[0] & 0x7F]) + good[1:], "no_c_flag")
    put(bytes([0xE0]) + bytes(95), "inf_with_sign")
    put(bytes([0xC0]) + bytes(94) + b"\x01", "inf_with_data")
    put(bytes([0x80 | (P >> 376)]) + (P % 2**376).to_bytes(47, "big")
        + (1).to_bytes(48, "big"), "x_ge_p")
    x = 1
    while (FQ2([x, 0]) ** 3 + refcurve.B2).sqrt() is not None:
        x += 1
    put(bytes([0x80]) + bytes(47) + x.to_bytes(48, "big"), "off_curve")
    cof = jcodec._find_g2_cofactor_point()
    put(refcurve.g2_to_bytes(cof), "cofactor")
    return np.stack(rows), kinds


RAW, KINDS = _raw_rows()


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(convert.elems_from_jax(a))


@pytest.fixture(scope="module")
def split():
    port = tcodec.g2_bytes_split(RAW)
    ref = jcodec.g2_bytes_split(RAW)
    return port, ref


def test_byte_split_equals_jax(split):
    port, ref = split
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    bad = dict(zip(KINDS, port[4]))
    assert not bad["valid"] and not bad["inf"] and not bad["off_curve"]
    assert bad["no_c_flag"] and bad["inf_with_sign"] and bad["x_ge_p"]
    assert bad["inf_with_data"]


@pytest.fixture(scope="module")
def decompressed(split):
    (xc0, xc1, sign, inf, _), _ = split
    port = tcodec.g2_decompress(_t(xc0), _t(xc1), torch.from_numpy(sign),
                                torch.from_numpy(inf))
    ref = jax.jit(jcodec.g2_decompress)(
        jnp.asarray(xc0), jnp.asarray(xc1), jnp.asarray(sign),
        jnp.asarray(inf))
    return port, ref


def test_decompress_bit_identical(decompressed):
    (pt, ok), (jpt, jok) = decompressed
    np.testing.assert_array_equal(convert.elems_to_jax(pt.numpy()),
                                  np.asarray(jpt))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    verdict = dict(zip(KINDS, ok.numpy()))
    assert verdict["valid"] and verdict["inf"]
    assert not verdict["off_curve"] and not verdict["cofactor"]


def test_subgroup_check_rejects_only_the_cofactor_point(split):
    """The cofactor row is on the curve (sqrt succeeds) but not in G2."""
    (xc0, xc1, sign, inf, _), _ = split
    pt, ok = tcodec.g2_decompress(_t(xc0), _t(xc1), torch.from_numpy(sign),
                                  torch.from_numpy(inf), subgroup_check=False)
    verdict = dict(zip(KINDS, ok.numpy()))
    assert verdict["cofactor"] and not verdict["off_curve"]


def test_normalize_and_compress_round_trip(decompressed):
    (pt, ok), (jpt, _) = decompressed
    port = tcodec.g2_normalize(pt)
    ref = jax.jit(jcodec.g2_normalize)(jpt)
    for a, b in zip(port[:4], ref[:4]):
        np.testing.assert_array_equal(convert.elems_to_jax(a.numpy()),
                                      np.asarray(b))
    np.testing.assert_array_equal(port[4].numpy(), np.asarray(ref[4]))
    out = tcodec.g2_compress_np(*[convert.elems_to_jax(a.numpy())
                                  for a in port[:4]], port[4].numpy())
    np.testing.assert_array_equal(
        out, jcodec.g2_compress_np(*[np.asarray(a) for a in ref]))
    for k, kind in enumerate(KINDS):
        if kind in ("valid", "inf", "cofactor"):
            assert out[k].tobytes() == RAW[k].tobytes(), kind
