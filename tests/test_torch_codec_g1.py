"""The port's G1 codec (charon_tpu_torch.ops.codec) against the JAX
package's ops/codec.py, bit for bit: byte split, device decompression (Fp
square root + [r]P subgroup check), normalisation and compression — and
the verdicts against the pure-Python deserialiser
(`charon_tpu.tbls.ref.curve.g1_from_bytes`).

Rows: valid keys, ∞, malformed flag bytes, x ≥ p, an x off the curve, and
a point on E(Fp) outside the r-order subgroup.  Every row — the rejected
ones too — runs the same field arithmetic in both, so points and flags
compare exactly.
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
from charon_tpu.tbls.ref.fields import FQ, P, R
from charon_tpu_torch import convert
from charon_tpu_torch.ops import codec as tcodec


def _off_subgroup_point():
    """An on-curve E(Fp) point outside G1 (the cofactor is large, so the
    first x with a square right-hand side gives one)."""
    x = 1
    while True:
        y = (FQ(x) ** 3 + 4).sqrt()
        if y is not None and refcurve.multiply_raw((FQ(x), y), R) is not None:
            return x, y
        x += 1


def _raw_rows() -> tuple[np.ndarray, list[str]]:
    rows, kinds = [], []

    def put(b: bytes, kind: str) -> None:
        rows.append(np.frombuffer(b, np.uint8))
        kinds.append(kind)

    for k in (3, 1000, 2**200 + 5):
        put(refcurve.g1_to_bytes(refcurve.multiply(refcurve.G1_GEN, k)),
            "valid")
    put(refcurve.g1_to_bytes(None), "inf")
    good = refcurve.g1_to_bytes(refcurve.multiply(refcurve.G1_GEN, 9))
    put(bytes([good[0] & 0x7F]) + good[1:], "no_c_flag")
    put(bytes([0xE0]) + bytes(47), "inf_with_sign")
    put(bytes([0xC0]) + bytes(46) + b"\x01", "inf_with_data")
    put(bytes([0x80 | (P >> 376)]) + (P % 2**376).to_bytes(47, "big"),
        "x_ge_p")
    x = 1
    while (FQ(x) ** 3 + 4).sqrt() is not None:
        x += 1
    put(bytes([0x80]) + x.to_bytes(48, "big")[1:], "off_curve")
    ox, oy = _off_subgroup_point()
    put(refcurve.g1_to_bytes((FQ(ox), oy)), "off_subgroup")
    return np.stack(rows), kinds


RAW, KINDS = _raw_rows()


@pytest.fixture(scope="module")
def split():
    return tcodec.g1_bytes_split(RAW), jcodec.g1_bytes_split(RAW)


def test_byte_split_equals_jax(split):
    port, ref = split
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    bad = dict(zip(KINDS, port[3]))
    assert not bad["valid"] and not bad["inf"] and not bad["off_curve"]
    assert bad["no_c_flag"] and bad["inf_with_sign"] and bad["x_ge_p"]
    assert bad["inf_with_data"] and not bad["off_subgroup"]


@pytest.fixture(scope="module")
def decompressed(split):
    (x, sign, inf, _), _ = split
    port = tcodec.g1_decompress(torch.from_numpy(np.ascontiguousarray(x.T)),
                                torch.from_numpy(sign), torch.from_numpy(inf))
    ref = jax.jit(jcodec.g1_decompress)(
        jnp.asarray(x), jnp.asarray(sign), jnp.asarray(inf))
    return port, ref


def test_decompress_bit_identical(decompressed):
    (pt, ok), (jpt, jok) = decompressed
    np.testing.assert_array_equal(convert.g1_to_jax(pt.numpy(), tiled=False),
                                  np.asarray(jpt))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


def test_verdicts_equal_the_oracle_deserialiser(split, decompressed):
    (_, _, _, bad), _ = split
    (_, ok), _ = decompressed
    for k, kind in enumerate(KINDS):
        try:
            refcurve.g1_from_bytes(RAW[k].tobytes())
            want = True
        except ValueError:
            want = False
        assert (bool(ok[k]) and not bad[k]) == want, kind
    verdict = dict(zip(KINDS, ok.numpy()))
    assert verdict["valid"] and verdict["inf"]
    assert not verdict["off_curve"] and not verdict["off_subgroup"]


def test_subgroup_check_rejects_only_the_off_subgroup_point(split):
    (x, sign, inf, _), _ = split
    _, ok = tcodec.g1_decompress(
        torch.from_numpy(np.ascontiguousarray(x.T)), torch.from_numpy(sign),
        torch.from_numpy(inf), subgroup_check=False)
    verdict = dict(zip(KINDS, ok.numpy()))
    assert verdict["off_subgroup"] and not verdict["off_curve"]


def test_normalize_and_compress_round_trip(decompressed):
    (pt, _), (jpt, _) = decompressed
    port = tcodec.g1_normalize(pt)
    ref = jax.jit(jcodec.g1_normalize)(jpt)
    for a, b in zip(port[:2], ref[:2]):
        np.testing.assert_array_equal(convert.elems_to_jax(a.numpy()),
                                      np.asarray(b))
    np.testing.assert_array_equal(port[2].numpy(), np.asarray(ref[2]))
    out = tcodec.g1_compress_np(*[convert.elems_to_jax(a.numpy())
                                  for a in port[:2]], port[2].numpy())
    np.testing.assert_array_equal(
        out, jcodec.g1_compress_np(*[np.asarray(a) for a in ref]))
    for k, kind in enumerate(KINDS):
        if kind in ("valid", "inf", "off_subgroup"):
            assert out[k].tobytes() == RAW[k].tobytes(), kind
