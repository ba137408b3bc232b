"""Kernel K12's plain version (charon_tpu_torch.ops.cuda_codec.
g2_decompress_plain) against the JAX package's ops/codec.g2_decompress
(jitted on the CPU, as the JAX package's own codec tests run it) and the
port's codec copy: identical ok flags and equal canonical coordinates, on
valid signatures of both signs, ∞, x off the curve and on-curve points
outside G2 (the cofactor point of `codec._find_g2_cofactor_point` and its
negation).  K12 computes the same field values in another order (Fp2
squarings, no additions of zero windows), so the points are value-equal,
not bit-equal.  The wrapper's CPU route and its input checks.
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
from charon_tpu.tbls.ref.fields import FQ2
from charon_tpu_torch import convert
from charon_tpu_torch.ops import codec as tcodec
from charon_tpu_torch.ops import cuda_codec as ccodec
from charon_tpu_torch.ops import fp as tfp


def _raw_rows() -> tuple[np.ndarray, list[str]]:
    rows, kinds = [], []

    def put(b: bytes, kind: str) -> None:
        rows.append(np.frombuffer(b, np.uint8))
        kinds.append(kind)

    for k in (3, 5, 77, 2**200 + 3):
        put(refcurve.g2_to_bytes(refcurve.multiply(refcurve.G2_GEN, k)),
            "valid")
    put(refcurve.g2_to_bytes(None), "inf")
    x, found = 1, 0
    while found < 2:
        if (FQ2([x, 0]) ** 3 + refcurve.B2).sqrt() is None:
            put(bytes([0x80 | (0x20 * found)]) + bytes(47)
                + x.to_bytes(48, "big"), "off_curve")
            found += 1
        x += 1
    cof = jcodec._find_g2_cofactor_point()
    put(refcurve.g2_to_bytes(cof), "off_group")
    put(refcurve.g2_to_bytes(refcurve.neg(cof)), "off_group")
    return np.stack(rows), kinds


RAW, KINDS = _raw_rows()


@pytest.fixture(scope="module")
def split():
    xc0, xc1, sign, inf, bad = tcodec.g2_bytes_split(RAW)
    assert not bad.any()
    return xc0, xc1, sign, inf


@pytest.fixture(scope="module")
def plain(split):
    xc0, xc1, sign, inf = split
    return ccodec.g2_decompress_plain(
        torch.from_numpy(np.ascontiguousarray(xc0.T)),
        torch.from_numpy(np.ascontiguousarray(xc1.T)),
        torch.from_numpy(sign), torch.from_numpy(inf))


def _canon_points(pts: torch.Tensor) -> np.ndarray:
    """[3, 2, 32, R] → canonical limbs [6, 32, R]."""
    return tfp.canon_std(pts.reshape(6, 32, pts.shape[-1])).numpy()


def test_rows_cover_both_signs(split):
    _, _, sign, _ = split
    valid = [s for s, k in zip(sign, KINDS) if k == "valid"]
    assert any(valid) and not all(valid)


def test_plain_version_equals_jax(split, plain):
    xc0, xc1, sign, inf = split
    jpt, jok = jax.jit(jcodec.g2_decompress)(
        jnp.asarray(xc0), jnp.asarray(xc1), jnp.asarray(sign),
        jnp.asarray(inf))
    pts, ok = plain
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    want = torch.from_numpy(convert.elems_from_jax(np.asarray(jpt)))
    np.testing.assert_array_equal(_canon_points(pts), _canon_points(want))
    assert [bool(o) for o in ok] == [k in ("valid", "inf") for k in KINDS]


def test_plain_version_equals_the_port_codec(split, plain):
    xc0, xc1, sign, inf = split
    tpts, tok = tcodec.g2_decompress(
        torch.from_numpy(np.ascontiguousarray(xc0.T)),
        torch.from_numpy(np.ascontiguousarray(xc1.T)),
        torch.from_numpy(sign), torch.from_numpy(inf))
    pts, ok = plain
    np.testing.assert_array_equal(ok.numpy(), tok.numpy())
    np.testing.assert_array_equal(_canon_points(pts), _canon_points(tpts))


def test_valid_rows_round_trip_to_their_bytes(plain):
    pts, _ = plain
    xc0, xc1, yc0, yc1, inf = tcodec.g2_normalize(pts)
    out = tcodec.g2_compress_np(*[a.numpy().T for a in (xc0, xc1, yc0, yc1)],
                                inf.numpy())
    for k, kind in enumerate(KINDS):
        if kind in ("valid", "inf", "off_group"):
            assert out[k].tobytes() == RAW[k].tobytes(), kind


def test_wrapper_takes_the_plain_path_on_the_cpu(split, plain):
    xc0, xc1, sign, inf = split
    args = [torch.from_numpy(np.ascontiguousarray(a.T)) for a in (xc0, xc1)]
    flags = [torch.from_numpy(sign), torch.from_numpy(inf)]
    ccodec.reset_launches()
    pts, ok = ccodec.g2_decompress(*args, *flags)
    np.testing.assert_array_equal(pts.numpy(), plain[0].numpy())
    np.testing.assert_array_equal(ok.numpy(), plain[1].numpy())
    assert ccodec.LAUNCHES == {"g2_decompress": 0, "g2_normalize": 0,
                               "g1_decompress": 0}
    with pytest.raises(ValueError):
        ccodec.g2_decompress(*args, flags[0].to(torch.int32), flags[1])
    with pytest.raises(ValueError):
        ccodec.g2_decompress(args[0].long(), args[1], *flags)
    with pytest.raises(ValueError):
        ccodec.g2_decompress(*[a.to("meta") for a in args + flags])


def test_subgroup_windows_start_at_a_set_window():
    """[|z|]Q starts from the top window's table entry and adds only the
    set windows: the same group element as curve.scalar_mul's 32 windows."""
    assert ccodec.Z_WINDOWS[0] == 3
    assert sum(w << (62 - 2 * i) for i, w in enumerate(ccodec.Z_WINDOWS)) \
        == ccodec.ABS_Z
    assert ccodec.Z_NEG


# ---------------------------------------------------------------------------
# the redesigned K12: windowed pows, the α = −1 rows, the lanes a row
# ---------------------------------------------------------------------------

import chip_smoke  # noqa: E402
from charon_tpu_torch.ops import tower as ttower  # noqa: E402
from charon_tpu_torch.tbls.ref.fields import P  # noqa: E402


def _split_rows(raw: list[bytes]):
    xc0, xc1, sign, inf, bad = tcodec.g2_bytes_split(
        np.stack([np.frombuffer(b, np.uint8) for b in raw]))
    assert not bad.any()
    return xc0, xc1, sign, inf


@pytest.fixture(scope="module")
def edge_rows():
    """Two x whose root has α = −1 (chip_smoke.alpha_m1_rows' seeded
    search: x1 at random, x0 = √((x1³ − 4)/(3·x1)) so that rhs ∈ Fp, kept
    where rhs^((p−1)/2) = −1), a valid signature of each sign, and an x
    of all-LMAX limbs (a redundant residue) with the sign set."""
    raw = chip_smoke.alpha_m1_rows(2) + [RAW[0].tobytes(), RAW[1].tobytes()]
    xc0, xc1, sign, inf = _split_rows(raw)
    lmax = np.full((1, 32), tfp.LMAX, dtype=xc0.dtype)
    return (np.concatenate([xc0, lmax]), np.concatenate([xc1, lmax]),
            np.append(sign, True), np.append(inf, False))


def test_alpha_minus_one_rows_take_the_skip(edge_rows):
    xc0, xc1, _, _ = edge_rows
    for k in range(2):
        x = FQ2([tfp.from_limbs(xc0[k]), tfp.from_limbs(xc1[k])])
        rhs = x ** 3 + refcurve.B2
        assert rhs.coeffs[1] == 0
        assert rhs ** ((P - 1) // 2) == FQ2([P - 1, 0])


def test_edge_rows_equal_jax_within_lmax(edge_rows):
    """The α = −1 rows (on the curve, outside G2), both signs and the
    all-LMAX x: points by value and ok flags as JAX's g2_decompress, every
    output limb within [0, LMAX]."""
    xc0, xc1, sign, inf = edge_rows
    pts, ok = ccodec.g2_decompress_plain(
        torch.from_numpy(np.ascontiguousarray(xc0.T)),
        torch.from_numpy(np.ascontiguousarray(xc1.T)),
        torch.from_numpy(sign), torch.from_numpy(inf))
    jpt, jok = jax.jit(jcodec.g2_decompress)(
        jnp.asarray(xc0), jnp.asarray(xc1), jnp.asarray(sign),
        jnp.asarray(inf))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.tolist()[:4] == [False, False, True, True]
    want = torch.from_numpy(convert.elems_from_jax(np.asarray(jpt)))
    np.testing.assert_array_equal(_canon_points(pts), _canon_points(want))
    assert int(pts.min()) >= 0 and int(pts.max()) <= tfp.LMAX


def test_output_limbs_within_lmax(plain):
    """K12's points feed K20, K15, K13, K22 and K16, which take limbs up
    to LMAX."""
    pts, _ = plain
    assert int(pts.min()) >= 0 and int(pts.max()) <= tfp.LMAX


def test_windowed_pow_equals_the_tower_pow():
    """The 3-bit-window pow (the kernel's, MSB first) against the tower's
    square-and-multiply by value, on random and all-LMAX rows."""
    rng = np.random.default_rng(77)
    a = torch.from_numpy(rng.integers(0, tfp.LMAX + 1, (2, 32, 3),
                                      dtype=np.int32))
    a[..., 0] = tfp.LMAX
    for e in (ccodec.EXP_P34, ccodec.EXP_P12, 5, 8):
        got = ccodec._f2_pow_w3((a[0], a[1]), e)
        want = ttower.f2_pow_fixed(a, e)
        np.testing.assert_array_equal(
            tfp.canon_std(torch.stack(got)).numpy(),
            tfp.canon_std(want).numpy())


def test_lanes_a_row_rule():
    """K12 runs a row on 16 lanes up to DECOMPRESS_WIDE_ROWS rows (a
    verify tile, the chaos and cluster tiles, a combine of 3 shares), on 8
    above (combines of 4 and of a DKG's 7 shares, the combine's 71,680
    rows); the contract audit's shapes name the same instantiation."""
    from charon_tpu_torch.analysis import registry
    from charon_tpu_torch.tbls import backend_cuda

    wide = ccodec.DECOMPRESS_WIDE_ROWS
    assert [ccodec.decompress_lanes(n) for n in (1, 4, 2048, 3072, wide)] \
        == [16] * 5
    assert [ccodec.decompress_lanes(n)
            for n in (wide + 1, 4096, 7168, 71_680)] == [8] * 4
    assert ccodec.decompress_kernel_name(71_680) \
        == "decompress.cu g2_decompress_kernel<8>"
    names = {s.name for s in registry.kernels()}
    assert {ccodec.decompress_kernel_name(n) for n in (1, 71_680)} <= names
    assert ccodec.decompress_kernel_name(2048) in \
        backend_cuda._verify_shape_rows(2048)
    assert ccodec.decompress_kernel_name(71_680) in \
        backend_cuda._combine_shape_rows(10_000, 7)
