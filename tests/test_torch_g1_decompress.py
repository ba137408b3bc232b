"""Kernel K21 (the G1 pubkey decompression in one launch,
csrc/g1_decompress.cu): its CPU side.

- The plain version (`cuda_codec.g1_decompress_plain`, the kernel's
  sequence: the root by fp.pow_fixed's LSB-first schedule, the sign fix,
  from_affine, [r]P by 4-bit windows of r) against the JAX package's
  `codec.g1_decompress` (ops/codec.py :266): points bit for bit, and a
  verdict equal to JAX's ok with ∞ rows false (the backend's mask).  Rows:
  seed-made keys and their negations (both signs), ∞, an x off the curve
  and a point on E(Fp) outside G1.
- The verdicts against the pure-Python deserialiser; the windowed [r]P
  against codec's `g1_in_subgroup`; r's digits.
- The wrapper's CPU route and its checks; the backend's pubkey LRU
  (`CUDABackend._pk_planes_cached`, device="cpu") gives the planes and
  verdicts the K1 chain of `codec.g1_decompress` gave, malformed bytes
  included, with one K21 call per batch of misses and no K1 chain.
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
from charon_tpu_torch import convert
from charon_tpu_torch.ops import codec as tcodec, cuda_codec
from charon_tpu_torch.tbls import backend_cuda
from charon_tpu_torch.tbls.ref import curve as rc
from charon_tpu_torch.tbls.ref.fields import FQ, R

from test_torch_codec_g1 import _off_subgroup_point


def _rows() -> tuple[list[bytes], list[str]]:
    rows, kinds = [], []
    gen = np.random.default_rng(20261017)
    for k in gen.integers(1, 2**62, 5):
        pt = rc.multiply(rc.G1_GEN, int(k))
        rows += [rc.g1_to_bytes(pt), rc.g1_to_bytes(rc.neg(pt))]
        kinds += ["valid", "valid_neg"]
    rows.append(rc.g1_to_bytes(None))
    kinds.append("inf")
    x = 1
    while (FQ(x) ** 3 + 4).sqrt() is not None:
        x += 1
    rows.append(bytes([0x80]) + x.to_bytes(48, "big")[1:])
    kinds.append("off_curve")
    ox, oy = _off_subgroup_point()
    rows += [rc.g1_to_bytes((FQ(ox), oy)),
             rc.g1_to_bytes(rc.neg((FQ(ox), oy)))]
    kinds += ["off_subgroup", "off_subgroup_neg"]
    return rows, kinds


ROWS, KINDS = _rows()
RAW = np.stack([np.frombuffer(b, np.uint8) for b in ROWS])


def _tensors(raw=RAW):
    x, sign, inf, bad = tcodec.g1_bytes_split(raw)
    return (torch.from_numpy(np.ascontiguousarray(x.T)),
            torch.from_numpy(sign), torch.from_numpy(inf), bad)


@pytest.fixture(scope="module")
def decompressed():
    x, sign, inf, _ = _tensors()
    port = cuda_codec.g1_decompress_plain(x, sign, inf)
    jx, jsign, jinf, _ = jcodec.g1_bytes_split(RAW)
    ref = jax.jit(jcodec.g1_decompress)(
        jnp.asarray(jx), jnp.asarray(jsign), jnp.asarray(jinf))
    return port, (np.asarray(ref[0]), np.asarray(ref[1])), inf.numpy()


def test_points_bit_identical_to_jax(decompressed):
    (pt, _), (jpt, _), _ = decompressed
    assert tuple(pt.shape) == (3, 32, len(ROWS))
    np.testing.assert_array_equal(convert.g1_to_jax(pt.numpy(), tiled=False),
                                  jpt)


def test_verdicts_are_jax_ok_without_inf(decompressed):
    (_, ok), (_, jok), inf = decompressed
    np.testing.assert_array_equal(ok.numpy(), jok & ~inf)
    verdict = dict(zip(KINDS, ok.numpy()))
    assert verdict["valid"] and verdict["valid_neg"]
    assert not verdict["inf"] and not verdict["off_curve"]
    assert not verdict["off_subgroup"] and not verdict["off_subgroup_neg"]


def test_verdicts_equal_the_oracle_deserialiser(decompressed):
    (_, ok), _, _ = decompressed
    for k, kind in enumerate(KINDS):
        try:
            want = rc.g1_from_bytes(ROWS[k]) is not None
        except ValueError:
            want = False
        assert bool(ok[k]) == want, kind


def test_points_equal_the_k1_chain(decompressed):
    (pt, _), _, _ = decompressed
    x, sign, inf, _ = _tensors()
    want, _ = tcodec.g1_decompress(x, sign, inf)
    assert torch.equal(pt, want)


def test_windowed_r_multiple_is_the_subgroup_check(decompressed):
    """[r]P = ∞ by 4-bit windows, on every row's point (the off-curve
    row's too), against codec's 2-bit `g1_in_subgroup`."""
    (pt, _), _, _ = decompressed
    got = cuda_codec._g1_r_is_inf(pt)
    np.testing.assert_array_equal(got.numpy(),
                                  tcodec.g1_in_subgroup(pt).numpy())


def test_r_digits_and_exponents():
    d = cuda_codec.R_DIGITS
    assert sum(v << (4 * (len(d) - 1 - i)) for i, v in enumerate(d)) == R
    assert d[0] == 7 and len(d) == 64
    assert cuda_codec.EXP_P14 * 4 == tcodec.P + 1


def test_wrapper_takes_the_plain_path_on_the_cpu(decompressed):
    (pt, ok), _, _ = decompressed
    x, sign, inf, _ = _tensors()
    cuda_codec.reset_launches()
    got = cuda_codec.g1_decompress(x, sign, inf)
    assert torch.equal(got[0], pt) and torch.equal(got[1], ok)
    assert cuda_codec.LAUNCHES["g1_decompress"] == 0
    with pytest.raises(ValueError):
        cuda_codec.g1_decompress(x, sign.to(torch.int32), inf)
    with pytest.raises(ValueError):
        cuda_codec.g1_decompress(x[:, :3], sign, inf)
    with pytest.raises(ValueError):
        cuda_codec.g1_decompress(x.to(torch.int64), sign, inf)


def test_wrapper_raises_off_the_cpu_route():
    meta = torch.empty((32, 4), dtype=torch.int32, device="meta")
    flags = torch.empty(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_codec.g1_decompress(meta, flags, flags)


def _counted(calls: dict, fn):
    def wrapper(*args, **kw):
        calls["k21"] += 1
        return fn(*args, **kw)
    return wrapper


def _refuse(*_, **__):
    raise AssertionError("the K1 chain of codec.g1_decompress was called")


def test_pubkey_lru_gives_the_k1_chains_planes_and_verdicts(monkeypatch):
    """The backend's CPU route against what it computed before K21 (the K1
    chain, its ∞ mask and the host's malformed flags), with a malformed
    row; one K21 call for the batch of misses, none for hits, and one for
    a later batch with a new key."""
    bad_flag = bytes([ROWS[0][0] & 0x7F]) + ROWS[0][1:]
    keys = ROWS + [bad_flag]
    raw = np.stack([np.frombuffer(b, np.uint8) for b in keys])
    x, sign, inf, bad = _tensors(raw)
    pts, ok = tcodec.g1_decompress(x, sign, inf)
    want_ok = (ok & ~inf).numpy() & ~bad
    calls = {"k21": 0}
    monkeypatch.setattr(cuda_codec, "g1_decompress",
                        _counted(calls, cuda_codec.g1_decompress))
    monkeypatch.setattr(tcodec, "g1_decompress", _refuse)
    be = backend_cuda.CUDABackend(device="cpu")
    stages, launches = {}, {}
    planes, got_ok = be._pk_planes_cached(keys + keys[:3], stages, launches)
    assert calls["k21"] == 1 and "pk_decompress_s" in stages
    np.testing.assert_array_equal(planes[..., :len(keys)], pts.numpy())
    np.testing.assert_array_equal(planes[..., len(keys):],
                                  pts.numpy()[..., :3])
    np.testing.assert_array_equal(got_ok[:len(keys)], want_ok)
    assert not got_ok[len(keys) - 1]          # the malformed row
    be._pk_planes_cached(keys[:4], {}, {})
    assert calls["k21"] == 1 and be.pk_cache_hits == 4
    new = rc.g1_to_bytes(rc.multiply(rc.G1_GEN, 5))
    _, ok2 = be._pk_planes_cached([new, keys[0]], {}, {})
    assert calls["k21"] == 2 and ok2.all()
