"""The port's multi-card combine (charon_tpu_torch.tbls.backend_cuda.
straus_combine_sharded) on CPU shards, against the JAX package's
backend_tpu, bit for bit, under pallas_g2.DIRECT (the plain route is what
DIRECT is there): at T = 2 the whole result against JAX's unsharded
`pallas_g2.straus_combine` over the batch; at T = 4 each shard's rows
against JAX's per-shard body (`_sharded_combine_local`) on the same slice
padded by JAX's rule — and the whole result against the body over the
whole batch where that fits one shard (the body is straus_combine over
what it is given).  JAX's `straus_combine_sharded` itself is not called:
under shard_map its test has aborted an xdist worker inside XLA, and its
per-device body is what each device computes.

32-bit scalars (12 windows, as tests/test_sharding.py's fused case).
Every DIRECT shape is a fresh XLA:CPU compile of a minute or more, and
a 1,024-row shard (the DIRECT granularity's least) seconds to run on
either side: each T's cases are prefixes of one batch, so that one JAX
function compiles once per T and runs once per distinct input
(module-level caches).  Also: the padding rule against JAX's,
`devices=None` without a card, and the multi-card dry run
(`multichip.dryrun_multichip`) on two CPU shards against the oracle.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.ops import curve as jcurve
from charon_tpu.ops import pallas_g2
from charon_tpu.tbls import backend_tpu
from charon_tpu_torch import convert, multichip
from charon_tpu_torch.ops import cuda_g2
from charon_tpu_torch.ops import curve as tcurve
from charon_tpu_torch.tbls import backend_cuda
from charon_tpu_torch.tbls.ref import curve as refcurve
from charon_tpu_torch.tbls.ref.hash_to_curve import hash_to_g2

NWIN = 12           # balanced base-8 digits of a 32-bit scalar
#: each T's batch: every case below is a prefix of it
MASTER_V = {2: 2048, 4: 768}
#: (T, shards, V): even V a multiple of shards × the granularity (512 at
#: T = 2, 256 at T = 4), uneven V not; every shard count has both
CASES = [(2, 1, 512), (2, 2, 700), (2, 4, 2048),
         (4, 1, 100), (4, 2, 512), (4, 4, 700)]


@pytest.fixture(autouse=True)
def direct_mode():
    pallas_g2.DIRECT = True
    yield
    pallas_g2.DIRECT = False


@functools.lru_cache(maxsize=None)
def _master(t: int) -> tuple[np.ndarray, np.ndarray]:
    """(points [3, 2, 32, V, t], digits [12, V, t]) in the port's layout:
    each validator's partials drawn from 8 distinct points, each with its
    own random 32-bit scalar."""
    v = MASTER_V[t]
    rng = np.random.default_rng(40 + t)
    pool = tcurve.g2_pack([refcurve.multiply(refcurve.G2_GEN, 3 + k)
                           for k in range(8)])
    pts = np.ascontiguousarray(pool[..., rng.integers(0, 8, (v, t))])
    scal = rng.integers(1, 2 ** 31, (v, t))
    bits = ((scal[..., None] >> np.arange(31, -1, -1)) & 1).astype(np.int32)
    digits = cuda_g2.signed_digit_rows(bits.reshape(v * t, 32))
    assert digits.shape[1] == NWIN
    return pts, np.ascontiguousarray(
        np.moveaxis(digits.reshape(v, t, NWIN), 2, 0))


@functools.lru_cache(maxsize=None)
def _jax_body(t: int):
    return jax.jit(backend_tpu._sharded_combine_local(t, NWIN))


@functools.lru_cache(maxsize=None)
def _jax_shard(t: int, lo: int, hi: int, v_local: int) -> np.ndarray:
    """JAX's per-shard body on validators [lo, hi) of T's batch, padded
    to v_local by JAX's rule (∞ points, zero digits) → [v_local, 3, 2,
    32]."""
    pts, digits = _master(t)
    p = convert.points_vt_to_jax(pts[..., lo:hi, :])
    d = convert.digits_vt_to_jax(digits[:, lo:hi, :])
    pad = v_local - (hi - lo)
    inf = jcurve.g2_pack([None])[0]
    p = np.concatenate([p, np.broadcast_to(inf, (pad, t, 3, 2, 32))])
    d = np.concatenate([d, np.zeros((pad, t, NWIN), np.int32)])
    return np.asarray(_jax_body(t)(jnp.asarray(p), jnp.asarray(d)))


@functools.lru_cache(maxsize=None)
def _jax_unsharded(t: int) -> np.ndarray:
    """JAX's unsharded straus_combine over T's whole batch (t-major rows,
    tiled) → [V, 3, 2, 32]."""
    pts, digits = _master(t)
    v = pts.shape[-2]

    def combine(p, d):
        rows = p.transpose(1, 0, 2, 3, 4).reshape(v * t, 3, 2, 32)
        dg = d.transpose(2, 1, 0).reshape(NWIN, (t * v) // 128, 128)
        out = pallas_g2.straus_combine(
            jnp.asarray(pallas_g2.fold_consts()),
            pallas_g2.tile_points(rows), dg, t)
        return pallas_g2.untile_points(out)

    return np.asarray(jax.jit(combine)(
        jnp.asarray(convert.points_vt_to_jax(pts)),
        jnp.asarray(convert.digits_vt_to_jax(digits))))


def _port_rows(points: torch.Tensor) -> np.ndarray:
    """[3, 2, 32, m] → JAX's limb-last [m, 3, 2, 32]."""
    return convert.points_to_jax(points.numpy().reshape(6, 32, -1),
                                 tiled=False)


@pytest.mark.parametrize("t,n,v", CASES)
def test_sharded_combine_bit_identical_to_jax(t, n, v):
    """T = 2: every row equals JAX's unsharded straus_combine over the
    batch.  T = 4: each shard's real rows equal JAX's per-shard body on
    its slice, and where the batch fits one shard (V ≤ 256) the whole
    result equals the body over the whole batch."""
    pts, digits = _master(t)
    devices = ["cpu"] * n
    got = backend_cuda.straus_combine_sharded(
        torch.from_numpy(pts[..., :v, :]),
        torch.from_numpy(digits[:, :v, :]), devices)
    assert tuple(got.shape) == (3, 2, 32, v)
    got = _port_rows(got)
    # the plan is JAX's: v_local by its padding rule, contiguous shards
    gran = backend_tpu._v_granularity(t)
    v_local, spans = backend_cuda.shard_plan(v, t, devices)
    assert v_local == -(-max(1, -(-v // n)) // gran) * gran
    assert spans == [(min(j * v_local, v), min((j + 1) * v_local, v))
                     for j in range(n)]
    assert (v % (n * gran) == 0) == (v_local * n == v)
    if t == 2:
        np.testing.assert_array_equal(got, _jax_unsharded(t)[:v])
        return
    for lo, hi in spans:
        if hi > lo:
            ref = _jax_shard(t, lo, hi, v_local)
            np.testing.assert_array_equal(got[lo:hi], ref[:hi - lo])
    if v <= v_local:
        np.testing.assert_array_equal(got, _jax_shard(t, 0, v, v_local)[:v])


def test_shard_body_with_its_pad_rows_bit_identical_to_jax():
    """One shard whole, its pad rows too: the port's padded inputs
    (`shard_inputs`) through its body against JAX's body on JAX's padded
    slice (T = 4: validators 512..699 of a 256-validator shard)."""
    t, lo, hi = 4, 512, 700
    pts, digits = _master(t)
    v_local = backend_cuda._v_granularity(t, "cpu")
    p, d = backend_cuda.shard_inputs(torch.from_numpy(pts[..., lo:hi, :]),
                                     torch.from_numpy(digits[:, lo:hi, :]),
                                     v_local, torch.device("cpu"))
    got = backend_cuda._sharded_combine_local(t, NWIN)(p, d)
    np.testing.assert_array_equal(_port_rows(got),
                                  _jax_shard(t, lo, hi, v_local))


@pytest.mark.parametrize("direct", [True, False])
def test_v_granularity_equals_jax(direct):
    """The CPU's rule is JAX's DIRECT one, the card's its tile rule."""
    pallas_g2.DIRECT = direct
    device = "cpu" if direct else "cuda"
    for t in (1, 2, 3, 4, 7, 8, 16, 32, 1024, 2048):
        gran = backend_cuda._v_granularity(t, device)
        assert gran == backend_tpu._v_granularity(t), t
        assert (t * gran) % 1024 == 0 and gran % 128 == 0
    assert backend_cuda._v_granularity(7, "cuda") == backend_cuda.ROW_TILE


def test_devices_none_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = torch.zeros((3, 2, 32, 1, 2), dtype=torch.int32)
    digits = torch.zeros((NWIN, 1, 2), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backend_cuda.straus_combine_sharded(pts, digits)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multichip.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multichip.entry()
    with pytest.raises(ValueError, match="more than one kind"):
        backend_cuda.shard_devices(["cpu", "cuda:0"])


def test_dryrun_multichip_on_two_cpu_shards():
    """The audit with its shard pass at two CPU shards, the sharded combine
    of two validators' 2-of-2 partials, the plain verify of each on its
    shard: every verdict true, every signature the oracle's sk·H(m)."""
    report = multichip.dryrun_multichip(2, devices=["cpu", "cpu"])
    assert report["verdicts"] == [True, True]
    audit = report["audit"]
    assert audit.ok and [c.devices for c in audit.shard_cases] \
        == [["cpu", "cpu"]]
    hm = hash_to_g2(b"dryrun-attestation")
    assert tcurve.g2_unpack(report["combined"]) \
        == [refcurve.multiply(hm, 1000 + v) for v in range(2)]
