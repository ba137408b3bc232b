"""The resident verify route on the CPU: `CUDABackend(device="cpu",
resident=True)` — the device stores of tbls/devcache.py as CPU tensors,
the verify tile as one call of `_verify_tile` (the function the card
captures into a CUDA graph), every kernel wrapper on its plain version.

A mixed flush through the port's BatchVerifier — valid entries, a wrong
message, another key's signature, malformed signature bytes, a
wrong-length entry and a pubkey whose x is off the curve — gets the JAX
oracle's verdicts and the bytes route's, row for row, and its gathered
pubkey and H(m) rows equal the bytes route's planes bit for bit; the
same entries again miss neither store.  A raising kernel raises, with no
fallback to the bytes route, and every replay reads fresh RLC windows.
(Eviction, overflow and prewarm: tests/test_torch_resident_cache.py.)
"""

import asyncio

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.tbls import api as japi
from charon_tpu_torch.core.verify import BatchVerifier
from charon_tpu_torch.ops import cuda_codec
from charon_tpu_torch.tbls import api as tapi
from charon_tpu_torch.tbls import backend_cuda, devcache
from charon_tpu_torch.tbls.ref import bls, curve as rc
from charon_tpu_torch.tbls.ref.fields import FQ

M1, M2 = b"charon-tpu-torch resident: slot 7", \
    b"charon-tpu-torch resident: slot 8"
SKS = (0x1111, 0x2222222, 0x333333333)
PKS = [rc.g1_to_bytes(bls.sk_to_pk(sk)) for sk in SKS]
#: 128 rows a store (the smallest capacity: one column)
SMALL_MB = 128 * (3 + 6) * 32 * 4 / 2 ** 20


def _sig(sk: int, msg: bytes) -> bytes:
    return rc.g2_to_bytes(bls.sign(sk, msg))


def _off_curve_pk() -> bytes:
    """A compressed G1 encoding whose x has no y: x³ + 4 not a square."""
    x = next(x for x in range(1, 100)
             if (FQ(x) ** 3 + FQ(4)).sqrt() is None)
    raw = bytearray(x.to_bytes(48, "big"))
    raw[0] |= 0x80
    with pytest.raises(ValueError):
        rc.g1_from_bytes(bytes(raw))
    return bytes(raw)


def _mixed_entries():
    s11 = _sig(SKS[0], M1)
    entries = [
        (PKS[0], M1, s11),                              # valid
        (PKS[1], M1, _sig(SKS[1], M1)),                 # valid
        (PKS[0], M1, _sig(SKS[0], M2)),                 # wrong message
        (PKS[1], M2, _sig(SKS[2], M2)),                 # another key's sig
        (PKS[2], M2, _sig(SKS[2], M2)),                 # valid
        (PKS[0], M1, bytes([s11[0] & 0x7F]) + s11[1:]),  # malformed sig
        (PKS[0][:47], M1, s11),                         # wrong length
        (_off_curve_pk(), M1, s11),                     # x off the curve
    ]
    return entries


@pytest.fixture(scope="module")
def resident():
    """A resident backend on the CPU (128-row stores) as the API's
    "cuda" backend, the JAX oracle on "cpu"."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "_BACKENDS", dict(tapi._BACKENDS))
        mp.setattr(tapi, "_current_name", tapi._current_name)
        be = backend_cuda.CUDABackend(device="cpu", resident=True,
                                      devcache_mb=SMALL_MB)
        tapi.register_backend("cuda", be)
        tapi.set_backend("cuda")
        japi.set_backend("cpu")
        yield be


@pytest.fixture(scope="module")
def mixed(resident):
    """The mixed flush through BatchVerifier on the resident route, and the
    same entries through the bytes route's stages."""
    entries = _mixed_entries()
    verifier = BatchVerifier()
    got = asyncio.run(verifier.verify_many(entries))
    stats = resident.devcache_stats()
    stages = dict(resident.last_stages)
    bytes_be = backend_cuda.CUDABackend(device="cpu")
    prep_b = bytes_be.verify_host_prep(entries, np.random.default_rng(3))
    got_bytes = bytes_be.verify_device_exec(prep_b)
    return entries, got, got_bytes, stats, stages, verifier, prep_b


def test_mixed_flush_equals_the_oracle_and_the_bytes_route(mixed):
    entries, got, got_bytes, _, _, _, _ = mixed
    assert got == japi.batch_verify(entries) == got_bytes
    assert got == [True, True, False, False, True, False, False, False]


def test_mixed_flush_ran_the_resident_route(mixed, resident):
    _, _, _, stats, stages, verifier, _ = mixed
    assert verifier.paths == {"cuda-rlc+h2c-dev+res": 1}
    assert tapi.devcache_path() == "resident"
    # no per-kernel laps: the tile is one graph stage, then the re-check
    assert {"devcache_gather_s", "graph_s", "recheck_s"} <= set(stages)
    assert not {"sig_decompress_s", "miller_s"} & set(stages)
    assert stats["enabled"] and stats["path"] == "resident"
    # 4 distinct keys decode (one off the curve is cached with ok False),
    # 2 distinct messages
    assert stats["pk"]["rows"] == 4 and stats["hm"]["rows"] == 2
    assert stats["pk"]["capacity_rows"] == stats["hm"]["capacity_rows"] \
        == devcache.LANES
    assert "resident:rlc:v=8" in backend_cuda.resident_graph_keys()


def test_gathered_rows_equal_the_bytes_planes(mixed, resident):
    entries, _, _, _, _, _, prep_b = mixed
    prep_r = resident.verify_host_prep(entries, np.random.default_rng(3))
    assert prep_r["kind"] == "resident"
    np.testing.assert_array_equal(prep_r["pks"].numpy(), prep_b["pks"])
    np.testing.assert_array_equal(prep_r["hms"].numpy(), prep_b["hms"])
    for key in ("host_ok", "windows", "xc0", "xc1", "sign", "inf"):
        np.testing.assert_array_equal(prep_r[key], prep_b[key])


def test_a_second_flush_misses_neither_store(mixed, resident):
    entries = mixed[0]
    before = resident.devcache_stats()
    prep = resident.verify_host_prep(entries)
    after = resident.devcache_stats()
    for store in ("pk", "hm"):
        assert after[store]["misses"] == before[store]["misses"]
        assert after[store]["hits"] - before[store]["hits"] == 7
    assert "pk_decompress_s" not in prep["stages"]
    assert not {"h2c_s", "h2c_py_s"} & set(prep["stages"])


def test_a_raising_kernel_raises_with_no_fallback(mixed, resident,
                                                  monkeypatch):
    entries = mixed[0]

    def refuse(*_a, **_k):
        raise RuntimeError("g2_decompress: kernel launch failed")

    def no_bytes_route(*_a, **_k):
        raise AssertionError("the bytes route was taken")

    monkeypatch.setattr(cuda_codec, "g2_decompress", refuse)
    for name in ("_pk_planes_cached", "_hash_points"):
        monkeypatch.setattr(backend_cuda.CUDABackend, name, no_bytes_route)
    prep = resident.verify_host_prep(entries)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        resident.verify_device_exec(prep)


def test_rlc_windows_are_fresh_per_replay(mixed, resident, monkeypatch):
    """Every run of the tile reads the windows its own prep drew: they go
    into the bucket's static input before each run, never baked in."""
    entries = mixed[0][:2]
    seen = []

    def tile_spy(pks, hms, xc0, xc1, sign, inf, host_live, windows, *_):
        seen.append(windows.clone())
        v = pks.shape[-1]
        return (torch.ones(v + 1, dtype=torch.bool),
                torch.zeros((3, 2, 32, v), dtype=torch.int32), host_live)

    monkeypatch.setattr(backend_cuda, "_verify_tile", tile_spy)
    preps = [resident.verify_host_prep(entries) for _ in range(2)]
    for p in preps:
        assert resident.verify_device_exec(p) == [True, True]
    assert len(seen) == 2
    for w, p in zip(seen, preps):
        np.testing.assert_array_equal(w.numpy(), p["windows"])
    assert not torch.equal(seen[0], seen[1])
