"""The resident route's stores under pressure, and the boot prewarm, on the
CPU (`CUDABackend(device="cpu", resident=True)`, 128-row stores, every
kernel wrapper on its plain version).

A flush whose 130 distinct keys outnumber the pubkey store evicts the
rows of an earlier flush and overflows by two keys, with every verdict
right; verifying the earlier flush then recomputes its evicted rows, and
every verdict is right.  `prewarm` seeds every pubshare, captures (on the
CPU: uses) the tile's bucket and runs one combine, so the next flush
decompresses no key.
"""

import asyncio

import pytest
import torch

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu_torch.ops import cuda_codec
from charon_tpu_torch.tbls import api as tapi
from charon_tpu_torch.tbls import backend_cuda, dispatch
from charon_tpu_torch.tbls.ref import bls, curve as rc
from charon_tpu_torch.tbls.ref.hash_to_curve import hash_to_g2

MSG = b"charon-tpu-torch resident cache: slot 9"
#: 128 rows a store (the smallest capacity: one column)
SMALL_MB = 128 * (3 + 6) * 32 * 4 / 2 ** 20


def _entries(sks: list[int]) -> list[tuple[bytes, bytes, bytes]]:
    h = hash_to_g2(MSG)
    return [(rc.g1_to_bytes(bls.sk_to_pk(sk)), MSG,
             rc.g2_to_bytes(rc.multiply(h, sk))) for sk in sks]


def test_eviction_and_overflow_keep_every_verdict_right():
    be = backend_cuda.CUDABackend(device="cpu", resident=True,
                                  devcache_mb=SMALL_MB)
    first = _entries([0x7001, 0x7002, 0x7003])
    crowd = _entries(list(range(0x8000, 0x8000 + 130)))
    be.verify_host_prep(first)          # the first flush's rows cached

    # 130 new keys into a 128-row store: the 3 older rows are evicted,
    # the commit's own 128 rows are protected, the last 2 keys overflow
    # and are spliced into the batch's rows directly
    assert be.batch_verify_bytes(crowd) == [True] * 130
    pk = be.devcache_stats()["pk"]
    assert (pk["rows"], pk["evictions"], pk["overflows"]) == (128, 3, 2)
    assert pk["misses"] == 3 + 130

    # the first flush: its evicted rows are recomputed
    assert be.batch_verify_bytes(first) == [True] * 3
    pk = be.devcache_stats()["pk"]
    assert pk["misses"] == 3 + 130 + 3 and pk["evictions"] == 6
    hm = be.devcache_stats()["hm"]
    assert (hm["rows"], hm["misses"], hm["hits"]) == (1, 3, 133)


@pytest.fixture
def small_tiles(monkeypatch):
    """Validators padded to 8 (the combine's rows stay small)."""
    monkeypatch.setattr(backend_cuda, "ROW_TILE", 8)


def test_prewarm_seeds_every_pubshare(small_tiles, monkeypatch):
    be = backend_cuda.CUDABackend(device="cpu", resident=True,
                                  devcache_mb=SMALL_MB)
    monkeypatch.setattr(tapi, "_BACKENDS", dict(tapi._BACKENDS))
    monkeypatch.setattr(tapi, "_current_name", tapi._current_name)
    tapi.register_backend("cuda", be)
    tapi.set_backend("cuda")
    entries = _entries([0x9001, 0x9002, 0x9003])
    pubshares = [pk for pk, _, _ in entries]

    pipe = dispatch.DispatchPipeline()
    try:
        report = asyncio.run(pipe.prewarm(pubshares, 2, 2))
    finally:
        pipe.shutdown()
    assert pipe.prewarmed is report
    assert report["devcache"] == "resident"
    assert (report["v"], report["t"], report["pubshares"]) == (2, 2, 3)
    assert report["verify_rows"] == 2
    assert report["verify_path"] == "cuda-rlc+h2c-dev+res"
    assert report["combine_path"] == "straus"
    assert "resident:rlc:v=2" in report["graph_keys"]
    assert be.devcache_stats()["pk"]["rows"] == 3

    calls = []
    real = cuda_codec.g1_decompress

    def spy(*args):
        calls.append(args[0].shape[-1])
        return real(*args)

    monkeypatch.setattr(cuda_codec, "g1_decompress", spy)
    prep = be.verify_host_prep(entries)
    assert calls == [] and "pk_decompress_s" not in prep["stages"]
    assert prep["host_ok"][:3].all()


def test_prewarm_skips_the_insecure_scheme_and_oracle_backend(monkeypatch):
    monkeypatch.setattr(tapi, "_current_name", tapi._current_name)
    tapi.set_scheme("insecure-test")
    try:
        assert tapi.prewarm([], 1, 1) == {"skipped": "insecure-test scheme"}
    finally:
        tapi.set_scheme("bls")
    tapi.set_backend("cpu")
    assert "skipped" in tapi.prewarm([], 1, 1)
    assert tapi.devcache_path() == "n/a"
    assert tapi.scheme_name() == "bls"
