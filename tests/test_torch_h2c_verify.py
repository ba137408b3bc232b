"""The verify path with the device hash-to-G2 behind its message cache:
the port's BatchVerifier → dispatch pipeline → CUDABackend on the CPU
(device="cpu", the kernels' plain versions), against the JAX package's
pure-Python oracle (tbls.api on its "cpu" backend).

A flush of nine entries with nine distinct messages — one entry signs
another message than it carries — hashes its misses in ONE device batch
on the host-prep thread, under the stage ``h2c_s`` (SHA-256 and
hash_to_field under ``h2c_host_s``), reports the ``h2c-dev`` route, and
gets the oracle's verdicts.  A batch of fewer than eight misses hashes on
the host, under ``h2c_py_s``; a failing h2c launch makes the verify raise, with no fallback
to host hashing.
"""

import asyncio
import threading

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.tbls import api as japi
from charon_tpu_torch.core.verify import BatchVerifier
from charon_tpu_torch.ops import cuda_h2c, curve as tcurve, launch_count
from charon_tpu_torch.tbls import api as tapi
from charon_tpu_torch.tbls import backend_cuda
from charon_tpu_torch.tbls.ref import bls, curve as rc
from charon_tpu_torch.tbls.ref.hash_to_curve import hash_to_g2

MSGS = [f"charon-tpu-torch h2c verify: duty {k}".encode() for k in range(9)]
SKS = [0x5151 + 7919 * k for k in range(8)]


def _entries() -> list:
    """Eight valid entries over eight messages, then one whose signature
    is over message 0 while it carries message 8."""
    out = [(rc.g1_to_bytes(bls.sk_to_pk(sk)), m,
            rc.g2_to_bytes(bls.sign(sk, m))) for sk, m in zip(SKS, MSGS)]
    pk0, _, s0 = out[0]
    return out + [(pk0, MSGS[8], s0)]


@pytest.fixture(scope="module")
def port_backend():
    """The port's "cuda" backend on the CPU, the JAX oracle on "cpu"."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "_BACKENDS", dict(tapi._BACKENDS))
        mp.setattr(tapi, "_current_name", tapi._current_name)
        be = backend_cuda.CUDABackend(device="cpu")
        tapi.register_backend("cuda", be)
        tapi.set_backend("cuda")
        japi.set_backend("cpu")
        yield be


@pytest.fixture(scope="module")
def flush(port_backend):
    """One verify_many of the nine entries; the h2c pipeline and its SSWU
    wrapper (K24) are watched (the wrapper counts a launch, as on the
    card)."""
    entries = _entries()
    threads = []
    real_rows, real_sswu = cuda_h2c.hash_to_g2_rows, cuda_h2c.h2c_sswu_head

    def rows_spy(*args):
        threads.append(threading.current_thread().name)
        return real_rows(*args)

    def sswu_spy(u, cfg=None):
        launch_count.bump(cuda_h2c.LAUNCHES, "h2c_sswu_head")
        return real_sswu(u, cfg)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_h2c, "hash_to_g2_rows", rows_spy)
        mp.setattr(cuda_h2c, "h2c_sswu_head", sswu_spy)
        port_backend.reset_verify_totals()
        verifier = BatchVerifier()
        got = asyncio.run(verifier.verify_many(entries))
    return (entries, got, verifier, threads,
            dict(port_backend.verify_totals),
            {k: dict(c) for k, c in port_backend.verify_launch_totals.items()})


def test_distinct_message_flush_equals_the_oracle(flush):
    entries, got, _, _, _, _ = flush
    assert got == japi.batch_verify(entries)
    assert got == [True] * 8 + [False]


def test_misses_hash_on_the_card_route(port_backend, flush):
    """Nine distinct misses: ONE device batch on the host-prep thread,
    timed as h2c_s apart from its host half, with its launches counted
    in that stage; the route is h2c-dev."""
    _, _, verifier, threads, totals, launches = flush
    assert threads == ["charon-cuda-host-prep_0"]
    assert "h2c_s" in totals and "h2c_host_s" in totals
    assert "h2c_py_s" not in totals
    assert launches["h2c_s"]["h2c_sswu_head"] == 1
    assert all(c.get("h2c_sswu_head", 0) == 0 for k, c in launches.items()
               if k != "h2c_s")
    assert all(c.get("h2c_sswu", 0) == 0 for c in launches.values())
    assert verifier.paths == {"cuda-rlc+h2c-dev": 1}
    assert tapi.verify_path(9) == "cuda-rlc+h2c-dev"
    assert port_backend.hm_cache_misses == 9
    assert len(port_backend._hm_cache) == 9


def test_cached_points_equal_the_host_hash(port_backend, flush):
    for msg in (MSGS[0], MSGS[8]):
        np.testing.assert_array_equal(port_backend._hm_cache[msg],
                                      tcurve.g2_pack([hash_to_g2(msg)])[..., 0])


def test_fewer_than_eight_misses_hash_on_the_host(monkeypatch):
    be = backend_cuda.CUDABackend(device="cpu")
    monkeypatch.setattr(cuda_h2c, "hash_to_g2_rows", None)   # never called
    stages, launches = {}, {}
    keys = MSGS[:backend_cuda.H2C_MIN_BATCH - 1]
    got = be._hash_points(keys + keys[:2], stages, launches)
    assert list(stages) == ["h2c_py_s"] and launches == {}
    want = tcurve.g2_pack([hash_to_g2(m) for m in keys])
    np.testing.assert_array_equal(got[..., :len(keys)], want)
    np.testing.assert_array_equal(got[..., len(keys):], want[..., :2])
    assert (be.hm_cache_misses, be.hm_cache_hits) == (9, 0)


def test_a_failing_h2c_launch_raises_with_no_host_fallback(port_backend,
                                                           flush,
                                                           monkeypatch):
    entries = flush[0]
    host_calls = []

    def fail(*args):
        raise RuntimeError("f2_chain: kernel launch failed (injected)")

    def host_spy(msg, *args):
        host_calls.append(msg)
        return hash_to_g2(msg, *args)

    monkeypatch.setattr(cuda_h2c, "_run_chain", fail)
    monkeypatch.setattr(backend_cuda, "hash_to_g2", host_spy)
    port_backend._hm_cache.clear()
    with pytest.raises(RuntimeError, match="injected"):
        asyncio.run(BatchVerifier().verify_many(entries))
    assert host_calls == []
    assert len(port_backend._hm_cache) == 0
