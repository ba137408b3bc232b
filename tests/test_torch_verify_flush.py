"""An all-valid flush through the port's BatchVerifier → dispatch
pipeline → CUDABackend on the CPU (device="cpu", the kernels' plain
versions): two verify_many calls in one event-loop tick coalesce into ONE
pipeline launch; with the tile monkeypatched to 4 the 10-entry flush runs
3 tiles; no tile takes the per-row re-check; the pubkey and message LRUs
decompress / hash each distinct key and message once.
"""

import asyncio
import threading

import pytest
import torch

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu_torch.core.verify import BatchVerifier
from charon_tpu_torch.ops import cuda_pairing, launch_count
from charon_tpu_torch.tbls import api as tapi
from charon_tpu_torch.tbls import backend_cuda, dispatch
from charon_tpu_torch.tbls.ref import bls, curve as rc

M1, M2 = b"charon-tpu-torch verify: slot 7", b"charon-tpu-torch verify: slot 8"
SKS = (0x1111, 0x2222222, 0x333333333)


@pytest.fixture(scope="module")
def port_backend():
    """The port's "cuda" backend on the CPU."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "_BACKENDS", dict(tapi._BACKENDS))
        mp.setattr(tapi, "_current_name", tapi._current_name)
        be = backend_cuda.CUDABackend(device="cpu")
        tapi.register_backend("cuda", be)
        tapi.set_backend("cuda")
        yield be


@pytest.fixture(scope="module")
def coalesced(port_backend):
    """Two verify_many calls in one tick, all valid, tile = 4."""
    keys = [(sk, M1 if k % 2 else M2) for k, sk in enumerate(
        [SKS[k % 3] for k in range(10)])]
    entries = [(rc.g1_to_bytes(bls.sk_to_pk(sk)), m,
                rc.g2_to_bytes(bls.sign(sk, m)))
               for sk, m in keys]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dispatch, "VERIFY_TILE", 4)
        pipe = dispatch.default_pipeline()
        before = (pipe.launches, pipe.tiles)
        port_backend.reset_verify_totals()
        verifier = BatchVerifier()

        async def run():
            return await asyncio.gather(verifier.verify_many(entries[:6]),
                                        verifier.verify_many(entries[6:]))

        a, b = asyncio.run(run())
    return (a + b, verifier, (pipe.launches - before[0],
                              pipe.tiles - before[1]),
            dict(port_backend.verify_totals))


def test_all_valid_flush_takes_no_recheck(coalesced):
    oks, _, _, totals = coalesced
    assert oks == [True] * 10
    assert "final_exp_s" in totals and "recheck_s" not in totals


def test_two_verify_many_calls_coalesce_into_one_launch(coalesced):
    _, verifier, (launches, _), _ = coalesced
    assert launches == 1
    assert verifier.launches == 1 and verifier.max_batch == 10


def test_a_ten_entry_flush_runs_three_tiles(coalesced):
    _, verifier, (_, tiles), totals = coalesced
    assert tiles == 3
    assert verifier.paths == {"cuda-rlc+h2c-dev": 3}
    # the label names the route of 8 or more misses; the first tile's 2
    # distinct misses hashed on the host, and its stages say so
    assert "h2c_py_s" in totals and "h2c_s" not in totals
    assert dispatch.tile_sizes(10, 4) == [4, 4, 2]
    assert dispatch.tile_sizes(3, 4) == [3]
    assert dispatch.tile_sizes(10_000, 2048) == [2048] * 4 + [1808]


def test_caches_and_padding(port_backend, coalesced):
    be = port_backend
    assert be.verify_padded_rows(9) == 16
    assert be.verify_padded_rows(2048) == 2048
    assert be.verify_padded_rows(1808) == 2048
    assert be.verify_padded_rows(0) == 0
    assert tapi.verify_path(2048) == "cuda-rlc+h2c-dev"
    # 3 keys and 2 messages were decompressed / hashed once each; the
    # counters count rows: the first tile's 4 rows missed, the other 6 hit
    assert len(be._pk_cache) == 3
    assert len(be._hm_cache) == 2
    assert (be.hm_cache_misses, be.hm_cache_hits) == (4, 6)
    assert (be.pk_cache_misses, be.pk_cache_hits) == (4, 6)
    assert all(n == 0 for n in cuda_pairing.LAUNCHES.values())


def test_stage_launches_are_the_calling_threads_own():
    """A stage counts only the launches of the thread that runs it: the
    host-prep thread's pubkey-miss decompress and the launch thread's tile
    overlap, and neither lands in the other's stage."""
    totals = {"fp_mul": 0, "pp_sqr": 0}
    seconds, launches = {}, {}
    other = threading.Thread(
        target=lambda: [launch_count.bump(totals, "fp_mul")
                        for _ in range(3)])
    with backend_cuda._own_stream_stage(None, "pk_decompress_s", seconds,
                                        launches):
        launch_count.bump(totals, "pp_sqr")
        other.start()
        other.join()
    assert totals == {"fp_mul": 3, "pp_sqr": 1}
    assert launches["pk_decompress_s"]["pp_sqr"] == 1
    assert launches["pk_decompress_s"]["fp_mul"] == 0
    assert seconds["pk_decompress_s"] >= 0
