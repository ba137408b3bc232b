"""The verify slice as a whole: the port's BatchVerifier → dispatch
pipeline → tbls.api.batch_verify → CUDABackend, run on the CPU
(device="cpu": every kernel wrapper takes its plain version), against the
JAX package's tbls.api.batch_verify on its "cpu" backend (the pure-Python
oracle).

A mixed batch — valid entries, a wrong message, another key's signature,
malformed signature and pubkey bytes, a wrong-length entry and a G2
signature outside the subgroup — takes the RLC reject path and gets the
oracle's verdicts row for row.  The RLC coefficients are fresh on every
call.  (The coalescing, tiling and cache behaviour of an all-valid flush
is in tests/test_torch_verify_flush.py.)
"""

import asyncio
import inspect

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.tbls import api as japi
from charon_tpu_torch.core.verify import BatchVerifier
from charon_tpu_torch.ops import codec as tcodec
from charon_tpu_torch.tbls import api as tapi
from charon_tpu_torch.tbls import backend_cuda
from charon_tpu_torch.tbls.ref import bls, curve as rc

M1, M2 = b"charon-tpu-torch verify: slot 7", b"charon-tpu-torch verify: slot 8"
SKS = (0x1111, 0x2222222, 0x333333333)
PKS = [rc.g1_to_bytes(bls.sk_to_pk(sk)) for sk in SKS]


def _sig(sk: int, msg: bytes) -> bytes:
    return rc.g2_to_bytes(bls.sign(sk, msg))


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


def _mixed_entries() -> tuple[list, list[str]]:
    s11 = _sig(SKS[0], M1)
    cof = rc.g2_to_bytes(tcodec._find_g2_cofactor_point())
    entries = [
        (PKS[0], M1, s11),                              # valid
        (PKS[1], M1, _sig(SKS[1], M1)),                 # valid
        (PKS[0], M1, _sig(SKS[0], M2)),                 # wrong message
        (PKS[1], M2, _sig(SKS[2], M2)),                 # another key's sig
        (PKS[2], M2, _sig(SKS[2], M2)),                 # valid
        (PKS[0], M1, bytes([s11[0] & 0x7F]) + s11[1:]),  # malformed sig
        (bytes([PKS[1][0] & 0x7F]) + PKS[1][1:], M1,
         _sig(SKS[1], M1)),                             # malformed pubkey
        (PKS[0], M1, cof),                              # G2, not in G2's r
        (PKS[0][:47], M1, s11),                         # wrong length
    ]
    kinds = ["valid", "valid", "wrong_msg", "other_key", "valid",
             "bad_sig_bytes", "bad_pk_bytes", "off_subgroup", "short_pk"]
    return entries, kinds


@pytest.fixture(scope="module")
def mixed(port_backend):
    entries, kinds = _mixed_entries()
    verifier = BatchVerifier()
    got = asyncio.run(verifier.verify_many(entries))
    return entries, kinds, got, dict(port_backend.last_stages), verifier


def test_mixed_batch_equals_the_jax_oracle(mixed):
    entries, kinds, got, _, _ = mixed
    want = japi.batch_verify(entries)
    assert got == want
    assert [k for k, ok in zip(kinds, got) if ok] == ["valid"] * 3


def test_mixed_batch_takes_the_reject_path(mixed):
    _, _, _, stages, verifier = mixed
    assert "recheck_s" in stages and "final_exp_s" in stages
    assert verifier.launches == 1 and verifier.entries_total == 9
    assert verifier.paths == {"cuda-rlc+h2c-dev": 1}


def test_rlc_coefficients_are_fresh_per_call(port_backend, monkeypatch):
    """The main path draws its coefficients from a new OS-entropy
    generator on every call; a test may pass its own."""
    seen = []
    real = np.random.default_rng

    def spy(*args, **kwargs):
        seen.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(np.random, "default_rng", spy)
    entries = [(PKS[0], M1, _sig(SKS[0], M1))]
    p1 = port_backend.verify_host_prep(entries)
    p2 = port_backend.verify_host_prep(entries)
    assert seen == [(), ()]                       # unseeded, one per call
    assert not np.array_equal(p1["windows"], p2["windows"])
    p3 = port_backend.verify_host_prep(entries, np.random.default_rng(5))
    p4 = port_backend.verify_host_prep(entries, np.random.default_rng(5))
    np.testing.assert_array_equal(p3["windows"], p4["windows"])
    # both Miller rows of an entry share its coefficient
    np.testing.assert_array_equal(p3["windows"][:, 0], p3["windows"][:, 1])
    # the bytes entry point takes no generator: nothing can seed it
    assert list(inspect.signature(
        port_backend.batch_verify_bytes).parameters) == ["entries"]


def test_api_verify_and_oracle_backend(port_backend):
    s = _sig(SKS[2], M2)
    assert tapi.verify(PKS[2], M2, s)
    assert not tapi.verify(PKS[2][:10], M2, s)     # no decode: no device run
    oracle = tapi.CPUBackend()
    pk = bls.sk_to_pk(SKS[2])
    assert oracle.batch_verify([(pk, M2, rc.g2_from_bytes(s)),
                                (pk, M1, rc.g2_from_bytes(s))]) == [True,
                                                                     False]
