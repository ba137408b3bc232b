"""The rest of the port's tbls API against the JAX package's, for the same
seeds, under both schemes ("bls" and "insecure-test"), t = 2 of n = 3:
trusted-dealer keygen, the public shares, the Feldman helpers, key and
signature sums, share recombination, keys, signing, and the threshold
aggregate — the same bytes from both.  `verify_and_aggregate` runs on the
port's `CUDABackend(device="cpu")` (the kernels' plain versions) against
JAX's pure-Python "cpu" backend, with one invalid partial among three.
"""

import contextlib

import pytest
import torch

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.tbls import api as japi
from charon_tpu_torch.tbls import api as tapi
from charon_tpu_torch.tbls import backend_cuda

SEED = b"charon-tpu-torch api test"
MSG = b"charon-tpu-torch api: slot 12"
T, N = 2, 3


@contextlib.contextmanager
def _scheme(name: str):
    before = japi.scheme_name(), tapi.scheme_name()
    japi.set_scheme(name)
    tapi.set_scheme(name)
    try:
        yield
    finally:
        japi.set_scheme(before[0])
        tapi.set_scheme(before[1])


@pytest.fixture(scope="module", params=["bls", "insecure-test"])
def scheme(request):
    """Both APIs under one scheme, the port's "cuda" backend on the CPU
    and JAX's pure-Python "cpu" backend, with the keys of one dealer."""
    with pytest.MonkeyPatch.context() as mp, _scheme(request.param):
        mp.setattr(backend_cuda, "ROW_TILE", 8)
        mp.setattr(tapi, "_BACKENDS", dict(tapi._BACKENDS))
        mp.setattr(tapi, "_current_name", tapi._current_name)
        tapi.register_backend("cuda", backend_cuda.CUDABackend(device="cpu"))
        tapi.set_backend("cuda")
        japi.set_backend("cpu")
        yield (request.param, japi.generate_tss(T, N, SEED),
               tapi.generate_tss(T, N, SEED))


def test_generate_tss_and_public_shares(scheme):
    _, (jtss, jshares), (ttss, tshares) = scheme
    assert (ttss.group_pubkey, ttss.commitments, ttss.num_shares) == \
        (jtss.group_pubkey, jtss.commitments, jtss.num_shares)
    assert tshares == jshares and ttss.threshold == T
    assert ttss.public_shares() == jtss.public_shares()
    for i in range(1, N + 1):
        assert ttss.public_share(i) == jtss.public_share(i)
    with pytest.raises(ValueError):
        ttss.public_share(N + 1)


def test_feldman_helpers(scheme):
    _, (jtss, jshares), (ttss, _) = scheme
    for c in (0, 1, 12345, 2 ** 255 + 7):
        assert tapi.commit_coeff(c) == japi.commit_coeff(c)
    for i in range(1, N + 1):
        assert tapi.feldman_eval(ttss.commitments, i) == \
            japi.feldman_eval(jtss.commitments, i)
        assert tapi.feldman_verify(jshares[i], i, ttss.commitments)
    assert not tapi.feldman_verify(jshares[1], 2, ttss.commitments)
    assert not japi.feldman_verify(jshares[1], 2, jtss.commitments)


def test_sums_recombination_and_keys(scheme):
    _, (jtss, jshares), (ttss, _) = scheme
    pks = [ttss.public_share(i) for i in range(1, N + 1)]
    assert tapi.add_pubkeys(pks) == japi.add_pubkeys(pks)
    sks = list(jshares.values())
    assert tapi.add_privkeys(sks) == japi.add_privkeys(sks)
    two = {i: jshares[i] for i in (1, 3)}
    assert tapi.combine_shares(two) == japi.combine_shares(two)
    secret = tapi.combine_shares(two)
    assert tapi.privkey_to_pubkey(secret) == ttss.group_pubkey
    for sk in sks:
        assert tapi.privkey_to_pubkey(sk) == japi.privkey_to_pubkey(sk)
    fresh = tapi.generate_privkey()
    assert len(fresh) == 32 and tapi.privkey_to_int(fresh) != 0
    assert tapi.privkey_to_pubkey(fresh) == japi.privkey_to_pubkey(fresh)
    tss2, shares2 = tapi.split_secret(secret, T, N)
    assert tss2.group_pubkey == ttss.group_pubkey
    assert tapi.combine_shares({i: shares2[i] for i in (2, 3)}) == secret


def test_signing_and_aggregate(scheme):
    name, (jtss, jshares), (ttss, _) = scheme
    partials = {i: tapi.partial_sign(jshares[i], MSG) for i in (1, 2)}
    assert partials == {i: japi.partial_sign(jshares[i], MSG)
                        for i in (1, 2)}
    sigs = list(partials.values())
    assert tapi.aggregate_signatures(sigs) == japi.aggregate_signatures(sigs)
    group = tapi.aggregate(partials)
    assert group == japi.aggregate(partials)
    secret = tapi.combine_shares({i: jshares[i] for i in (1, 2)})
    assert group == tapi.sign(secret, MSG) == japi.sign(secret, MSG)
    assert tapi.scheme_name() == japi.scheme_name() == name


def test_insecure_scheme_checks():
    before = tapi.scheme_name()
    with _scheme("insecure-test"):
        tss, shares = tapi.generate_tss(T, N, SEED)
        sig = tapi.sign(shares[1], MSG)
        pk = tss.public_share(1)
        assert tapi.verify(pk, MSG, sig)
        assert not tapi.verify(pk, MSG + b"x", sig)
        assert not tapi.verify(b"\x80" + pk[1:], MSG, sig)
        entries = [(pk, MSG, sig), (pk, b"other", sig)]
        assert tapi.batch_verify(entries) == japi.batch_verify(entries) \
            == [True, False]
        assert tapi.verify_path(4) == tapi.combine_path() == "insecure-test"
        assert tapi.verify_padded_rows(3) == 3
        assert tapi.devcache_path() == "insecure-test"
        bad = {1: sig, 2: tapi.sign(shares[2], b"other")}
        with pytest.raises(ValueError, match="insufficient valid"):
            tapi.verify_and_aggregate(tss, bad, MSG)
        with pytest.raises(ValueError, match="insufficient partial"):
            tapi.verify_and_aggregate(tss, {1: sig}, MSG)
    with pytest.raises(ValueError):
        tapi.set_scheme("neither")
    assert tapi.scheme_name() == before


def test_verify_and_aggregate_on_the_cpu_backends(scheme):
    """Three partials, one over another message: both APIs drop it and
    aggregate the other two into the same group signature."""
    _, (jtss, jshares), (ttss, _) = scheme
    partials = {1: tapi.partial_sign(jshares[1], MSG),
                2: tapi.partial_sign(jshares[2], MSG + b" (wrong)"),
                3: tapi.partial_sign(jshares[3], MSG)}
    got = tapi.verify_and_aggregate(ttss, partials, MSG)
    assert got == japi.verify_and_aggregate(jtss, partials, MSG)
    assert got[1] == [1, 3]
