"""The DKG ceremony on the port, held against the JAX package.

(i)   keygen math: `pedersen_round1` with one seeded `random.Random` gives
      byte-equal commitments and shares in both packages (real BLS);
      `pedersen_round2` gives equal `KeygenResult`s, and both name the
      sender of a bad share.
(ii)  `Ceremony.sign_and_aggregate` on the same `KeygenResult`s (one
      operator, a stub mesh) gives the JAX package's lock hash,
      `signature_aggregate` and deposit data byte for byte, under the
      insecure-test scheme and under real BLS (both packages on their
      pure-Python oracle backends).
(iii) share-possession proofs: the port's `verify_share_proofs` on
      `CUDABackend(device="cpu")` (the kernels' plain versions, one
      flush) gives the JAX package's verdicts, a forged proof isolated;
      `verify_share_proofs_multi` likewise on the oracle backends.
(iv)  ceremonies over TCP (insecure-test scheme): three port operators for
      both algorithms; a mixed ceremony of one JAX operator and two port
      operators, whose locks are equal and pass both packages'
      `verify_lock`; an equivocating dealer named by the echo round.
"""

import asyncio
import random
import socket

import pytest
import torch

torch.set_num_threads(1)

from charon_tpu.cluster import definition as jdef
from charon_tpu.dkg import ceremony as jceremony
from charon_tpu.dkg import keygen as jkeygen
from charon_tpu.p2p import transport as jtransport
from charon_tpu.tbls import api as japi
from charon_tpu_torch.cluster import definition as pdef
from charon_tpu_torch.dkg import ceremony as pceremony
from charon_tpu_torch.dkg import keygen as pkeygen
from charon_tpu_torch.eth2util import deposit as pdeposit
from charon_tpu_torch.eth2util import keystore as pkeystore
from charon_tpu_torch.p2p import transport as ptransport
from charon_tpu_torch.tbls import api as papi
from charon_tpu_torch.tbls import backend_cuda

FORK = bytes(4)
CREDS = b"\x01" + bytes(11) + b"\x42" * 20


def free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


@pytest.fixture
def scheme(request):
    """Both packages under one scheme (default insecure-test), on their
    pure-Python oracle backends; restored afterwards."""
    name = getattr(request, "param", "insecure-test")
    with pytest.MonkeyPatch.context() as mp:
        # the JAX package's default backend is its oracle already
        mp.setattr(papi, "_current_name", "cpu")
        papi.set_scheme(name)
        japi.set_scheme(name)
        try:
            yield name
        finally:
            papi.set_scheme("bls")
            japi.set_scheme("bls")


# -- (i) keygen math --------------------------------------------------------

@pytest.mark.parametrize("t,n", [(2, 3), (3, 4)])
def test_pedersen_round1_bytes_equal_the_jax_packages(t, n):
    jb, js = jkeygen.pedersen_round1(t, n, rng=random.Random(t * 100 + n))
    pb, ps = pkeygen.pedersen_round1(t, n, rng=random.Random(t * 100 + n))
    assert len(pb.commitments) == t
    assert pb.commitments == jb.commitments
    assert set(ps.shares) == set(range(1, n + 1))
    assert ps.shares == js.shares


def round1_all(pkg_keygen, t: int, n: int, seed: int) -> dict:
    """Every participant's round 1 from one seeded rng → {i: (broadcast,
    shares)}."""
    rng = random.Random(seed)
    return {i: pkg_keygen.pedersen_round1(t, n, rng=rng)
            for i in range(1, n + 1)}


def as_bytes(r1: dict) -> dict:
    return {i: (b.commitments, s.shares) for i, (b, s) in r1.items()}


def test_pedersen_round2_equal_and_bad_share_named():
    """Real BLS, 2-of-3: every participant's round 2 equals the JAX
    package's (group key, secret share, all pubshares); a corrupted share
    is refused by both, naming its sender."""
    n, t = 3, 2
    r1 = round1_all(pkeygen, t, n, seed=7)
    assert as_bytes(r1) == as_bytes(round1_all(jkeygen, t, n, seed=7))
    bcasts = {i: b for i, (b, _) in r1.items()}
    jbcasts = {i: jkeygen.Round1Broadcast(b.commitments)
               for i, b in bcasts.items()}
    groups = set()
    for k in range(1, n + 1):
        shares = {i: s.shares[k] for i, (_, s) in r1.items()}
        got = pkeygen.pedersen_round2(k, n, bcasts, shares)
        want = jkeygen.pedersen_round2(k, n, jbcasts, shares)
        assert (got.group_pubkey, got.secret_share, got.pubshares) == \
            (want.group_pubkey, want.secret_share, want.pubshares)
        assert papi.privkey_to_pubkey(got.secret_share) == got.pubshares[k]
        groups.add(got.group_pubkey)
    assert len(groups) == 1
    shares = {i: s.shares[1] for i, (_, s) in r1.items()}
    shares[2] = papi.int_to_privkey(12345)
    with pytest.raises(ValueError, match="participant 2"):
        pkeygen.pedersen_round2(1, n, bcasts, shares)
    with pytest.raises(ValueError, match="participant 2"):
        jkeygen.pedersen_round2(1, n, jbcasts, shares)


# -- (ii) sign_and_aggregate ------------------------------------------------

class StubMesh:
    """n = 1: no peers, nothing sent."""

    peers: dict = {}

    def register_handler(self, *a, **k):
        pass

    async def send_async(self, *a, **k):
        pass


def sign_and_aggregate(pkg, keygen_mod, cer_mod, m: int):
    d = pkg.Definition(name="stub", operators=(pkg.Operator(address="0xs"),),
                       threshold=1, num_validators=m, fork_version=FORK)
    cer = cer_mod.Ceremony(d, StubMesh(), 0, b"\x00" * 32)
    tbls = papi if pkg is pdef else japi
    results = []
    for v in range(m):
        sk = bytes([v + 1]).ljust(32, b"\0")
        pk = tbls.privkey_to_pubkey(sk)
        results.append(keygen_mod.KeygenResult(
            group_pubkey=pk, secret_share=sk, pubshares={1: pk}))
    return asyncio.run(cer.sign_and_aggregate(results, CREDS)), results


@pytest.mark.parametrize("scheme,m", [("insecure-test", 2), ("bls", 1)],
                         indirect=["scheme"])
def test_sign_and_aggregate_equals_the_jax_packages(scheme, m):
    """m validators (one under real BLS: ~10 s of pure-Python pairings a
    package)."""
    (lock, deposits), results = sign_and_aggregate(pdef, pkeygen,
                                                   pceremony, m)
    (jlock, jdeposits), _ = sign_and_aggregate(jdef, jkeygen, jceremony, m)
    assert lock.lock_hash == jlock.lock_hash
    assert lock.signature_aggregate == jlock.signature_aggregate
    assert len(lock.signature_aggregate) == m * 96
    assert [(d.pubkey, d.withdrawal_credentials, d.amount, d.signature)
            for d in deposits] == \
        [(d.pubkey, d.withdrawal_credentials, d.amount, d.signature)
         for d in jdeposits]
    # row order: validator v's deposit is signed over its own root
    for v, r in enumerate(results):
        root = pdeposit.deposit_signing_root(r.group_pubkey, CREDS, FORK)
        assert deposits[v].signature == papi.sign(r.secret_share, root)
        sig = lock.signature_aggregate[96 * v:96 * (v + 1)]
        assert sig == papi.sign(r.secret_share, pdef.lock_hash(pdef.Lock(
            definition=lock.definition, validators=lock.validators)))


# -- (iii) share proofs -----------------------------------------------------

def share_proof_items(transcript: bytes):
    """One 2-of-3 validator's three share proofs, the second forged."""
    _, shares, pubshares = pkeygen.keycast_deal(2, 3, seed=b"dkg-proofs")
    items = [(pubshares[i], pkeygen.share_proof(shares[i], transcript))
             for i in sorted(shares)]
    items[1] = (items[1][0], items[0][1])
    return items


def test_share_proofs_verdicts_equal_the_jax_packages(monkeypatch):
    """One flush of the port's card route on the CPU (its kernels' plain
    versions, the re-check included) against the JAX oracle."""
    monkeypatch.setattr(backend_cuda, "ROW_TILE", 8)
    monkeypatch.setattr(papi, "_BACKENDS", dict(papi._BACKENDS))
    monkeypatch.setattr(papi, "_current_name", "cuda")
    papi.register_backend("cuda", backend_cuda.CUDABackend(device="cpu"))
    transcript = b"\x11" * 32
    items = share_proof_items(transcript)

    got = pkeygen.verify_share_proofs(items, transcript)
    assert got == jkeygen.verify_share_proofs(items, transcript)
    assert got == [True, False, True]
    assert papi.verify_path(len(items)) != "cpu"


def test_share_proofs_multi_verdicts_equal_the_jax_packages(monkeypatch):
    monkeypatch.setattr(papi, "_current_name", "cpu")
    _, shares, pubshares = pkeygen.keycast_deal(2, 3, seed=b"dkg-multi")
    items = [(pubshares[i], pkeygen.share_proof(shares[i], bytes([i]) * 32),
              bytes([i]) * 32) for i in sorted(shares)]
    items[2] = (items[2][0], items[2][1], b"\x09" * 32)  # wrong transcript
    got = pkeygen.verify_share_proofs_multi(items)
    assert got == jkeygen.verify_share_proofs_multi(items)
    assert got == [True, True, False]
    assert pkeygen.share_proof_msg(b"t") == jkeygen.share_proof_msg(b"t")


# -- (iv) ceremonies over TCP -----------------------------------------------

def make_definition(pkg, ids, ports, algorithm: str, n: int, t: int, m: int,
                    name: str = "dkg-cluster"):
    d = pkg.Definition(
        name=name,
        operators=tuple(pkg.Operator(address=f"0x{i:040x}",
                                     enr=ids[i].enr("127.0.0.1", ports[i]))
                        for i in range(n)),
        threshold=t, num_validators=m, dkg_algorithm=algorithm,
        fork_version=FORK)
    for i in range(n):
        d = pkg.sign_operator(d, i, ids[i])
    return d


def run_ceremony(tmp_path, algorithm: str, jax_ops=(), n: int = 3,
                 t: int = 2, m: int = 2):
    """n operators over localhost TCP; operators in `jax_ops` run the JAX
    package's mesh and `run_dkg`, the rest the port's.  → (port
    definition, locks by operator)."""
    ports = free_ports(n)
    ids, _ = ptransport.new_test_identities(n, seed=b"dkg-ceremony")
    jids, _ = jtransport.new_test_identities(n, seed=b"dkg-ceremony")
    definition = make_definition(pdef, ids, ports, algorithm, n, t, m)
    jdefinition = jdef.definition_from_json(pdef.definition_to_json(
        definition))

    async def main():
        meshes, runs = [], []
        for i in range(n):
            if i in jax_ops:
                peers, pubs = jtransport.mesh_params_from_definition(
                    jdefinition)
                mesh = jtransport.TCPMesh(
                    i, peers, jids[i], pubs,
                    cluster_hash=jdef.definition_hash(jdefinition))
                run = jceremony.run_dkg(jdefinition, mesh, i,
                                        str(tmp_path / f"node{i}"))
            else:
                peers, pubs = ptransport.mesh_params_from_definition(
                    definition)
                mesh = ptransport.TCPMesh(
                    i, peers, ids[i], pubs,
                    cluster_hash=pdef.definition_hash(definition))
                run = pceremony.run_dkg(definition, mesh, i,
                                        str(tmp_path / f"node{i}"))
            meshes.append(mesh)
            runs.append(run)
        for mesh in meshes:
            await mesh.start()
        try:
            return await asyncio.gather(*runs)
        finally:
            for mesh in meshes:
                await mesh.stop()

    return definition, asyncio.run(main())


def check_outputs(tmp_path, definition, n: int, m: int) -> object:
    """Every node wrote the same lock, keystores of its pubshares and
    verifying deposit data; → the lock as the port loads it."""
    lock_jsons = [pdef.load_json(str(tmp_path / f"node{i}" /
                                     "cluster-lock.json")) for i in range(n)]
    locks = [pdef.lock_from_json(obj) for obj in lock_jsons]
    assert len({lk.lock_hash for lk in locks}) == 1
    for obj in lock_jsons:
        jdef.verify_lock(jdef.lock_from_json(obj))
    for i in range(n):
        keys = pkeystore.load_keys(str(tmp_path / f"node{i}" /
                                       "validator_keys"))
        assert len(keys) == m
        for v, sk in enumerate(keys):
            assert papi.privkey_to_pubkey(sk) == \
                locks[0].validators[v].public_shares[i]
    deposits = pdef.load_json(str(tmp_path / "node0" / "deposit-data.json"))
    assert len(deposits) == m
    for d, v in zip(deposits, locks[0].validators):
        root = pdeposit.deposit_signing_root(
            bytes.fromhex(d["pubkey"]),
            bytes.fromhex(d["withdrawal_credentials"]),
            definition.fork_version)
        assert papi.verify(v.public_key, root, bytes.fromhex(d["signature"]))
    return locks[0]


@pytest.mark.parametrize("algorithm", ["pedersen", "keycast"])
def test_full_ceremony_over_the_ports_tcp_mesh(tmp_path, scheme, algorithm):
    definition, locks = run_ceremony(tmp_path, algorithm)
    assert len({lk.lock_hash for lk in locks}) == 1
    for lk in locks:
        pdef.verify_lock(lk)
    lock = check_outputs(tmp_path, definition, 3, 2)
    # a threshold signature from two nodes' keystores verifies
    msg = b"post-dkg-duty"
    sks = [pkeystore.load_keys(str(tmp_path / f"node{i}" /
                                   "validator_keys"))[0] for i in (0, 2)]
    sig = papi.aggregate({1: papi.partial_sign(sks[0], msg),
                          3: papi.partial_sign(sks[1], msg)})
    assert papi.verify(lock.validators[0].public_key, msg, sig)


@pytest.mark.parametrize("algorithm", ["pedersen", "keycast"])
def test_mixed_ceremony_jax_operator_and_port_operators(tmp_path, scheme,
                                                        algorithm):
    """Operator 0 (keycast's dealer) runs the JAX package, operators 1-2
    the port: one ceremony, equal locks, each passing both packages'
    `verify_lock`."""
    definition, locks = run_ceremony(tmp_path, algorithm, jax_ops=(0,))
    assert len({lk.lock_hash for lk in locks}) == 1
    assert isinstance(locks[0], jdef.Lock)
    assert isinstance(locks[1], pdef.Lock)
    assert locks[0].signature_aggregate == locks[1].signature_aggregate
    check_outputs(tmp_path, definition, 3, 2)
    for lk in locks:
        obj = (jdef if isinstance(lk, jdef.Lock) else pdef).lock_to_json(lk)
        pdef.verify_lock(pdef.lock_from_json(obj))
        jdef.verify_lock(jdef.lock_from_json(obj))


def test_equivocating_dealer_detected(tmp_path, scheme):
    """A dealer sending different round-1 commitments to different peers
    is named by the echo round and the honest operators abort."""
    n, t, m = 3, 2, 1
    ports = free_ports(n)
    ids, _ = ptransport.new_test_identities(n, seed=b"dkg-equivocate")
    definition = make_definition(pdef, ids, ports, "pedersen", n, t, m,
                                 name="evil-cluster")

    async def main():
        peers, pubs = ptransport.mesh_params_from_definition(definition)
        meshes = [ptransport.TCPMesh(
            i, peers, ids[i], pubs,
            cluster_hash=pdef.definition_hash(definition)) for i in range(n)]
        for mesh in meshes:
            await mesh.start()
        orig_send = meshes[0].send_async

        async def evil_send(peer, protocol, payload):
            if protocol == pceremony.ROUND1_PROTOCOL and peer == 2:
                obj = ptransport.decode_json(payload)
                first = bytes.fromhex(obj["commitments"][0][0])
                obj["commitments"][0][0] = (
                    first[:-1] + bytes([first[-1] ^ 1])).hex()
                payload = ptransport.encode_json(obj)
            await orig_send(peer, protocol, payload)

        meshes[0].send_async = evil_send
        try:
            return await asyncio.gather(*(
                pceremony.run_dkg(definition, meshes[i], i,
                                  str(tmp_path / f"node{i}"))
                for i in range(n)), return_exceptions=True)
        finally:
            for mesh in meshes:
                await mesh.stop()

    results = asyncio.run(main())
    errors = [r for r in results[1:] if isinstance(r, Exception)]
    assert len(errors) == 2, results
    assert any("dealer 0 equivocated" in str(e) for e in errors), errors
    assert not (tmp_path / "node1" / "cluster-lock.json").exists()


def test_sync_barrier_waits_for_a_late_operator(tmp_path, scheme):
    """An operator whose mesh starts 1.5 s after the others' still meets
    them: the barrier dials it again until its timeout."""
    n, t, m = 3, 2, 1
    ports = free_ports(n)
    ids, _ = ptransport.new_test_identities(n, seed=b"dkg-late")
    definition = make_definition(pdef, ids, ports, "keycast", n, t, m)

    async def main():
        peers, pubs = ptransport.mesh_params_from_definition(definition)
        meshes = [ptransport.TCPMesh(i, peers, ids[i], pubs)
                  for i in range(n)]

        async def operator(i: int, delay: float):
            await asyncio.sleep(delay)
            await meshes[i].start()
            return await pceremony.run_dkg(definition, meshes[i], i,
                                           str(tmp_path / f"node{i}"))

        try:
            return await asyncio.gather(operator(0, 0.0), operator(1, 0.0),
                                        operator(2, 1.5))
        finally:
            for mesh in meshes:
                await mesh.stop()

    locks = asyncio.run(main())
    assert len({lk.lock_hash for lk in locks}) == 1
