"""Cluster material across the packages: locks, keystores, deposit data.

- A lock the JAX package writes loads in the port with equal config,
  definition and lock hashes and passes the port's `verify_lock`, and the
  reverse, with real BLS (one validator, 3 operators: the group signature
  checks run on the pure-Python oracle backends, `set_backend("cpu")`).
- A tampered lock (a pubshare, the signature aggregate, an operator's
  signature, the definition's threshold) is refused by both packages.
- EIP-2335 keystores decrypt across the packages (the port's AES-128-CTR
  against `cryptography`'s), and with salt and iv pinned the two
  packages' keystores are equal but for `uuid`.
- deposit-data.json is equal.
"""

import json
import random

import pytest

from charon_tpu.cluster import definition as jdef
from charon_tpu.eth2util import deposit as jdeposit
from charon_tpu.eth2util import keystore as jkeystore
from charon_tpu.eth2util import spec as jspec
from charon_tpu.p2p import identity as jident
from charon_tpu.tbls import api as japi
from charon_tpu_torch.cluster import definition as pdef
from charon_tpu_torch.eth2util import deposit as pdeposit
from charon_tpu_torch.eth2util import keystore as pkeystore
from charon_tpu_torch.eth2util import spec as pspec
from charon_tpu_torch.p2p import identity as pident
from charon_tpu_torch.tbls import api as papi

N, T = 3, 2
FORK = bytes.fromhex("01017000")


@pytest.fixture(autouse=True)
def cpu_backends(monkeypatch):
    """The port's `tbls.verify` on its pure-Python oracle (no card here);
    the JAX package's default backend is its own oracle."""
    monkeypatch.setattr(papi, "_current_name", "cpu")


def make_lock(pkg, tbls, ident, seed: bytes, validators: int = 1):
    """A signed, real-BLS lock written by `pkg`'s cluster module (the
    `create cluster` recipe, reproducible from `seed`)."""
    ids = [ident.NodeIdentity.generate(seed + bytes([i])) for i in range(N)]
    ops = tuple(pkg.Operator(address=f"op{i}",
                             enr=nid.enr("127.0.0.1", 17000 + i))
                for i, nid in enumerate(ids))
    d = pkg.Definition(name="x-pkg", operators=ops, threshold=T,
                       num_validators=validators, fork_version=FORK,
                       timestamp="2026-01-01T00:00:00Z")
    for i, nid in enumerate(ids):
        d = pkg.sign_operator(d, i, nid)
    tsses = [tbls.generate_tss(T, N, seed=seed + bytes([64 + k]))
             for k in range(validators)]
    vals = tuple(pkg.DistValidator(
        public_key=tss.group_pubkey,
        public_shares=tuple(tss.public_share(i + 1) for i in range(N)))
        for tss, _ in tsses)
    msg = pkg.lock_hash(pkg.Lock(definition=d, validators=vals))
    sig = b"".join(tbls.sign(tbls.combine_shares(shares), msg)
                   for _, shares in tsses)
    return pkg.Lock(definition=d, validators=vals, signature_aggregate=sig)


@pytest.fixture(scope="module")
def locks():
    """(JAX-written lock JSON, port-written lock JSON)."""
    return (jdef.lock_to_json(make_lock(jdef, japi, jident, b"jax")),
            pdef.lock_to_json(make_lock(pdef, papi, pident, b"port")))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lock_loads_in_the_other_package_with_equal_hashes(locks, writer):
    obj = json.loads(json.dumps(locks[0 if writer == "jax" else 1]))
    j = jdef.lock_from_json(obj)          # verify_lock on each side
    p = pdef.lock_from_json(obj)
    assert pdef.config_hash(p.definition) == jdef.config_hash(j.definition)
    assert pdef.definition_hash(p.definition) == \
        jdef.definition_hash(j.definition)
    assert p.lock_hash == j.lock_hash
    assert pdef.lock_to_json(p) == jdef.lock_to_json(j) == obj
    assert pdef.definition_to_json(p.definition) == \
        jdef.definition_to_json(j.definition)


def _tamper(obj: dict, how: str) -> dict:
    obj = json.loads(json.dumps(obj))
    dv = obj["distributed_validators"][0]
    if how == "pubshare":
        other = obj["distributed_validators"][0]["public_shares"]
        dv["public_shares"] = [other[1], other[0], other[2]]
    elif how == "signature":
        sig = bytearray.fromhex(obj["signature_aggregate"][2:])
        sig[40] ^= 1
        obj["signature_aggregate"] = "0x" + sig.hex()
    elif how == "operator_signature":
        op = obj["cluster_definition"]["operators"][1]
        sig = bytearray.fromhex(op["config_signature"][2:])
        sig[3] ^= 1
        op["config_signature"] = "0x" + sig.hex()
    elif how == "threshold":
        obj["cluster_definition"]["threshold"] = 3
    return obj


@pytest.mark.parametrize("how", ["pubshare", "signature",
                                 "operator_signature", "threshold"])
@pytest.mark.parametrize("rehash", [False, True])
def test_tampered_lock_is_refused_by_both(locks, how, rehash):
    """Tampered as stored (its hashes no longer match), and tampered with
    its hashes recomputed — then the signatures refuse it."""
    obj = _tamper(locks[1], how)
    if rehash:
        obj.pop("lock_hash")
        obj["cluster_definition"].pop("definition_hash")
    with pytest.raises(ValueError):
        jdef.lock_from_json(obj)
    with pytest.raises(ValueError):
        pdef.lock_from_json(obj)


def test_lock_with_stripped_operator_signatures_is_refused(locks):
    obj = json.loads(json.dumps(locks[0]))
    for op in obj["cluster_definition"]["operators"]:
        op["config_signature"] = op["enr_signature"] = "0x"
    obj["cluster_definition"].pop("definition_hash")
    obj.pop("lock_hash")
    for pkg in (jdef, pdef):
        with pytest.raises(ValueError, match="missing signatures"):
            pkg.lock_from_json(obj)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_keystores_decrypt_across_the_packages(tmp_path, writer):
    rng = random.Random(5)
    secrets_ = [papi.int_to_privkey(rng.getrandbits(255)) for _ in range(2)]
    store, load = ((jkeystore.store_keys, pkeystore.load_keys)
                   if writer == "jax" else
                   (pkeystore.store_keys, jkeystore.load_keys))
    store(secrets_, str(tmp_path))
    assert load(str(tmp_path)) == secrets_
    ks = json.loads((tmp_path / "keystore-0.json").read_text())
    with pytest.raises(ValueError, match="checksum"):
        (pkeystore if writer == "jax" else jkeystore).decrypt(ks, "wrong")


def test_keystores_with_pinned_salt_and_iv_are_equal_but_for_uuid(
        monkeypatch):
    import secrets as secrets_mod

    def pinned(n: int) -> bytes:
        return bytes(range(n))
    monkeypatch.setattr(secrets_mod, "token_bytes", pinned)
    secret = papi.int_to_privkey(0x1234567890ABCDEF)
    mine = pkeystore.encrypt(secret, "pw")
    theirs = jkeystore.encrypt(secret, "pw")
    assert mine.pop("uuid") != theirs.pop("uuid")
    assert mine == theirs
    assert mine["crypto"]["cipher"]["params"]["iv"] == bytes(range(16)).hex()
    assert pkeystore.decrypt(theirs, "pw") == secret


def test_deposit_data_json_equal():
    rng = random.Random(9)
    creds = pdeposit.withdrawal_credentials(bytes(range(20)))
    assert creds == jdeposit.withdrawal_credentials(bytes(range(20)))
    pk = bytes(rng.getrandbits(8) for _ in range(48))
    sig = bytes(rng.getrandbits(8) for _ in range(96))
    assert pdeposit.deposit_signing_root(pk, creds, FORK) == \
        jdeposit.deposit_signing_root(pk, creds, FORK)
    mine = [pspec.DepositData(pubkey=pk, withdrawal_credentials=creds,
                              amount=pdeposit.DEPOSIT_AMOUNT_GWEI,
                              signature=sig)]
    theirs = [jspec.DepositData(pubkey=pk, withdrawal_credentials=creds,
                                amount=jdeposit.DEPOSIT_AMOUNT_GWEI,
                                signature=sig)]
    assert pdeposit.deposit_data_json(mine, FORK) == \
        jdeposit.deposit_data_json(theirs, FORK)


def test_create_cluster_lock_loads_in_the_jax_package(tmp_path):
    """The port CLI's whole cluster (insecure-test scheme): the JAX
    package loads its lock with equal hashes and decrypts its keystores."""
    from charon_tpu_torch.cmd import main as cli_main

    papi.set_scheme("insecure-test")
    japi.set_scheme("insecure-test")
    try:
        assert cli_main(["create", "cluster", "--nodes", "3",
                         "--num-validators", "2", "--cluster-dir",
                         str(tmp_path), "--tbls-scheme",
                         "insecure-test"]) == 0
        obj = jdef.load_json(str(tmp_path / "node1" / "cluster-lock.json"))
        j, p = jdef.lock_from_json(obj), pdef.lock_from_json(obj)
        assert j.lock_hash == p.lock_hash
        shares = jkeystore.load_keys(str(tmp_path / "node1" /
                                         "validator_keys"))
        assert [japi.privkey_to_pubkey(s) for s in shares] == [
            v.public_shares[1] for v in p.validators]
        deposits = json.loads((tmp_path / "node0" /
                               "deposit-data.json").read_text())
        assert [d["pubkey"] for d in deposits] == [
            v.public_key.hex() for v in p.validators]
    finally:
        papi.set_scheme("bls")
        japi.set_scheme("bls")
