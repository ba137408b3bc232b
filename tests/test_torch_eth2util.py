"""The port's eth2util copies (`ssz`, `spec`, `signing`) and the signed
data types of its `core/types.py` against the JAX package's, byte for
byte: every spec container filled with the same seeded random field
values (numpy) has the same hash-tree-root and SSZ serialisation in both,
every `DomainName` gives the same signing root, `Bitlist` round-trips the
same way, and every `Signed*` type has the same message root and signing
info.
"""

import dataclasses
import typing

import numpy as np
import pytest

from charon_tpu.core import types as jtypes
from charon_tpu.eth2util import signing as jsigning
from charon_tpu.eth2util import spec as jspec
from charon_tpu.eth2util import ssz as jssz
from charon_tpu_torch.core import types as ptypes
from charon_tpu_torch.eth2util import signing as psigning
from charon_tpu_torch.eth2util import spec as pspec
from charon_tpu_torch.eth2util import ssz as pssz

#: every SSZ container the spec defines
CONTAINERS = sorted(name for name, obj in vars(jspec).items()
                    if isinstance(obj, type) and hasattr(obj, "SSZ")
                    and obj.__module__ == jspec.__name__)


def _uint(rng, bits: int) -> int:
    return int.from_bytes(rng.bytes(bits // 8), "little")


def _bits(rng, limit: int) -> tuple[bytes, int]:
    n = int(rng.integers(0, limit + 1))
    return jssz.Bitlist.from_bools(rng.integers(0, 2, n).astype(bool).tolist())


def make(spec, name: str, rng):
    """A `spec.<name>` with every field drawn from `rng`, the draws in the
    class's field order (so one seed gives equal values in both
    packages)."""
    cls = getattr(spec, name)
    schema = dict(cls.SSZ.fields)
    kw = {}
    for f in dataclasses.fields(cls):
        typ = schema.get(f.name)
        if isinstance(typ, (jssz.UintN, pssz.UintN)):
            kw[f.name] = _uint(rng, typ.bits)
        elif isinstance(typ, (jssz.ByteVector, pssz.ByteVector)):
            kw[f.name] = rng.bytes(typ.length)
        elif isinstance(typ, (jssz.Bitlist, pssz.Bitlist)):
            kw[f.name] = _bits(rng, typ.limit)
        elif isinstance(typ, (jssz.Container, pssz.Container)):
            kw[f.name] = make(spec, f.type, rng)
        elif f.type == "bool":          # outside the schema: blinded
            kw[f.name] = bool(rng.integers(0, 2))
        else:                           # outside the schema: the opaque body
            assert typ is None and f.type == "bytes", (name, f.name)
            kw[f.name] = rng.bytes(int(rng.integers(0, 64)))
    return cls(**kw)


def pair(name: str, seed: int):
    return (make(jspec, name, np.random.default_rng(seed)),
            make(pspec, name, np.random.default_rng(seed)))


def test_the_port_defines_every_container():
    assert len(CONTAINERS) >= 20
    assert all(hasattr(pspec, name) for name in CONTAINERS)


@pytest.mark.parametrize("name", CONTAINERS)
def test_container_roots_and_bytes_equal_jax(name):
    for seed in range(4):
        want, got = pair(name, seed)
        assert got.hash_tree_root() == want.hash_tree_root(), (name, seed)
        assert got.SSZ.serialize(got) == want.SSZ.serialize(want)
    # the all-default value (zero roots and signatures) too, where the
    # class has defaults for every field
    try:
        want, got = getattr(jspec, name)(), getattr(pspec, name)()
    except TypeError:
        return
    assert got.hash_tree_root() == want.hash_tree_root()


@pytest.mark.parametrize("domain", [d.name for d in jsigning.DomainName])
def test_signing_root_equals_jax(domain):
    rng = np.random.default_rng(7)
    for _ in range(4):
        root, fork, gvr = rng.bytes(32), rng.bytes(4), rng.bytes(32)
        want = jsigning.signing_root(jsigning.DomainName[domain], root, fork,
                                     gvr)
        got = psigning.signing_root(psigning.DomainName[domain], root, fork,
                                    gvr)
        assert got == want
        assert (psigning.compute_domain(psigning.DomainName[domain], fork,
                                        gvr)
                == jsigning.compute_domain(jsigning.DomainName[domain], fork,
                                           gvr))
    assert ({d.name: v for d, v in psigning.DOMAIN_TYPES.items()}
            == {d.name: v for d, v in jsigning.DOMAIN_TYPES.items()})


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 64, 127, 128, 2048])
def test_bitlist_round_trips_as_jax(n):
    rng = np.random.default_rng(n)
    bools = rng.integers(0, 2, n).astype(bool).tolist()
    got, want = pssz.Bitlist.from_bools(bools), jssz.Bitlist.from_bools(bools)
    assert got == want and pssz.Bitlist.to_bools(got) == bools
    wire = pssz.Bitlist.to_ssz_bytes(got)
    assert wire == jssz.Bitlist.to_ssz_bytes(want)
    assert pssz.Bitlist.from_ssz_bytes(wire) == \
        jssz.Bitlist.from_ssz_bytes(wire)
    assert pssz.Bitlist.to_bools(pssz.Bitlist.from_ssz_bytes(wire)) == bools
    limit = max(n, 1)
    assert (pssz.Bitlist(limit).hash_tree_root(got)
            == jssz.Bitlist(limit).hash_tree_root(want))
    assert (pssz.Bitlist(limit).serialize(bools)
            == jssz.Bitlist(limit).serialize(bools))


def test_bitlist_without_delimiter_raises_in_both():
    for mod in (pssz, jssz):
        with pytest.raises(ValueError):
            mod.Bitlist.from_ssz_bytes(b"\x05\x00")


#: each signed data type of core/types.py → the spec container it wraps
SIGNED = {
    "SignedAttestation": "Attestation",
    "SignedBlock": "SignedBeaconBlock",
    "SignedExit": "SignedVoluntaryExit",
    "SignedRegistration": "SignedValidatorRegistration",
    "SignedBeaconCommitteeSelection": "BeaconCommitteeSelection",
    "SignedSyncCommitteeSelection": "SyncCommitteeSelection",
    "SignedAggregateAndProofSD": "SignedAggregateAndProof",
    "SignedSyncMessage": "SyncCommitteeMessage",
    "SignedSyncContributionAndProof": "SignedContributionAndProof",
}


@pytest.mark.parametrize("name", sorted(SIGNED) + ["SignedRandao"])
def test_signed_data_roots_and_signing_info_equal_jax(name):
    rng = np.random.default_rng(11)
    for seed in range(3):
        if name == "SignedRandao":
            epoch = _uint(rng, 32)
            want = jtypes.SignedRandao(epoch=epoch)
            got = ptypes.SignedRandao(epoch=epoch)
        else:
            inner_j, inner_p = pair(SIGNED[name], seed)
            want = getattr(jtypes, name)(inner_j)
            got = getattr(ptypes, name)(inner_p)
        sig = rng.bytes(96)
        want, got = want.set_signature(sig), got.set_signature(sig)
        assert got.signature == want.signature == sig
        assert got.message_root() == want.message_root()
        dom_j, ep_j = want.signing_info(32)
        dom_p, ep_p = got.signing_info(32)
        assert (dom_p.name, ep_p) == (dom_j.name, ep_j)
        psig_j = jtypes.ParSignedData(data=want, share_idx=3)
        psig_p = ptypes.ParSignedData(data=got, share_idx=3)
        assert psig_p.message_root() == psig_j.message_root()
        assert psig_p.signature == psig_j.signature


def test_the_port_types_module_is_whole():
    """Every public name of the JAX core/types.py is in the port's."""
    want = {k for k in vars(jtypes) if not k.startswith("_")
            and not isinstance(vars(jtypes)[k], type(typing))}
    missing = sorted(k for k in want if not hasattr(ptypes, k))
    assert not missing, missing


def test_pubkey_helpers_equal_jax():
    rng = np.random.default_rng(3)
    raw = rng.bytes(48)
    assert ptypes.pubkey_from_bytes(raw) == jtypes.pubkey_from_bytes(raw)
    assert ptypes.pubkey_to_bytes(ptypes.pubkey_from_bytes(raw)) == raw
    for mod in (ptypes, jtypes):
        with pytest.raises(ValueError):
            mod.pubkey_from_bytes(raw[:47])
        with pytest.raises(ValueError):
            mod.pubkey_to_bytes("0x" + raw.hex()[:-2])
