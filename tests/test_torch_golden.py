"""Golden-file snapshot tests of the port's on-disk and on-wire formats.

The five cases of the JAX package's tests/test_golden.py on the port's
modules, held to the SAME committed snapshots under tests/testdata/
(`charon_tpu_torch.testutil.golden` only reads them): the cluster
definition and lock JSON, the beacon-API attestation JSON, and the core
wire codec's parsig set — the formats the two packages share — plus the
operator config/ENR signatures on the port's own Ed25519.
"""

import json
from dataclasses import replace

import pytest

from charon_tpu_torch.cluster.definition import (Definition, DistValidator,
                                                 Lock, Operator,
                                                 definition_to_json,
                                                 lock_to_json, sign_operator,
                                                 verify_definition_signatures)
from charon_tpu_torch.core import serialize
from charon_tpu_torch.core.types import (Duty, DutyType, ParSignedData,
                                         SignedAttestation)
from charon_tpu_torch.eth2util import beaconapi, spec
from charon_tpu_torch.eth2util.ssz import Bitlist
from charon_tpu_torch.p2p import identity as ident
from charon_tpu_torch.testutil.golden import require_golden_json


def _fixed_definition() -> Definition:
    return Definition(
        name="golden-cluster",
        operators=tuple(
            Operator(address=f"op{i}",
                     enr=f"ed25519:{bytes([i]*32).hex()}@10.0.0.{i}:160{i}0")
            for i in range(4)),
        threshold=3, num_validators=2,
        fork_version=bytes.fromhex("00000000"),
        timestamp="2026-07-30T00:00:00Z")


def test_golden_cluster_definition():
    require_golden_json("cluster_definition",
                        definition_to_json(_fixed_definition()))


def test_golden_cluster_lock():
    lock = Lock(
        definition=_fixed_definition(),
        validators=tuple(
            DistValidator(public_key=bytes([v + 1] * 48),
                          public_shares=tuple(bytes([v + 1, i]) + bytes(46)
                                              for i in range(4)))
            for v in range(2)),
        signature_aggregate=bytes(96 * 2))
    require_golden_json("cluster_lock", lock_to_json(lock))


def _fixed_attestation() -> spec.Attestation:
    data = spec.AttestationData(
        slot=12, index=1, beacon_block_root=bytes([7] * 32),
        source=spec.Checkpoint(epoch=0, root=bytes(32)),
        target=spec.Checkpoint(epoch=1, root=bytes([7] * 32)))
    return spec.Attestation(
        aggregation_bits=Bitlist.from_bools([i == 3 for i in range(8)]),
        data=data, signature=bytes([9] * 96))


def test_golden_beaconapi_attestation():
    require_golden_json("beaconapi_attestation",
                        beaconapi.attestation_json(_fixed_attestation()))


def test_golden_wire_parsig_set():
    duty = Duty(12, DutyType.ATTESTER)
    pset = {"0x" + "ab" * 48: ParSignedData(
        data=SignedAttestation(attestation=_fixed_attestation()),
        share_idx=2)}
    encoded = serialize.encode_parsig_set(duty, pset)
    # snapshot the decoded-normalised JSON (deterministic by construction)
    require_golden_json("wire_parsig_set", json.loads(encoded.decode()))
    # and the round-trip must be lossless
    rduty, rset = serialize.decode_parsig_set(encoded)
    assert rduty == duty
    assert rset["0x" + "ab" * 48].share_idx == 2


def test_operator_signatures_sign_and_verify():
    """Operator config/ENR signatures (reference: cluster/eip712sigs.go):
    signed definitions verify; any tamper fails."""
    ids = [ident.NodeIdentity.generate(seed=bytes([i])) for i in range(4)]
    d = Definition(
        name="sig-cluster",
        operators=tuple(
            Operator(address=f"op{i}", enr=n.enr("10.0.0.1", 16000 + i))
            for i, n in enumerate(ids)),
        threshold=3, num_validators=1)
    for i, n in enumerate(ids):
        d = sign_operator(d, i, n)
    verify_definition_signatures(d)  # all good

    # tampered ENR fails
    bad_ops = list(d.operators)
    other = ident.NodeIdentity.generate(seed=b"\xff")
    bad_ops[1] = Operator(address="op1", enr=other.enr("10.0.0.1", 16001),
                          config_signature=d.operators[1].config_signature,
                          enr_signature=d.operators[1].enr_signature)
    with pytest.raises(ValueError):
        verify_definition_signatures(replace(d, operators=tuple(bad_ops)))
    # missing signature fails
    with pytest.raises(ValueError):
        verify_definition_signatures(
            replace(d, operators=tuple(
                Operator(address=o.address, enr=o.enr)
                for o in d.operators)))
