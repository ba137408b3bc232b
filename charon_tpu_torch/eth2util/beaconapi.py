"""Beacon-API JSON codecs: spec dataclasses ↔ the eth2 HTTP wire format.

The reference consumes attestantio/go-eth2-client's generated JSON codecs;
here the needed subset is hand-rolled with the same wire conventions
(integers as decimal strings, byte fields as 0x-hex), so that the HTTP
beaconmock (testutil/beaconmock_http.py), the beacon client
(eth2util/beacon_client.py) and the validator-API router (app/router.py)
all interoperate with real beacon-API peers for the fields the pipeline
uses.

Reference shapes: the beacon-api OpenAPI spec as exercised by
core/validatorapi/router.go:84-212 and testutil/beaconmock/static.json.

A copy of the JAX package's eth2util/beaconapi.py.
"""

from __future__ import annotations

from . import spec
from .ssz import Bitlist


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def hex_of(b: bytes) -> str:
    return "0x" + bytes(b).hex()


def to_bytes(s: str, length: int | None = None) -> bytes:
    if not isinstance(s, str) or not s.startswith("0x"):
        raise ValueError(f"expected 0x-hex string, got {s!r}")
    out = bytes.fromhex(s[2:])
    if length is not None and len(out) != length:
        raise ValueError(f"expected {length} bytes, got {len(out)}")
    return out


def to_int(v) -> int:
    return int(v)


def bits_hex(bits: tuple) -> str:
    """SSZ bitlist (payload, bit_length) → 0x-hex with delimiter bit."""
    return hex_of(Bitlist.to_ssz_bytes(bits))


def bits_from_hex(s: str) -> tuple:
    return Bitlist.from_ssz_bytes(to_bytes(s))


# ---------------------------------------------------------------------------
# per-type codecs
# ---------------------------------------------------------------------------

def checkpoint_json(c: spec.Checkpoint) -> dict:
    return {"epoch": str(c.epoch), "root": hex_of(c.root)}


def checkpoint_from(d: dict) -> spec.Checkpoint:
    return spec.Checkpoint(epoch=to_int(d["epoch"]),
                           root=to_bytes(d["root"], 32))


def att_data_json(a: spec.AttestationData) -> dict:
    return {
        "slot": str(a.slot),
        "index": str(a.index),
        "beacon_block_root": hex_of(a.beacon_block_root),
        "source": checkpoint_json(a.source),
        "target": checkpoint_json(a.target),
    }


def att_data_from(d: dict) -> spec.AttestationData:
    return spec.AttestationData(
        slot=to_int(d["slot"]), index=to_int(d["index"]),
        beacon_block_root=to_bytes(d["beacon_block_root"], 32),
        source=checkpoint_from(d["source"]),
        target=checkpoint_from(d["target"]))


def attestation_json(a: spec.Attestation) -> dict:
    return {
        "aggregation_bits": bits_hex(a.aggregation_bits),
        "data": att_data_json(a.data),
        "signature": hex_of(a.signature),
    }


def attestation_from(d: dict) -> spec.Attestation:
    return spec.Attestation(
        aggregation_bits=bits_from_hex(d["aggregation_bits"]),
        data=att_data_from(d["data"]),
        signature=to_bytes(d["signature"], 96))


def block_json(b: spec.BeaconBlock) -> dict:
    """Simplified block container (spec.py module doc): the opaque `body`
    payload rides in an extension field the router/mock round-trip."""
    return {
        "slot": str(b.slot),
        "proposer_index": str(b.proposer_index),
        "parent_root": hex_of(b.parent_root),
        "state_root": hex_of(b.state_root),
        "body_root": hex_of(b.body_root),
        "body": hex_of(b.body),
        "blinded": b.blinded,
    }


def block_from(d: dict) -> spec.BeaconBlock:
    return spec.BeaconBlock(
        slot=to_int(d["slot"]), proposer_index=to_int(d["proposer_index"]),
        parent_root=to_bytes(d["parent_root"], 32),
        state_root=to_bytes(d["state_root"], 32),
        body_root=to_bytes(d["body_root"], 32),
        body=to_bytes(d.get("body", "0x")),
        blinded=bool(d.get("blinded", False)))


def signed_block_json(b: spec.SignedBeaconBlock) -> dict:
    return {"message": block_json(b.message), "signature": hex_of(b.signature)}


def signed_block_from(d: dict) -> spec.SignedBeaconBlock:
    return spec.SignedBeaconBlock(message=block_from(d["message"]),
                                  signature=to_bytes(d["signature"], 96))


def exit_json(e: spec.SignedVoluntaryExit) -> dict:
    return {
        "message": {"epoch": str(e.message.epoch),
                    "validator_index": str(e.message.validator_index)},
        "signature": hex_of(e.signature),
    }


def exit_from(d: dict) -> spec.SignedVoluntaryExit:
    return spec.SignedVoluntaryExit(
        message=spec.VoluntaryExit(
            epoch=to_int(d["message"]["epoch"]),
            validator_index=to_int(d["message"]["validator_index"])),
        signature=to_bytes(d["signature"], 96))


def registration_json(r: spec.SignedValidatorRegistration) -> dict:
    return {
        "message": {
            "fee_recipient": hex_of(r.message.fee_recipient),
            "gas_limit": str(r.message.gas_limit),
            "timestamp": str(r.message.timestamp),
            "pubkey": hex_of(r.message.pubkey),
        },
        "signature": hex_of(r.signature),
    }


def registration_from(d: dict) -> spec.SignedValidatorRegistration:
    m = d["message"]
    return spec.SignedValidatorRegistration(
        message=spec.ValidatorRegistration(
            fee_recipient=to_bytes(m["fee_recipient"], 20),
            gas_limit=to_int(m["gas_limit"]),
            timestamp=to_int(m["timestamp"]),
            pubkey=to_bytes(m["pubkey"], 48)),
        signature=to_bytes(d["signature"], 96))


def agg_and_proof_json(a: spec.SignedAggregateAndProof) -> dict:
    return {
        "message": {
            "aggregator_index": str(a.message.aggregator_index),
            "aggregate": attestation_json(a.message.aggregate),
            "selection_proof": hex_of(a.message.selection_proof),
        },
        "signature": hex_of(a.signature),
    }


def agg_and_proof_from(d: dict) -> spec.SignedAggregateAndProof:
    m = d["message"]
    return spec.SignedAggregateAndProof(
        message=spec.AggregateAndProof(
            aggregator_index=to_int(m["aggregator_index"]),
            aggregate=attestation_from(m["aggregate"]),
            selection_proof=to_bytes(m["selection_proof"], 96)),
        signature=to_bytes(d["signature"], 96))


def sync_msg_json(m: spec.SyncCommitteeMessage) -> dict:
    return {
        "slot": str(m.slot),
        "beacon_block_root": hex_of(m.beacon_block_root),
        "validator_index": str(m.validator_index),
        "signature": hex_of(m.signature),
    }


def sync_msg_from(d: dict) -> spec.SyncCommitteeMessage:
    return spec.SyncCommitteeMessage(
        slot=to_int(d["slot"]),
        beacon_block_root=to_bytes(d["beacon_block_root"], 32),
        validator_index=to_int(d["validator_index"]),
        signature=to_bytes(d["signature"], 96))


def sync_contribution_json(c: spec.SyncCommitteeContribution) -> dict:
    return {
        "slot": str(c.slot),
        "beacon_block_root": hex_of(c.beacon_block_root),
        "subcommittee_index": str(c.subcommittee_index),
        "aggregation_bits": bits_hex(c.aggregation_bits),
        "signature": hex_of(c.signature),
    }


def sync_contribution_from(d: dict) -> spec.SyncCommitteeContribution:
    return spec.SyncCommitteeContribution(
        slot=to_int(d["slot"]),
        beacon_block_root=to_bytes(d["beacon_block_root"], 32),
        subcommittee_index=to_int(d["subcommittee_index"]),
        aggregation_bits=bits_from_hex(d["aggregation_bits"]),
        signature=to_bytes(d["signature"], 96))


def contribution_and_proof_json(c: spec.SignedContributionAndProof) -> dict:
    return {
        "message": {
            "aggregator_index": str(c.message.aggregator_index),
            "contribution": sync_contribution_json(c.message.contribution),
            "selection_proof": hex_of(c.message.selection_proof),
        },
        "signature": hex_of(c.signature),
    }


def contribution_and_proof_from(d: dict) -> spec.SignedContributionAndProof:
    m = d["message"]
    return spec.SignedContributionAndProof(
        message=spec.ContributionAndProof(
            aggregator_index=to_int(m["aggregator_index"]),
            contribution=sync_contribution_from(m["contribution"]),
            selection_proof=to_bytes(m["selection_proof"], 96)),
        signature=to_bytes(d["signature"], 96))


def bcomm_selection_json(s: spec.BeaconCommitteeSelection) -> dict:
    return {
        "validator_index": str(s.validator_index),
        "slot": str(s.slot),
        "selection_proof": hex_of(s.selection_proof),
    }


def bcomm_selection_from(d: dict) -> spec.BeaconCommitteeSelection:
    return spec.BeaconCommitteeSelection(
        validator_index=to_int(d["validator_index"]),
        slot=to_int(d["slot"]),
        selection_proof=to_bytes(d["selection_proof"], 96))


def sync_selection_json(s: spec.SyncCommitteeSelection) -> dict:
    return {
        "validator_index": str(s.validator_index),
        "slot": str(s.slot),
        "subcommittee_index": str(s.subcommittee_index),
        "selection_proof": hex_of(s.selection_proof),
    }


def sync_selection_from(d: dict) -> spec.SyncCommitteeSelection:
    return spec.SyncCommitteeSelection(
        validator_index=to_int(d["validator_index"]),
        slot=to_int(d["slot"]),
        subcommittee_index=to_int(d["subcommittee_index"]),
        selection_proof=to_bytes(d["selection_proof"], 96))


def validator_json(v: spec.Validator) -> dict:
    return {
        "index": str(v.index),
        "balance": str(v.balance),
        "status": v.status,
        "validator": {
            "pubkey": hex_of(v.pubkey),
            "effective_balance": str(v.balance),
            "activation_epoch": "0",
            "exit_epoch": str((1 << 64) - 1),
        },
    }


def validator_from(d: dict) -> spec.Validator:
    return spec.Validator(
        index=to_int(d["index"]),
        pubkey=to_bytes(d["validator"]["pubkey"], 48),
        balance=to_int(d.get("balance", "0")),
        status=d.get("status", "active_ongoing"))


# -- duty responses ---------------------------------------------------------

def attester_duty_json(d) -> dict:
    return {
        "pubkey": hex_of(d.pubkey),
        "validator_index": str(d.validator_index),
        "slot": str(d.slot),
        "committee_index": str(d.committee_index),
        "committee_length": str(d.committee_length),
        "committees_at_slot": str(d.committees_at_slot),
        "validator_committee_index": str(d.validator_committee_index),
    }


def attester_duty_from(d: dict):
    from ..testutil.beaconmock import AttesterDutyInfo

    return AttesterDutyInfo(
        pubkey=to_bytes(d["pubkey"], 48),
        validator_index=to_int(d["validator_index"]),
        slot=to_int(d["slot"]),
        committee_index=to_int(d["committee_index"]),
        committee_length=to_int(d["committee_length"]),
        committees_at_slot=to_int(d["committees_at_slot"]),
        validator_committee_index=to_int(d["validator_committee_index"]))


def proposer_duty_json(d) -> dict:
    return {
        "pubkey": hex_of(d.pubkey),
        "validator_index": str(d.validator_index),
        "slot": str(d.slot),
    }


def proposer_duty_from(d: dict):
    from ..testutil.beaconmock import ProposerDutyInfo

    return ProposerDutyInfo(
        pubkey=to_bytes(d["pubkey"], 48),
        validator_index=to_int(d["validator_index"]),
        slot=to_int(d["slot"]))


def sync_duty_json(d) -> dict:
    return {
        "pubkey": hex_of(d.pubkey),
        "validator_index": str(d.validator_index),
        "validator_sync_committee_indices": [
            str(i) for i in d.sync_committee_indices],
    }


def sync_duty_from(d: dict):
    from ..testutil.beaconmock import SyncDutyInfo

    return SyncDutyInfo(
        pubkey=to_bytes(d["pubkey"], 48),
        validator_index=to_int(d["validator_index"]),
        sync_committee_indices=[
            to_int(i) for i in d["validator_sync_committee_indices"]])
