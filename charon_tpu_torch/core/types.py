"""Core workflow types: Duty, Slot, and the four data abstractions.

Mirrors reference core/types.go:36-480 with Python-idiomatic immutability:
frozen dataclasses replace the reference's Clone() discipline
(reference: core/types.go:343-356) — values crossing component boundaries
cannot be mutated, so no defensive copies are needed.

The four data abstractions (reference: docs/architecture.md):
  DutyDefinition — who does what (from the beacon node, per epoch)
  UnsignedData   — the data to sign (fetched, then agreed via consensus)
  SignedData     — data plus a (possibly partial) BLS signature
  ParSignedData  — SignedData + share index, crossing the cluster
Sets are plain `dict[PubKey, X]` batching all validators of one duty —
the batch axis the device kernels exploit.

A copy of the JAX package's core/types.py (the port imports nothing of
that package).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from enum import IntEnum
from typing import Union

from ..eth2util import spec
from ..eth2util.signing import DomainName


class DutyType(IntEnum):
    """reference: core/types.go:41-58 (enum values are wire-compatible)."""

    UNKNOWN = 0
    PROPOSER = 1
    ATTESTER = 2
    SIGNATURE = 3
    EXIT = 4
    BUILDER_PROPOSER = 5
    BUILDER_REGISTRATION = 6
    RANDAO = 7
    PREPARE_AGGREGATOR = 8
    AGGREGATOR = 9
    SYNC_MESSAGE = 10
    PREPARE_SYNC_CONTRIBUTION = 11
    SYNC_CONTRIBUTION = 12
    INFO_SYNC = 13

    def __str__(self) -> str:
        return self.name.lower()

    @property
    def valid(self) -> bool:
        return self is not DutyType.UNKNOWN


ALL_DUTY_TYPES = tuple(t for t in DutyType if t is not DutyType.UNKNOWN)


@dataclass(frozen=True, order=True)
class Duty:
    """The unit of work (reference: core/types.go:95-103)."""

    slot: int
    type: DutyType

    def __str__(self) -> str:
        return f"{self.slot}/{self.type}"


def new_attester_duty(slot: int) -> Duty:
    return Duty(slot, DutyType.ATTESTER)


def new_proposer_duty(slot: int) -> Duty:
    return Duty(slot, DutyType.PROPOSER)


def new_randao_duty(slot: int) -> Duty:
    return Duty(slot, DutyType.RANDAO)


def new_aggregator_duty(slot: int) -> Duty:
    return Duty(slot, DutyType.AGGREGATOR)


@dataclass(frozen=True)
class SlotTick:
    """A scheduler slot tick (reference: core/types.go `Slot`)."""

    slot: int
    time: float  # unix seconds of slot start
    slot_duration: float
    slots_per_epoch: int

    @property
    def epoch(self) -> int:
        return self.slot // self.slots_per_epoch

    @property
    def first_in_epoch(self) -> bool:
        return self.slot % self.slots_per_epoch == 0

    @property
    def last_in_epoch(self) -> bool:
        return self.slot % self.slots_per_epoch == self.slots_per_epoch - 1

    def next(self) -> "SlotTick":
        return SlotTick(self.slot + 1, self.time + self.slot_duration,
                        self.slot_duration, self.slots_per_epoch)


# Kept under the reference's name too.
Slot = SlotTick


# ---------------------------------------------------------------------------
# PubKey: 0x-prefixed 98-char hex of the 48-byte group public key
# (reference: core/types.go PubKey)
# ---------------------------------------------------------------------------

PubKey = str


def pubkey_from_bytes(b: bytes) -> PubKey:
    if len(b) != 48:
        raise ValueError("pubkey must be 48 bytes")
    return "0x" + b.hex()


def pubkey_to_bytes(pk: PubKey) -> bytes:
    if not pk.startswith("0x") or len(pk) != 98:
        raise ValueError(f"invalid pubkey {pk!r}")
    return bytes.fromhex(pk[2:])


# ---------------------------------------------------------------------------
# DutyDefinition variants (reference: core/dutydefinition.go)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AttesterDefinition:
    """From the beacon node's attester-duties endpoint."""

    pubkey: PubKey
    slot: int
    validator_index: int
    committee_index: int
    committee_length: int
    committees_at_slot: int
    validator_committee_index: int


@dataclass(frozen=True)
class ProposerDefinition:
    pubkey: PubKey
    slot: int
    validator_index: int


@dataclass(frozen=True)
class SyncCommitteeDefinition:
    pubkey: PubKey
    validator_index: int
    validator_sync_committee_indices: tuple[int, ...]


DutyDefinition = Union[AttesterDefinition, ProposerDefinition,
                       SyncCommitteeDefinition]
DutyDefinitionSet = dict  # PubKey -> DutyDefinition


# ---------------------------------------------------------------------------
# UnsignedData variants (reference: core/unsigneddata.go:42-368)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AttestationDataUD:
    """Attestation data + the duty info needed to map it back to validators
    (reference: core/unsigneddata.go AttestationData)."""

    data: spec.AttestationData
    duty: AttesterDefinition

    def hash_tree_root(self) -> bytes:
        return self.data.hash_tree_root()


@dataclass(frozen=True)
class VersionedBeaconBlockUD:
    block: spec.BeaconBlock

    def hash_tree_root(self) -> bytes:
        return self.block.hash_tree_root()


@dataclass(frozen=True)
class AggregatedAttestationUD:
    attestation: spec.Attestation

    def hash_tree_root(self) -> bytes:
        return self.attestation.hash_tree_root()


@dataclass(frozen=True)
class SyncContributionUD:
    contribution: spec.SyncCommitteeContribution

    def hash_tree_root(self) -> bytes:
        return self.contribution.hash_tree_root()


UnsignedData = Union[AttestationDataUD, VersionedBeaconBlockUD,
                     AggregatedAttestationUD, SyncContributionUD]
UnsignedDataSet = dict  # PubKey -> UnsignedData


# ---------------------------------------------------------------------------
# SignedData variants (reference: core/signeddata.go:61-1155)
# Every variant exposes: signature, set_signature(sig) -> new value,
# message_root() -> the object root that is BLS-signed (pre-domain), and
# signing_info() -> (DomainName, epoch) so verifiers can recompute the
# signing root (reference: core/eth2signeddata.go:100-177).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SignedAttestation:
    attestation: spec.Attestation

    @property
    def signature(self) -> bytes:
        return self.attestation.signature

    def set_signature(self, sig: bytes) -> "SignedAttestation":
        return SignedAttestation(self.attestation.replace(signature=sig))

    def message_root(self) -> bytes:
        return self.attestation.data.hash_tree_root()

    def signing_info(self, slots_per_epoch: int) -> tuple[DomainName, int]:
        return DomainName.BEACON_ATTESTER, self.attestation.data.target.epoch


@dataclass(frozen=True)
class SignedBlock:
    block: spec.SignedBeaconBlock

    @property
    def signature(self) -> bytes:
        return self.block.signature

    def set_signature(self, sig: bytes) -> "SignedBlock":
        return SignedBlock(self.block.replace(signature=sig))

    def message_root(self) -> bytes:
        return self.block.message.hash_tree_root()

    def signing_info(self, slots_per_epoch: int) -> tuple[DomainName, int]:
        return DomainName.BEACON_PROPOSER, self.block.message.slot // slots_per_epoch


@dataclass(frozen=True)
class SignedRandao:
    """RANDAO reveal: signature over the epoch (reference: core/signeddata.go
    SignedRandao wraps eth2util.SignedEpoch)."""

    epoch: int
    signature: bytes = spec.ZERO_SIG

    def set_signature(self, sig: bytes) -> "SignedRandao":
        return replace(self, signature=sig)

    def message_root(self) -> bytes:
        from ..eth2util import ssz
        return ssz.uint64.hash_tree_root(self.epoch)

    def signing_info(self, slots_per_epoch: int) -> tuple[DomainName, int]:
        return DomainName.RANDAO, self.epoch


@dataclass(frozen=True)
class SignedExit:
    exit: spec.SignedVoluntaryExit

    @property
    def signature(self) -> bytes:
        return self.exit.signature

    def set_signature(self, sig: bytes) -> "SignedExit":
        return SignedExit(self.exit.replace(signature=sig))

    def message_root(self) -> bytes:
        return self.exit.message.hash_tree_root()

    def signing_info(self, slots_per_epoch: int) -> tuple[DomainName, int]:
        return DomainName.VOLUNTARY_EXIT, self.exit.message.epoch


@dataclass(frozen=True)
class SignedRegistration:
    registration: spec.SignedValidatorRegistration

    @property
    def signature(self) -> bytes:
        return self.registration.signature

    def set_signature(self, sig: bytes) -> "SignedRegistration":
        return SignedRegistration(self.registration.replace(signature=sig))

    def message_root(self) -> bytes:
        return self.registration.message.hash_tree_root()

    def signing_info(self, slots_per_epoch: int) -> tuple[DomainName, int]:
        return DomainName.APPLICATION_BUILDER, 0


@dataclass(frozen=True)
class SignedBeaconCommitteeSelection:
    """Slot selection proof (DVT aggregation pre-duty,
    reference: core/signeddata.go BeaconCommitteeSelection)."""

    selection: spec.BeaconCommitteeSelection

    @property
    def signature(self) -> bytes:
        return self.selection.selection_proof

    def set_signature(self, sig: bytes) -> "SignedBeaconCommitteeSelection":
        return SignedBeaconCommitteeSelection(
            self.selection.replace(selection_proof=sig))

    def message_root(self) -> bytes:
        return spec.slot_hash_root(self.selection.slot)

    def signing_info(self, slots_per_epoch: int) -> tuple[DomainName, int]:
        return DomainName.SELECTION_PROOF, self.selection.slot // slots_per_epoch


@dataclass(frozen=True)
class SignedSyncCommitteeSelection:
    """Sync-committee selection proof (DVT sync-aggregation pre-duty,
    reference: core/signeddata.go SyncCommitteeSelection).  Signing root is
    the SyncAggregatorSelectionData HTR (altair spec)."""

    selection: spec.SyncCommitteeSelection

    @property
    def signature(self) -> bytes:
        return self.selection.selection_proof

    def set_signature(self, sig: bytes) -> "SignedSyncCommitteeSelection":
        return SignedSyncCommitteeSelection(
            self.selection.replace(selection_proof=sig))

    def message_root(self) -> bytes:
        return spec.SyncAggregatorSelectionData(
            slot=self.selection.slot,
            subcommittee_index=self.selection.subcommittee_index,
        ).hash_tree_root()

    def signing_info(self, slots_per_epoch: int) -> tuple[DomainName, int]:
        return (DomainName.SYNC_COMMITTEE_SELECTION_PROOF,
                self.selection.slot // slots_per_epoch)


@dataclass(frozen=True)
class SignedAggregateAndProofSD:
    agg: spec.SignedAggregateAndProof

    @property
    def signature(self) -> bytes:
        return self.agg.signature

    def set_signature(self, sig: bytes) -> "SignedAggregateAndProofSD":
        return SignedAggregateAndProofSD(self.agg.replace(signature=sig))

    def message_root(self) -> bytes:
        return self.agg.message.hash_tree_root()

    def signing_info(self, slots_per_epoch: int) -> tuple[DomainName, int]:
        return (DomainName.AGGREGATE_AND_PROOF,
                self.agg.message.aggregate.data.slot // slots_per_epoch)


@dataclass(frozen=True)
class SignedSyncMessage:
    message: spec.SyncCommitteeMessage

    @property
    def signature(self) -> bytes:
        return self.message.signature

    def set_signature(self, sig: bytes) -> "SignedSyncMessage":
        return SignedSyncMessage(self.message.replace(signature=sig))

    def message_root(self) -> bytes:
        return self.message.beacon_block_root

    def signing_info(self, slots_per_epoch: int) -> tuple[DomainName, int]:
        return DomainName.SYNC_COMMITTEE, self.message.slot // slots_per_epoch


@dataclass(frozen=True)
class SignedSyncContributionAndProof:
    contribution: spec.SignedContributionAndProof

    @property
    def signature(self) -> bytes:
        return self.contribution.signature

    def set_signature(self, sig: bytes) -> "SignedSyncContributionAndProof":
        return SignedSyncContributionAndProof(
            self.contribution.replace(signature=sig))

    def message_root(self) -> bytes:
        return self.contribution.message.hash_tree_root()

    def signing_info(self, slots_per_epoch: int) -> tuple[DomainName, int]:
        return (DomainName.CONTRIBUTION_AND_PROOF,
                self.contribution.message.contribution.slot // slots_per_epoch)


SignedData = Union[SignedAttestation, SignedBlock, SignedRandao, SignedExit,
                   SignedRegistration, SignedBeaconCommitteeSelection,
                   SignedSyncCommitteeSelection,
                   SignedAggregateAndProofSD, SignedSyncMessage,
                   SignedSyncContributionAndProof]
SignedDataSet = dict  # PubKey -> SignedData


@dataclass(frozen=True)
class ParSignedData:
    """A partially signed duty datum + the share index that signed it
    (reference: core/types.go ParSignedData)."""

    data: SignedData
    share_idx: int

    @property
    def signature(self) -> bytes:
        return self.data.signature

    def message_root(self) -> bytes:
        return self.data.message_root()


ParSignedDataSet = dict  # PubKey -> ParSignedData
