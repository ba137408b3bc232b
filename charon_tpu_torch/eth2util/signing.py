"""Eth2 signing domains and signing-root computation.

Mirrors reference eth2util/signing/signing.go:35-152: domain names, fork-data
root, domain computation, and the signing root HTR(SigningData{root, domain})
that every duty signature commits to.  A copy of the JAX package's
eth2util/signing.py.
"""

from __future__ import annotations

from enum import Enum

from .spec import ForkData, SigningData


class DomainName(str, Enum):
    """reference: eth2util/signing/signing.go:37-50."""

    BEACON_PROPOSER = "DOMAIN_BEACON_PROPOSER"
    BEACON_ATTESTER = "DOMAIN_BEACON_ATTESTER"
    RANDAO = "DOMAIN_RANDAO"
    VOLUNTARY_EXIT = "DOMAIN_VOLUNTARY_EXIT"
    APPLICATION_BUILDER = "DOMAIN_APPLICATION_BUILDER"
    SELECTION_PROOF = "DOMAIN_SELECTION_PROOF"
    AGGREGATE_AND_PROOF = "DOMAIN_AGGREGATE_AND_PROOF"
    SYNC_COMMITTEE = "DOMAIN_SYNC_COMMITTEE"
    SYNC_COMMITTEE_SELECTION_PROOF = "DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF"
    CONTRIBUTION_AND_PROOF = "DOMAIN_CONTRIBUTION_AND_PROOF"
    DEPOSIT = "DOMAIN_DEPOSIT"


# Domain type constants (4 bytes, consensus-specs phase0/altair/bellatrix).
DOMAIN_TYPES: dict[DomainName, bytes] = {
    DomainName.BEACON_PROPOSER: bytes.fromhex("00000000"),
    DomainName.BEACON_ATTESTER: bytes.fromhex("01000000"),
    DomainName.RANDAO: bytes.fromhex("02000000"),
    DomainName.DEPOSIT: bytes.fromhex("03000000"),
    DomainName.VOLUNTARY_EXIT: bytes.fromhex("04000000"),
    DomainName.SELECTION_PROOF: bytes.fromhex("05000000"),
    DomainName.AGGREGATE_AND_PROOF: bytes.fromhex("06000000"),
    DomainName.SYNC_COMMITTEE: bytes.fromhex("07000000"),
    DomainName.SYNC_COMMITTEE_SELECTION_PROOF: bytes.fromhex("08000000"),
    DomainName.CONTRIBUTION_AND_PROOF: bytes.fromhex("09000000"),
    DomainName.APPLICATION_BUILDER: bytes.fromhex("00000001"),
}


def compute_fork_data_root(current_version: bytes,
                           genesis_validators_root: bytes) -> bytes:
    return ForkData(current_version, genesis_validators_root).hash_tree_root()


def compute_domain(name: DomainName, fork_version: bytes,
                   genesis_validators_root: bytes) -> bytes:
    """domain = domain_type(4) ++ fork_data_root[:28]."""
    fork_root = compute_fork_data_root(fork_version, genesis_validators_root)
    return DOMAIN_TYPES[name] + fork_root[:28]


def signing_root(name: DomainName, object_root: bytes, fork_version: bytes,
                 genesis_validators_root: bytes = bytes(32)) -> bytes:
    """HTR(SigningData{object_root, domain}) — what actually gets BLS-signed
    (reference: eth2util/signing/signing.go:73-86 GetDataRoot)."""
    domain = compute_domain(name, fork_version, genesis_validators_root)
    return SigningData(object_root=object_root, domain=domain).hash_tree_root()
