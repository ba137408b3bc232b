"""Core workflow types the combine slice needs: Duty, DutyType, PubKey,
ParSignedData and one signed-data type (a RANDAO reveal).

A trimmed copy of the JAX package's core/types.py (reference:
core/types.go); the other duty and data variants come with later slices.
Frozen dataclasses: values crossing component boundaries cannot mutate.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from enum import IntEnum

ZERO_SIG = bytes(96)


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


@dataclass(frozen=True, order=True)
class Duty:
    """The unit of work (reference: core/types.go:95-103)."""

    slot: int
    type: DutyType

    def __str__(self) -> str:
        return f"{self.slot}/{self.type}"


#: 0x-prefixed hex of the 48-byte group public key
PubKey = str


@dataclass(frozen=True)
class SignedRandao:
    """RANDAO reveal: a signature over the epoch."""

    epoch: int
    signature: bytes = ZERO_SIG

    def set_signature(self, sig: bytes) -> "SignedRandao":
        return replace(self, signature=sig)


@dataclass(frozen=True)
class ParSignedData:
    """A partially signed duty datum + the share index that signed it."""

    data: SignedRandao
    share_idx: int

    @property
    def signature(self) -> bytes:
        return self.data.signature
