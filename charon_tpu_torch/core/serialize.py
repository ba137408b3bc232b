"""Wire codec for core types — the reference's corepb protobufs analogue
(reference: core/corepb/v1/*.proto, core/proto.go:26-208).

Tagged-JSON encoding of the frozen dataclass graph: every dataclass is
`{"__t": <registered name>, ...fields}`, bytes are `{"__b": <hex>}`,
sequences decode back to tuples (all sequence fields in core/eth2util
types are tuples, keeping values hashable for QBFT).  Deterministic
(sorted keys) so equal values encode identically — consensus hashes rely
on that.

A copy of the JAX package's core/serialize.py: the same bytes for the
same values, so port and JAX nodes read each other's frames.
"""

from __future__ import annotations

import dataclasses
import json
from enum import IntEnum
from typing import Any

from ..eth2util import spec
from . import priority, qbft, types

# Registry of wire-visible dataclasses.
_CLASSES: dict[str, type] = {}


def _register(*classes: type) -> None:
    for c in classes:
        _CLASSES[c.__name__] = c


_register(
    types.Duty, types.ParSignedData,
    types.AttesterDefinition, types.ProposerDefinition,
    types.SyncCommitteeDefinition,
    types.AttestationDataUD, types.VersionedBeaconBlockUD,
    types.AggregatedAttestationUD, types.SyncContributionUD,
    types.SignedAttestation, types.SignedBlock, types.SignedRandao,
    types.SignedExit, types.SignedRegistration,
    types.SignedBeaconCommitteeSelection, types.SignedSyncCommitteeSelection,
    types.SignedAggregateAndProofSD,
    types.SignedSyncMessage, types.SignedSyncContributionAndProof,
    spec.Checkpoint, spec.AttestationData, spec.Attestation,
    spec.BeaconBlock, spec.SignedBeaconBlock, spec.VoluntaryExit,
    spec.SignedVoluntaryExit, spec.ValidatorRegistration,
    spec.SignedValidatorRegistration, spec.AggregateAndProof,
    spec.SignedAggregateAndProof, spec.SyncCommitteeMessage,
    spec.SyncCommitteeContribution, spec.ContributionAndProof,
    spec.SignedContributionAndProof, spec.BeaconCommitteeSelection,
    spec.SyncCommitteeSelection,
    priority.PriorityMsg, priority.TopicResult,
    qbft.Msg,
)


def to_jsonable(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, bytes):
        return {"__b": obj.hex()}
    if isinstance(obj, IntEnum):
        return int(obj)
    if dataclasses.is_dataclass(obj):
        out = {"__t": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = to_jsonable(getattr(obj, f.name))
        return out
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {"__d": [[to_jsonable(k), to_jsonable(v)]
                        for k, v in sorted(obj.items(), key=lambda kv: str(kv[0]))]}
    raise TypeError(f"cannot serialise {type(obj).__name__}")


def from_jsonable(data: Any) -> Any:
    if data is None or isinstance(data, (bool, int, float, str)):
        return data
    if isinstance(data, list):
        return tuple(from_jsonable(x) for x in data)
    if isinstance(data, dict):
        if "__b" in data and len(data) == 1:
            return bytes.fromhex(data["__b"])
        if "__d" in data and len(data) == 1:
            return {from_jsonable(k): from_jsonable(v)
                    for k, v in data["__d"]}
        if "__t" in data:
            cls = _CLASSES[data["__t"]]
            kwargs = {k: from_jsonable(v) for k, v in data.items()
                      if k != "__t"}
            # enum fields: Duty.type / qbft Msg.type
            if cls is types.Duty:
                kwargs["type"] = types.DutyType(kwargs["type"])
            if cls is qbft.Msg:
                kwargs["type"] = qbft.MsgType(kwargs["type"])
            return cls(**kwargs)
        raise TypeError(f"unknown wire object keys {list(data)}")
    raise TypeError(f"cannot deserialise {type(data).__name__}")


def encode(obj: Any) -> bytes:
    return json.dumps(to_jsonable(obj), separators=(",", ":"),
                      sort_keys=True).encode()


def decode(data: bytes) -> Any:
    return from_jsonable(json.loads(data.decode()))


# -- duty-scoped envelopes ---------------------------------------------------

def encode_parsig_set(duty: types.Duty, pset: dict) -> bytes:
    return encode({"duty": duty, "set": pset})


def decode_parsig_set(data: bytes) -> tuple:
    obj = decode(data)
    return obj["duty"], obj["set"]


def encode_consensus_msg(duty: types.Duty, msg: qbft.Msg) -> bytes:
    return encode({"duty": duty, "msg": msg})


def decode_consensus_msg(data: bytes) -> tuple:
    obj = decode(data)
    return obj["duty"], obj["msg"]
