"""Cluster Definition and Lock.

Mirrors reference cluster/definition.go:89-133 + cluster/lock.go:31-46 +
cluster/distvalidator.go:25-50:

- Definition: the operator-agreed cluster intent (name, operators with
  addresses/ENR-equivalents, fork version, threshold, validator count).
- Lock: definition + DistValidator[] (group pubkey + per-node pubshares)
  + `signature_aggregate`, a BLS aggregate-of-threshold-signatures over
  the lock hash proving every node took part in the key ceremony
  (reference: cluster/lock.go:118-179 VerifySignatures).

Hashes are SSZ hash-tree-roots (reference: cluster/ssz.go:1-386) computed
with eth2util.ssz; JSON codecs round-trip the files for on-disk use
(reference JSON lock format, versioned v1.x).

A copy of the JAX package's cluster/definition.py: the same hashes and
JSON, over the port's tbls API (so `verify_lock`'s group-signature checks
run on the card unless the caller chose the CPU) and the port's Ed25519.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, replace

from ..eth2util import ssz
from ..tbls import api as tbls

VERSION = "tpu/v1.0.0"


@dataclass(frozen=True)
class Operator:
    """A cluster operator (reference: cluster/definition.go Operator).
    `address` is the operator's wallet/identity string; `enr` carries the
    p2p endpoint (host:port in this framework's static addressing)."""

    address: str
    enr: str = ""
    config_signature: bytes = b""
    enr_signature: bytes = b""

    SSZ = ssz.Container([
        ("address", ssz.ByteList(64)),
        ("enr", ssz.ByteList(256)),
    ])

    def ssz_value(self) -> dict:
        return {"address": self.address.encode(), "enr": self.enr.encode()}


@dataclass(frozen=True)
class Definition:
    name: str
    operators: tuple[Operator, ...]
    threshold: int
    num_validators: int
    fork_version: bytes = bytes(4)
    dkg_algorithm: str = "default"
    timestamp: str = ""
    version: str = VERSION

    @property
    def num_operators(self) -> int:
        return len(self.operators)

    def peers(self) -> list[tuple[int, str]]:
        """(index, enr) pairs."""
        return [(i, op.enr) for i, op in enumerate(self.operators)]


# Signed operator entry: the full definition hash commits to the operator
# signatures (reference: cluster/ssz.go hashes signed operators into the
# definition hash), while the CONFIG hash — the thing each operator signs —
# excludes them to avoid circularity.
_SIGNED_OP_SSZ = ssz.Container([
    ("address", ssz.ByteList(64)),
    ("enr", ssz.ByteList(256)),
    ("config_signature", ssz.ByteList(96)),
    ("enr_signature", ssz.ByteList(96)),
])


def _def_fields(d: Definition, signed: bool) -> dict:
    return {
        "name": d.name.encode(),
        "version": d.version.encode(),
        "threshold": d.threshold,
        "num_validators": d.num_validators,
        "fork_version": d.fork_version,
        "dkg_algorithm": d.dkg_algorithm.encode(),
        "operators": [
            ({**op.ssz_value(),
              "config_signature": op.config_signature,
              "enr_signature": op.enr_signature}
             if signed else op.ssz_value())
            for op in d.operators],
    }


def _def_ssz(signed: bool) -> ssz.Container:
    return ssz.Container([
        ("name", ssz.ByteList(256)),
        ("version", ssz.ByteList(16)),
        ("threshold", ssz.uint64),
        ("num_validators", ssz.uint64),
        ("fork_version", ssz.Bytes4),
        ("dkg_algorithm", ssz.ByteList(32)),
        ("operators", ssz.List(_SIGNED_OP_SSZ if signed else Operator.SSZ,
                               256)),
    ])


_CONFIG_SSZ = _def_ssz(signed=False)
_DEF_SSZ = _def_ssz(signed=True)


def config_hash(d: Definition) -> bytes:
    """SSZ tree root over the configuration TERMS (signatures excluded) —
    the message each operator signs (reference: cluster config hash)."""
    return _CONFIG_SSZ.hash_tree_root(_def_fields(d, signed=False))


def definition_hash(d: Definition) -> bytes:
    """SSZ tree root of the FULL definition including operator signatures
    (reference: cluster/ssz.go hashDefinition) — what the lock references,
    so signature stripping changes every downstream hash."""
    return _DEF_SSZ.hash_tree_root(_def_fields(d, signed=True))


@dataclass(frozen=True)
class DistValidator:
    """One distributed validator (reference: cluster/distvalidator.go:25-50)."""

    public_key: bytes                 # 48B group pubkey
    public_shares: tuple[bytes, ...]  # 48B pubshare per operator (ordered)

    SSZ = ssz.Container([
        ("public_key", ssz.Bytes48),
        ("public_shares", ssz.List(ssz.Bytes48, 256)),
    ])

    def ssz_value(self) -> dict:
        return {"public_key": self.public_key,
                "public_shares": list(self.public_shares)}


@dataclass(frozen=True)
class Lock:
    definition: Definition
    validators: tuple[DistValidator, ...]
    signature_aggregate: bytes = b""

    @property
    def lock_hash(self) -> bytes:
        return lock_hash(self)


_LOCK_SSZ = ssz.Container([
    ("definition_hash", ssz.Bytes32),
    ("validators", ssz.List(DistValidator.SSZ, 65536)),
])


def lock_hash(lock: Lock) -> bytes:
    return _LOCK_SSZ.hash_tree_root({
        "definition_hash": definition_hash(lock.definition),
        "validators": [v.ssz_value() for v in lock.validators],
    })


def verify_lock(lock: Lock) -> None:
    """Structural + signature verification (reference: cluster/lock.go
    VerifyHashes + VerifySignatures).  The signature_aggregate is an
    aggregate BLS signature over the lock hash by every validator's group
    key (keycast/DKG output); absence is an error unless the definition
    has no validators."""
    d = lock.definition
    # The reference verifies the embedded definition's operator signatures
    # FIRST (cluster/lock.go:137-138 Lock.VerifySignatures → Definition.
    # VerifySignatures): a lock whose operator signatures were stripped or
    # forged must be rejected on the `run` path too, not only during dkg.
    verify_definition_signatures(d)
    if len(lock.validators) != d.num_validators:
        raise ValueError("validator count mismatch")
    for v in lock.validators:
        if len(v.public_shares) != d.num_operators:
            raise ValueError("pubshare count != operator count")
    if not lock.signature_aggregate:
        raise ValueError("missing lock signature aggregate")
    msg = lock_hash(lock)
    # aggregate-of-group-sigs: verify against each group key's aggregate.
    # The ceremony stores sig = aggregate of per-validator group sigs; here
    # each group signature over the lock hash is concatenated.
    sigs = [lock.signature_aggregate[i : i + 96]
            for i in range(0, len(lock.signature_aggregate), 96)]
    if len(sigs) != len(lock.validators):
        raise ValueError("signature aggregate length mismatch")
    for v, sig in zip(lock.validators, sigs):
        if not tbls.verify(v.public_key, msg, sig):
            raise ValueError("lock signature verification failed")


# ---------------------------------------------------------------------------
# Operator signatures (reference: cluster/eip712sigs.go — the reference
# signs config/ENR with EIP-712 typed data under the operator's wallet key;
# here each operator signs with their Ed25519 identity key, the same key
# pinned in the ENR record, so verification needs no extra key material)
# ---------------------------------------------------------------------------

_CONFIG_SIG_CTX = b"charon-tpu/config-signature/v1"
_ENR_SIG_CTX = b"charon-tpu/enr-signature/v1"


def sign_operator(d: Definition, op_index: int, identity) -> Definition:
    """Operator `op_index` signs the CONFIG hash (signature-free terms,
    identical for every signer) and their own ENR with their identity key;
    returns the updated Definition (reference: cluster/definition.go
    signing flow)."""
    op = d.operators[op_index]
    cfg_sig = identity.sign(_CONFIG_SIG_CTX + config_hash(d))
    enr_sig = identity.sign(_ENR_SIG_CTX + op.enr.encode())
    ops = list(d.operators)
    ops[op_index] = replace(op, config_signature=cfg_sig,
                            enr_signature=enr_sig)
    return replace(d, operators=tuple(ops))


def verify_definition_signatures(d: Definition) -> None:
    """Verify every operator's config + ENR signature against the Ed25519
    key in their own ENR record (reference: cluster/definition.go:158-248
    VerifySignatures).  Raises on any missing/invalid signature — absence
    is an error, never a silent skip."""
    from ..p2p import identity as ident

    h = config_hash(d)
    for i, op in enumerate(d.operators):
        pub, _, _ = ident.enr_parse(op.enr)
        if not op.config_signature or not op.enr_signature:
            raise ValueError(f"operator {i}: missing signatures")
        if not ident.verify(pub, op.config_signature, _CONFIG_SIG_CTX + h):
            raise ValueError(f"operator {i}: invalid config signature")
        if not ident.verify(pub, op.enr_signature,
                            _ENR_SIG_CTX + op.enr.encode()):
            raise ValueError(f"operator {i}: invalid ENR signature")


# ---------------------------------------------------------------------------
# JSON codecs (on-disk format)
# ---------------------------------------------------------------------------

def definition_to_json(d: Definition) -> dict:
    return {
        "name": d.name,
        "operators": [{"address": o.address, "enr": o.enr,
                       "config_signature": "0x" + o.config_signature.hex(),
                       "enr_signature": "0x" + o.enr_signature.hex()}
                      for o in d.operators],
        "threshold": d.threshold,
        "num_validators": d.num_validators,
        "fork_version": "0x" + d.fork_version.hex(),
        "dkg_algorithm": d.dkg_algorithm,
        "timestamp": d.timestamp,
        "version": d.version,
        "definition_hash": "0x" + definition_hash(d).hex(),
    }


def _hex_bytes(value: str, field_name: str, length: int | None = None) -> bytes:
    """Strict 0x-hex decoder: a missing prefix must be an error, not two
    silently dropped characters (round-3 advisor finding)."""
    if not isinstance(value, str) or not value.startswith("0x"):
        raise ValueError(f"{field_name}: expected 0x-prefixed hex")
    try:
        out = bytes.fromhex(value[2:])
    except ValueError:
        raise ValueError(f"{field_name}: invalid hex") from None
    if length is not None and out and len(out) != length:
        raise ValueError(f"{field_name}: expected {length} bytes, "
                         f"got {len(out)}")
    return out


def definition_from_json(obj: dict) -> Definition:
    d = Definition(
        name=obj["name"],
        operators=tuple(
            Operator(address=o["address"], enr=o.get("enr", ""),
                     config_signature=_hex_bytes(
                         o.get("config_signature", "0x"),
                         "config_signature", 64),
                     enr_signature=_hex_bytes(
                         o.get("enr_signature", "0x"),
                         "enr_signature", 64))
            for o in obj["operators"]),
        threshold=obj["threshold"],
        num_validators=obj["num_validators"],
        fork_version=_hex_bytes(obj["fork_version"], "fork_version", 4),
        dkg_algorithm=obj.get("dkg_algorithm", "default"),
        timestamp=obj.get("timestamp", ""),
        version=obj.get("version", VERSION),
    )
    want = obj.get("definition_hash")
    if want is not None and want != "0x" + definition_hash(d).hex():
        raise ValueError("definition hash mismatch")
    return d


def lock_to_json(lock: Lock) -> dict:
    return {
        "cluster_definition": definition_to_json(lock.definition),
        "distributed_validators": [
            {"distributed_public_key": "0x" + v.public_key.hex(),
             "public_shares": ["0x" + s.hex() for s in v.public_shares]}
            for v in lock.validators],
        "signature_aggregate": "0x" + lock.signature_aggregate.hex(),
        "lock_hash": "0x" + lock_hash(lock).hex(),
    }


def lock_from_json(obj: dict, verify: bool = True) -> Lock:
    lock = Lock(
        definition=definition_from_json(obj["cluster_definition"]),
        validators=tuple(
            DistValidator(
                public_key=_hex_bytes(v["distributed_public_key"],
                                      "distributed_public_key", 48),
                public_shares=tuple(
                    _hex_bytes(s, "public_share", 48)
                    for s in v["public_shares"]))
            for v in obj["distributed_validators"]),
        signature_aggregate=_hex_bytes(obj["signature_aggregate"],
                                       "signature_aggregate"),
    )
    want = obj.get("lock_hash")
    if want is not None and want != "0x" + lock_hash(lock).hex():
        raise ValueError("lock hash mismatch")
    if verify:
        verify_lock(lock)
    return lock


def save_json(path: str, obj: dict) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
