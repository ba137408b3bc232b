"""BeaconMock — in-process fake beacon node.

Mirrors reference testutil/beaconmock (beaconmock.go:16-120, options.go):
deterministic attester/proposer duties via hashing, configurable slot
duration/genesis, submission recording, and per-method override hooks —
every method can be replaced per-test, like the reference's Go-side
overridable funcs.

It implements the eth2 client interface consumed by scheduler, fetcher and
bcast (the reference's eth2wrap.Client analogue, here duck-typed).  A copy
of the JAX package's testutil/beaconmock.py.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass

from ..core.types import PubKey, pubkey_to_bytes
from ..eth2util import spec


@dataclass
class AttesterDutyInfo:
    pubkey: bytes
    validator_index: int
    slot: int
    committee_index: int
    committee_length: int
    committees_at_slot: int
    validator_committee_index: int


@dataclass
class ProposerDutyInfo:
    pubkey: bytes
    validator_index: int
    slot: int


@dataclass
class SyncDutyInfo:
    pubkey: bytes
    validator_index: int
    sync_committee_indices: list[int]


class BeaconMock:
    def __init__(self, validators: dict[PubKey, spec.Validator] | None = None,
                 slot_duration: float = 1.0, slots_per_epoch: int = 16,
                 genesis_time: float | None = None,
                 deterministic_duties: bool = True):
        self.validators: dict[PubKey, spec.Validator] = dict(validators or {})
        self.slot_duration = slot_duration
        self.slots_per_epoch = slots_per_epoch
        self.genesis = genesis_time if genesis_time is not None else time.time()
        self.deterministic = deterministic_duties
        self.fork_version = bytes.fromhex("00000000")  # simnet
        self.genesis_validators_root = bytes(32)
        # submission recorders (assertion points for tests)
        self.attestations: list[spec.Attestation] = []
        self.blocks: list[spec.SignedBeaconBlock] = []
        self.exits: list[spec.SignedVoluntaryExit] = []
        self.registrations: list[spec.SignedValidatorRegistration] = []
        self.aggregates: list[spec.SignedAggregateAndProof] = []
        self.sync_messages: list[spec.SyncCommitteeMessage] = []
        self.sync_contributions: list[spec.SignedContributionAndProof] = []
        # per-method overrides: {method_name: async fn}
        self.overrides: dict[str, object] = {}

    # -- helpers ------------------------------------------------------------

    def add_validator(self, pubkey: PubKey, index: int | None = None) -> None:
        idx = index if index is not None else len(self.validators)
        self.validators[pubkey] = spec.Validator(
            index=idx, pubkey=pubkey_to_bytes(pubkey))

    async def _maybe_override(self, name: str, *args):
        fn = self.overrides.get(name)
        if fn is None:
            return None
        return await fn(*args)

    # -- chain metadata -----------------------------------------------------

    async def spec(self) -> dict:
        return {
            "SECONDS_PER_SLOT": self.slot_duration,
            "SLOTS_PER_EPOCH": self.slots_per_epoch,
            "GENESIS_FORK_VERSION": self.fork_version,
        }

    async def genesis_time(self) -> float:
        return self.genesis

    async def node_syncing(self) -> dict:
        return {"is_syncing": False, "sync_distance": 0}

    async def active_validators(self, pubkeys) -> dict[PubKey, spec.Validator]:
        return {pk: v for pk, v in self.validators.items() if pk in pubkeys}

    # -- duties (deterministic from hash, reference: options.go:247-381) ----

    def _det_committee(self, slot: int, index: int) -> tuple[int, int]:
        h = hashlib.sha256(f"att/{slot}/{index}".encode()).digest()
        committees = 4
        return h[0] % committees, h[1] % 64  # (committee_index, position)

    async def attester_duties(self, epoch: int,
                              indices: list[int]) -> list[AttesterDutyInfo]:
        ov = await self._maybe_override("attester_duties", epoch, indices)
        if ov is not None:
            return ov
        out = []
        by_index = {v.index: v for v in self.validators.values()}
        for idx in indices:
            v = by_index.get(idx)
            if v is None:
                continue
            for slot_in_epoch in range(self.slots_per_epoch):
                slot = epoch * self.slots_per_epoch + slot_in_epoch
                # deterministic: validator idx attests at slot where
                # hash(idx, epoch) % slots_per_epoch == slot_in_epoch
                h = hashlib.sha256(f"duty/{epoch}/{idx}".encode()).digest()
                if h[0] % self.slots_per_epoch != slot_in_epoch:
                    continue
                comm_idx, pos = self._det_committee(slot, idx)
                out.append(AttesterDutyInfo(
                    pubkey=v.pubkey, validator_index=idx, slot=slot,
                    committee_index=comm_idx, committee_length=64,
                    committees_at_slot=4, validator_committee_index=pos))
        return out

    async def proposer_duties(self, epoch: int,
                              indices: list[int]) -> list[ProposerDutyInfo]:
        ov = await self._maybe_override("proposer_duties", epoch, indices)
        if ov is not None:
            return ov
        out = []
        by_index = {v.index: v for v in self.validators.values()}
        for slot_in_epoch in range(self.slots_per_epoch):
            slot = epoch * self.slots_per_epoch + slot_in_epoch
            h = hashlib.sha256(f"prop/{epoch}/{slot_in_epoch}".encode()).digest()
            if not indices:
                break
            idx = sorted(indices)[h[0] % len(indices)]
            v = by_index.get(idx)
            if v is not None:
                out.append(ProposerDutyInfo(pubkey=v.pubkey,
                                            validator_index=idx, slot=slot))
        return out

    async def sync_duties(self, epoch: int,
                          indices: list[int]) -> list[SyncDutyInfo]:
        """Every cluster validator sits in the sync committee (simnet
        convention; the reference beaconmock does the same via its
        deterministic-duties option, options.go:340-381)."""
        ov = await self._maybe_override("sync_duties", epoch, indices)
        if ov is not None:
            return ov
        out = []
        by_index = {v.index: v for v in self.validators.values()}
        for idx in sorted(indices):
            v = by_index.get(idx)
            if v is None:
                continue
            out.append(SyncDutyInfo(
                pubkey=v.pubkey, validator_index=idx,
                sync_committee_indices=[idx % 512]))
        return out

    # -- duty data ----------------------------------------------------------

    async def attestation_data(self, slot: int,
                               committee_index: int) -> spec.AttestationData:
        ov = await self._maybe_override("attestation_data", slot,
                                        committee_index)
        if ov is not None:
            return ov
        epoch = slot // self.slots_per_epoch
        root = hashlib.sha256(f"block/{slot}".encode()).digest()
        return spec.AttestationData(
            slot=slot, index=committee_index, beacon_block_root=root,
            source=spec.Checkpoint(epoch=max(0, epoch - 1), root=bytes(32)),
            target=spec.Checkpoint(epoch=epoch, root=root))

    async def beacon_block_proposal(self, slot: int, randao_reveal: bytes,
                                    graffiti: bytes = b"",
                                    blinded: bool = False) -> spec.BeaconBlock:
        ov = await self._maybe_override("beacon_block_proposal", slot,
                                        randao_reveal)
        if ov is not None:
            return ov
        duties = await self.proposer_duties(
            slot // self.slots_per_epoch,
            [v.index for v in self.validators.values()])
        proposer = next((d.validator_index for d in duties if d.slot == slot),
                        0)
        body_root = hashlib.sha256(b"body/" + randao_reveal).digest()
        return spec.BeaconBlock(
            slot=slot, proposer_index=proposer,
            parent_root=hashlib.sha256(f"block/{slot-1}".encode()).digest(),
            state_root=hashlib.sha256(f"state/{slot}".encode()).digest(),
            body_root=body_root, body=randao_reveal, blinded=blinded)

    async def beacon_block_root(self, slot: int) -> bytes:
        return hashlib.sha256(f"block/{slot}".encode()).digest()

    async def aggregate_attestation(self, slot: int,
                                    att_data_root: bytes) -> spec.Attestation:
        data = await self.attestation_data(slot, 0)
        # find data matching the root across committees
        for comm in range(4):
            d = await self.attestation_data(slot, comm)
            if d.hash_tree_root() == att_data_root:
                data = d
                break
        from ..eth2util.ssz import Bitlist
        bits = Bitlist.from_bools([True] * 64)
        return spec.Attestation(aggregation_bits=bits, data=data)

    async def is_attestation_aggregator(self, slot: int, committee_length: int,
                                        selection_proof: bytes) -> bool:
        # spec rule: hash(sig)[0] % max(1, len//TARGET) == 0; simnet: always
        return True

    async def is_sync_comm_aggregator(self, selection_proof: bytes) -> bool:
        return True

    async def sync_committee_contribution(
            self, slot: int, subcommittee_index: int,
            beacon_block_root: bytes) -> spec.SyncCommitteeContribution:
        from ..eth2util.ssz import Bitlist
        return spec.SyncCommitteeContribution(
            slot=slot, beacon_block_root=beacon_block_root,
            subcommittee_index=subcommittee_index,
            aggregation_bits=Bitlist.from_bools([True] * 128))

    # -- submissions --------------------------------------------------------

    async def submit_attestations(self, atts) -> None:
        self.attestations.extend(atts)

    async def submit_beacon_block(self, block) -> None:
        self.blocks.append(block)

    async def submit_voluntary_exit(self, exit_) -> None:
        self.exits.append(exit_)

    async def submit_validator_registrations(self, regs) -> None:
        self.registrations.extend(regs)

    async def submit_aggregate_attestations(self, aggs) -> None:
        self.aggregates.extend(aggs)

    async def submit_sync_committee_messages(self, msgs) -> None:
        self.sync_messages.extend(msgs)

    async def submit_sync_committee_contributions(self, contribs) -> None:
        self.sync_contributions.extend(contribs)
