"""Fetcher — stateless fetch of unsigned duty data per duty type.

Mirrors reference core/fetcher/fetcher.go:59-324:
- attestation data deduped by committee (one BN query per committee, shared
  across validators — fetcher.go:126-180),
- aggregator path queries AggSigDB for the stored selection proof, checks
  aggregator eligibility, fetches the aggregate by attestation-data root
  (fetcher.go:183-238),
- proposer path BLOCKS on the aggregated RANDAO from AggSigDB, then fetches
  the block (fetcher.go:240-324),
- sync-contribution path mirrors the aggregator flow (fetcher.go:326+).

A copy of the JAX package's core/fetcher.py.
"""

from __future__ import annotations

from .types import (AggregatedAttestationUD, AttestationDataUD,
                    AttesterDefinition, Duty, DutyDefinitionSet, DutyType,
                    ProposerDefinition, SyncContributionUD, UnsignedDataSet,
                    VersionedBeaconBlockUD, new_randao_duty)


class Fetcher:
    def __init__(self, eth2cl):
        self._eth2cl = eth2cl
        self._subs: list = []
        self._aggsigdb_fn = None
        self._await_att_fn = None

    def subscribe(self, fn) -> None:
        self._subs.append(fn)

    def register_agg_sig_db(self, fn) -> None:
        self._aggsigdb_fn = fn

    def register_await_att_data(self, fn) -> None:
        self._await_att_fn = fn

    async def fetch(self, duty: Duty, defset: DutyDefinitionSet) -> None:
        if duty.type == DutyType.ATTESTER:
            unsigned = await self._fetch_attester(duty, defset)
        elif duty.type == DutyType.AGGREGATOR:
            unsigned = await self._fetch_aggregator(duty, defset)
        elif duty.type in (DutyType.PROPOSER, DutyType.BUILDER_PROPOSER):
            unsigned = await self._fetch_proposer(duty, defset)
        elif duty.type == DutyType.SYNC_CONTRIBUTION:
            unsigned = await self._fetch_sync_contribution(duty, defset)
        else:
            raise ValueError(f"unsupported duty type {duty.type}")
        if not unsigned:
            return
        for fn in self._subs:
            await fn(duty, unsigned)

    async def _fetch_attester(self, duty: Duty,
                              defset: DutyDefinitionSet) -> UnsignedDataSet:
        """One AttestationData query per committee, fanned out to all
        validators in that committee (reference: fetcher.go:126-180)."""
        by_committee: dict[int, object] = {}
        unsigned: UnsignedDataSet = {}
        for pubkey, d in defset.items():
            assert isinstance(d, AttesterDefinition)
            data = by_committee.get(d.committee_index)
            if data is None:
                data = await self._eth2cl.attestation_data(
                    duty.slot, d.committee_index)
                by_committee[d.committee_index] = data
            unsigned[pubkey] = AttestationDataUD(data=data, duty=d)
        return unsigned

    async def _fetch_aggregator(self, duty: Duty,
                                defset: DutyDefinitionSet) -> UnsignedDataSet:
        """reference: fetcher.go:183-238 fetchAggregatorData."""
        unsigned: UnsignedDataSet = {}
        for pubkey, d in defset.items():
            # The aggregated selection proof was stored by the
            # PREPARE_AGGREGATOR pre-duty.
            prep_duty = Duty(duty.slot, DutyType.PREPARE_AGGREGATOR)
            selection = await self._aggsigdb_fn(prep_duty, pubkey)
            assert isinstance(d, AttesterDefinition)
            is_agg = await self._eth2cl.is_attestation_aggregator(
                duty.slot, d.committee_length, selection.signature)
            if not is_agg:
                continue
            att_data = await self._await_att_fn(duty.slot, d.committee_index)
            agg_att = await self._eth2cl.aggregate_attestation(
                duty.slot, att_data.hash_tree_root())
            unsigned[pubkey] = AggregatedAttestationUD(attestation=agg_att)
        return unsigned

    async def _fetch_proposer(self, duty: Duty,
                              defset: DutyDefinitionSet) -> UnsignedDataSet:
        """Blocks until the aggregated RANDAO lands in AggSigDB, then fetches
        the block proposal (reference: fetcher.go:240-324)."""
        unsigned: UnsignedDataSet = {}
        blinded = duty.type == DutyType.BUILDER_PROPOSER
        for pubkey, d in defset.items():
            assert isinstance(d, ProposerDefinition)
            randao = await self._aggsigdb_fn(new_randao_duty(duty.slot),
                                             pubkey)
            block = await self._eth2cl.beacon_block_proposal(
                duty.slot, randao.signature, blinded=blinded)
            unsigned[pubkey] = VersionedBeaconBlockUD(block=block)
        return unsigned

    async def _fetch_sync_contribution(
            self, duty: Duty, defset: DutyDefinitionSet) -> UnsignedDataSet:
        unsigned: UnsignedDataSet = {}
        for pubkey, d in defset.items():
            prep = Duty(duty.slot, DutyType.PREPARE_SYNC_CONTRIBUTION)
            selection = await self._aggsigdb_fn(prep, pubkey)
            sel = selection.selection  # SignedSyncCommitteeSelection-like
            is_agg = await self._eth2cl.is_sync_comm_aggregator(
                sel.selection_proof)
            if not is_agg:
                continue
            block_root = await self._eth2cl.beacon_block_root(duty.slot)
            contrib = await self._eth2cl.sync_committee_contribution(
                duty.slot, sel.subcommittee_index, block_root)
            unsigned[pubkey] = SyncContributionUD(contribution=contrib)
        return unsigned
