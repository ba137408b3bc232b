"""DutyDB — in-memory store of consensus-agreed unsigned data with blocking
query resolution and slashing-safe unique indexes.

Mirrors reference core/dutydb/memory.go:
- `await_*` queries return futures resolved the moment a matching `store`
  lands (reference: memory.go:174-237, 528-610).
- unique-index semantics: storing two DIFFERENT values under the same key
  errors — the DB doubles as the slashing database (memory.go:321-363).
- reverse index pubkey_by_attestation (memory.go:302-319).
- per-duty GC driven by a Deadliner (memory.go:152-168).

A copy of the JAX package's core/dutydb.py.
"""

from __future__ import annotations

import asyncio
from collections import defaultdict

from .types import (AttestationDataUD, AggregatedAttestationUD, Duty,
                    DutyType, PubKey, SyncContributionUD, UnsignedDataSet,
                    VersionedBeaconBlockUD)


class DutyDBError(Exception):
    pass


class MemDutyDB:
    def __init__(self) -> None:
        # unique indexes
        self._att_by_key: dict[tuple[int, int], AttestationDataUD] = {}
        self._pubkey_by_att: dict[tuple[int, int, int], PubKey] = {}
        self._block_by_slot: dict[int, VersionedBeaconBlockUD] = {}
        self._agg_att: dict[tuple[int, bytes], AggregatedAttestationUD] = {}
        self._contrib: dict[tuple[int, int, bytes], SyncContributionUD] = {}
        self._duty_keys: dict[Duty, list] = defaultdict(list)
        # blocking queries: key -> list of futures
        self._att_waiters: dict[tuple[int, int], list[asyncio.Future]] = defaultdict(list)
        self._block_waiters: dict[int, list[asyncio.Future]] = defaultdict(list)
        self._agg_waiters: dict[tuple[int, bytes], list[asyncio.Future]] = defaultdict(list)
        self._contrib_waiters: dict[tuple[int, int, bytes], list[asyncio.Future]] = defaultdict(list)

    # -- store --------------------------------------------------------------

    async def store(self, duty: Duty, unsigned: UnsignedDataSet) -> None:
        if duty.type == DutyType.INFO_SYNC:
            return  # priority-protocol decisions carry no duty data
        if duty.type == DutyType.ATTESTER:
            for pubkey, ud in unsigned.items():
                self._store_attestation(duty, pubkey, ud)
        elif duty.type in (DutyType.PROPOSER, DutyType.BUILDER_PROPOSER):
            for pubkey, ud in unsigned.items():
                self._store_block(duty, ud)
        elif duty.type == DutyType.AGGREGATOR:
            for pubkey, ud in unsigned.items():
                self._store_agg_attestation(duty, ud)
        elif duty.type == DutyType.SYNC_CONTRIBUTION:
            for pubkey, ud in unsigned.items():
                self._store_contribution(duty, ud)
        else:
            raise DutyDBError(f"unsupported duty type {duty.type}")

    def _store_attestation(self, duty: Duty, pubkey: PubKey,
                           ud: AttestationDataUD) -> None:
        key = (ud.data.slot, ud.data.index)
        existing = self._att_by_key.get(key)
        if existing is not None:
            if existing.data.hash_tree_root() != ud.data.hash_tree_root():
                raise DutyDBError(
                    "attestation data clash for same slot/committee "
                    "(slashing protection)")
        else:
            self._att_by_key[key] = ud
            self._duty_keys[duty].append(("att", key))
        rev_key = (ud.data.slot, ud.duty.committee_index,
                   ud.duty.validator_committee_index)
        prev = self._pubkey_by_att.get(rev_key)
        if prev is not None and prev != pubkey:
            raise DutyDBError("pubkey clash for attestation reverse index")
        self._pubkey_by_att[rev_key] = pubkey
        self._duty_keys[duty].append(("rev", rev_key))
        for fut in self._att_waiters.pop(key, []):
            if not fut.done():
                fut.set_result(ud.data)

    def _store_block(self, duty: Duty, ud: VersionedBeaconBlockUD) -> None:
        slot = ud.block.slot
        existing = self._block_by_slot.get(slot)
        if existing is not None:
            if existing.hash_tree_root() != ud.hash_tree_root():
                raise DutyDBError(
                    "block clash for same slot (slashing protection)")
            return
        self._block_by_slot[slot] = ud
        self._duty_keys[duty].append(("block", slot))
        for fut in self._block_waiters.pop(slot, []):
            if not fut.done():
                fut.set_result(ud.block)

    def _store_agg_attestation(self, duty: Duty,
                               ud: AggregatedAttestationUD) -> None:
        data_root = ud.attestation.data.hash_tree_root()
        key = (ud.attestation.data.slot, data_root)
        existing = self._agg_att.get(key)
        if existing is not None:
            if existing.hash_tree_root() != ud.hash_tree_root():
                raise DutyDBError("aggregate attestation clash")
            return
        self._agg_att[key] = ud
        self._duty_keys[duty].append(("agg", key))
        for fut in self._agg_waiters.pop(key, []):
            if not fut.done():
                fut.set_result(ud.attestation)

    def _store_contribution(self, duty: Duty, ud: SyncContributionUD) -> None:
        c = ud.contribution
        key = (c.slot, c.subcommittee_index, c.beacon_block_root)
        existing = self._contrib.get(key)
        if existing is not None:
            if existing.hash_tree_root() != ud.hash_tree_root():
                raise DutyDBError("sync contribution clash")
            return
        self._contrib[key] = ud
        self._duty_keys[duty].append(("contrib", key))
        for fut in self._contrib_waiters.pop(key, []):
            if not fut.done():
                fut.set_result(c)

    # -- blocking queries ---------------------------------------------------

    async def await_attestation(self, slot: int, committee_idx: int):
        key = (slot, committee_idx)
        ud = self._att_by_key.get(key)
        if ud is not None:
            return ud.data
        fut = asyncio.get_running_loop().create_future()
        self._att_waiters[key].append(fut)
        return await fut

    async def await_beacon_block(self, slot: int):
        ud = self._block_by_slot.get(slot)
        if ud is not None:
            return ud.block
        fut = asyncio.get_running_loop().create_future()
        self._block_waiters[slot].append(fut)
        return await fut

    async def await_agg_attestation(self, slot: int, att_data_root: bytes):
        key = (slot, att_data_root)
        ud = self._agg_att.get(key)
        if ud is not None:
            return ud.attestation
        fut = asyncio.get_running_loop().create_future()
        self._agg_waiters[key].append(fut)
        return await fut

    async def await_sync_contribution(self, slot: int, subcomm_idx: int,
                                      block_root: bytes):
        key = (slot, subcomm_idx, block_root)
        ud = self._contrib.get(key)
        if ud is not None:
            return ud.contribution
        fut = asyncio.get_running_loop().create_future()
        self._contrib_waiters[key].append(fut)
        return await fut

    async def pubkey_by_attestation(self, slot: int, committee_idx: int,
                                    val_comm_idx: int) -> PubKey:
        key = (slot, committee_idx, val_comm_idx)
        pk = self._pubkey_by_att.get(key)
        if pk is None:
            raise DutyDBError(f"no pubkey for attestation {key}")
        return pk

    # -- GC -----------------------------------------------------------------

    def trim(self, duty: Duty) -> None:
        """Drop all state for an expired duty (reference: memory.go:152-168)."""
        for kind, key in self._duty_keys.pop(duty, []):
            if kind == "att":
                self._att_by_key.pop(key, None)
            elif kind == "rev":
                self._pubkey_by_att.pop(key, None)
            elif kind == "block":
                self._block_by_slot.pop(key, None)
            elif kind == "agg":
                self._agg_att.pop(key, None)
            elif kind == "contrib":
                self._contrib.pop(key, None)
