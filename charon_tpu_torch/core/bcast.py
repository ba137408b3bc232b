"""Broadcaster — submits aggregate SignedData to the beacon node.

Mirrors reference core/bcast/bcast.go:55-194 (type switch over duty types)
plus the broadcast delays (bcast.go:196+) and the epoch Recaster for
builder registrations (recast.go:33-114).

A copy of the JAX package's core/bcast.py, trimmed of the metrics
registry (the delay histogram and broadcast counter come with the
telemetry slice); `broadcast_delays` keeps every delay.
"""

from __future__ import annotations

import time

from .types import Duty, DutyType, PubKey, SignedData, SlotTick


class Broadcaster:
    def __init__(self, eth2cl, genesis_time: float, slot_duration: float,
                 clock=time.time):
        self._eth2cl = eth2cl
        self._genesis = genesis_time
        self._slot_duration = slot_duration
        self._clock = clock
        self.broadcast_delays: list[tuple[Duty, float]] = []  # metric feed
        self._subs: list = []

    def subscribe(self, fn) -> None:
        """fn(duty, pubkey, data) after a successful beacon-node submit —
        the slot-budget accountant's bcast hand-off timestamp (internal
        duty types are never broadcast and never notify)."""
        self._subs.append(fn)

    async def broadcast(self, duty: Duty, pubkey: PubKey,
                        data: SignedData) -> None:
        t = duty.type
        if t == DutyType.ATTESTER:
            await self._eth2cl.submit_attestations([data.attestation])
        elif t in (DutyType.PROPOSER, DutyType.BUILDER_PROPOSER):
            await self._eth2cl.submit_beacon_block(data.block)
        elif t == DutyType.EXIT:
            await self._eth2cl.submit_voluntary_exit(data.exit)
        elif t == DutyType.BUILDER_REGISTRATION:
            await self._eth2cl.submit_validator_registrations(
                [data.registration])
        elif t == DutyType.AGGREGATOR:
            await self._eth2cl.submit_aggregate_attestations([data.agg])
        elif t == DutyType.SYNC_MESSAGE:
            await self._eth2cl.submit_sync_committee_messages([data.message])
        elif t == DutyType.SYNC_CONTRIBUTION:
            await self._eth2cl.submit_sync_committee_contributions(
                [data.contribution])
        elif t in (DutyType.RANDAO, DutyType.PREPARE_AGGREGATOR,
                   DutyType.PREPARE_SYNC_CONTRIBUTION, DutyType.INFO_SYNC,
                   DutyType.SIGNATURE):
            # Internal-only duties are never broadcast
            # (reference: bcast.go ignores these types).
            return
        else:
            raise ValueError(f"unsupported duty type {t}")
        delay = self._clock() - (self._genesis
                                 + duty.slot * self._slot_duration)
        self.broadcast_delays.append((duty, delay))
        for fn in self._subs:
            await fn(duty, pubkey, data)


class Recaster:
    """Rebroadcasts builder registrations every epoch
    (reference: core/bcast/recast.go:33-114)."""

    def __init__(self) -> None:
        self._tuples: dict[PubKey, tuple[Duty, SignedData]] = {}
        self._subs: list = []

    def subscribe(self, fn) -> None:
        self._subs.append(fn)

    async def store(self, duty: Duty, pubkey: PubKey,
                    data: SignedData) -> None:
        """SigAgg subscriber: remember registrations for rebroadcast."""
        if duty.type == DutyType.BUILDER_REGISTRATION:
            self._tuples[pubkey] = (duty, data)

    async def slot_ticked(self, slot: SlotTick) -> None:
        if not slot.first_in_epoch:
            return
        for pubkey, (duty, data) in list(self._tuples.items()):
            for fn in self._subs:
                await fn(duty, pubkey, data)
