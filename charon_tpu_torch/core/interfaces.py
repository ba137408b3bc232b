"""Component protocols + wire() — the immutable event-flow wiring.

Mirrors reference core/interfaces.go:27-295: components never hold
references to each other; they expose Subscribe/Register hooks and `wire()`
stitches callbacks once at startup.  Wire options wrap the edges (tracing,
async-retry) exactly like the reference's WithTracing/WithAsyncRetry
(reference: core/tracing.go:64-142, core/retry.go:24-57).

All callbacks are `async def` and run on the node's event loop; long-running
edges (fetch → consensus → …) are spawned as tasks by the retry option so a
slow duty never blocks the scheduler tick (reference spawns goroutines,
core/retry.go:28-55).

A copy of the JAX package's core/interfaces.py: the same Protocols and the
same edge table.
"""

from __future__ import annotations

from typing import Any, Awaitable, Callable, Protocol

from .types import (Duty, DutyDefinitionSet, ParSignedData, ParSignedDataSet,
                    PubKey, SignedData, UnsignedDataSet)

AsyncFn = Callable[..., Awaitable[Any]]


class Scheduler(Protocol):
    def subscribe_duties(self, fn: AsyncFn) -> None: ...
    def subscribe_slots(self, fn: AsyncFn) -> None: ...
    async def get_duty_definition(self, duty: Duty) -> DutyDefinitionSet: ...


class Fetcher(Protocol):
    async def fetch(self, duty: Duty, defset: DutyDefinitionSet) -> None: ...
    def subscribe(self, fn: AsyncFn) -> None: ...
    def register_agg_sig_db(self, fn: AsyncFn) -> None: ...
    def register_await_att_data(self, fn: AsyncFn) -> None: ...


class Consensus(Protocol):
    async def propose(self, duty: Duty, unsigned: UnsignedDataSet) -> None: ...
    def subscribe(self, fn: AsyncFn) -> None: ...


class DutyDB(Protocol):
    async def store(self, duty: Duty, unsigned: UnsignedDataSet) -> None: ...
    async def await_attestation(self, slot: int, commitee_idx: int): ...
    async def await_beacon_block(self, slot: int): ...
    async def await_agg_attestation(self, slot: int, att_root: bytes): ...
    async def await_sync_contribution(self, slot: int, subcomm_idx: int,
                                      block_root: bytes): ...
    async def pubkey_by_attestation(self, slot: int, commitee_idx: int,
                                    val_comm_idx: int) -> PubKey: ...


class ValidatorAPI(Protocol):
    def register_await_attestation(self, fn: AsyncFn) -> None: ...
    def register_await_beacon_block(self, fn: AsyncFn) -> None: ...
    def register_await_sync_contribution(self, fn: AsyncFn) -> None: ...
    def register_await_agg_attestation(self, fn: AsyncFn) -> None: ...
    def register_get_duty_definition(self, fn: AsyncFn) -> None: ...
    def register_pubkey_by_attestation(self, fn: AsyncFn) -> None: ...
    def register_await_agg_sig_db(self, fn: AsyncFn) -> None: ...
    def subscribe(self, fn: AsyncFn) -> None: ...


class ParSigDB(Protocol):
    async def store_internal(self, duty: Duty,
                             pset: ParSignedDataSet) -> None: ...
    async def store_external(self, duty: Duty,
                             pset: ParSignedDataSet) -> None: ...
    def subscribe_internal(self, fn: AsyncFn) -> None: ...
    def subscribe_threshold(self, fn: AsyncFn) -> None: ...


class ParSigEx(Protocol):
    async def broadcast(self, duty: Duty, pset: ParSignedDataSet) -> None: ...
    def subscribe(self, fn: AsyncFn) -> None: ...


class SigAgg(Protocol):
    async def aggregate(self, duty: Duty, pubkey: PubKey,
                        parsigs: list[ParSignedData]) -> None: ...
    def subscribe(self, fn: AsyncFn) -> None: ...


class AggSigDB(Protocol):
    async def store(self, duty: Duty, pubkey: PubKey,
                    data: SignedData) -> None: ...
    async def await_(self, duty: Duty, pubkey: PubKey) -> SignedData: ...


class Broadcaster(Protocol):
    async def broadcast(self, duty: Duty, pubkey: PubKey,
                        data: SignedData) -> None: ...


WireOption = Callable[[dict], None]


def wire(sched, fetch, cons, dutydb, vapi, parsigdb, parsigex, sigagg,
         aggsigdb, bcast, *options: WireOption) -> None:
    """Stitch the core workflow (reference: core/interfaces.go:221-295).

    The edge table below is the exact reference wiring; options may wrap any
    edge before it is connected.
    """
    w = {
        "scheduler_subscribe_duties": sched.subscribe_duties,
        "scheduler_get_duty_definition": sched.get_duty_definition,
        "fetcher_fetch": fetch.fetch,
        "fetcher_subscribe": fetch.subscribe,
        "fetcher_register_agg_sig_db": fetch.register_agg_sig_db,
        "fetcher_register_await_att_data": fetch.register_await_att_data,
        "consensus_propose": cons.propose,
        "consensus_subscribe": cons.subscribe,
        "dutydb_store": dutydb.store,
        "dutydb_await_attestation": dutydb.await_attestation,
        "dutydb_await_beacon_block": dutydb.await_beacon_block,
        "dutydb_await_agg_attestation": dutydb.await_agg_attestation,
        "dutydb_await_sync_contribution": dutydb.await_sync_contribution,
        "dutydb_pubkey_by_attestation": dutydb.pubkey_by_attestation,
        "vapi_register_await_attestation": vapi.register_await_attestation,
        "vapi_register_await_beacon_block": vapi.register_await_beacon_block,
        "vapi_register_await_sync_contribution":
            vapi.register_await_sync_contribution,
        "vapi_register_await_agg_attestation":
            vapi.register_await_agg_attestation,
        "vapi_register_get_duty_definition": vapi.register_get_duty_definition,
        "vapi_register_pubkey_by_attestation":
            vapi.register_pubkey_by_attestation,
        "vapi_register_await_agg_sig_db": vapi.register_await_agg_sig_db,
        "vapi_subscribe": vapi.subscribe,
        "parsigdb_store_internal": parsigdb.store_internal,
        "parsigdb_store_external": parsigdb.store_external,
        "parsigdb_subscribe_internal": parsigdb.subscribe_internal,
        "parsigdb_subscribe_threshold": parsigdb.subscribe_threshold,
        "parsigex_broadcast": parsigex.broadcast,
        "parsigex_subscribe": parsigex.subscribe,
        "sigagg_aggregate": sigagg.aggregate,
        "sigagg_subscribe": sigagg.subscribe,
        "aggsigdb_store": aggsigdb.store,
        "aggsigdb_await": aggsigdb.await_,
        "broadcaster_broadcast": bcast.broadcast,
    }
    for opt in options:
        opt(w)

    w["scheduler_subscribe_duties"](w["fetcher_fetch"])
    w["fetcher_subscribe"](w["consensus_propose"])
    w["fetcher_register_agg_sig_db"](w["aggsigdb_await"])
    w["fetcher_register_await_att_data"](w["dutydb_await_attestation"])
    w["consensus_subscribe"](w["dutydb_store"])
    w["vapi_register_await_attestation"](w["dutydb_await_attestation"])
    w["vapi_register_await_beacon_block"](w["dutydb_await_beacon_block"])
    w["vapi_register_await_sync_contribution"](
        w["dutydb_await_sync_contribution"])
    w["vapi_register_await_agg_attestation"](w["dutydb_await_agg_attestation"])
    w["vapi_register_get_duty_definition"](w["scheduler_get_duty_definition"])
    w["vapi_register_pubkey_by_attestation"](w["dutydb_pubkey_by_attestation"])
    w["vapi_register_await_agg_sig_db"](w["aggsigdb_await"])
    w["vapi_subscribe"](w["parsigdb_store_internal"])
    w["parsigdb_subscribe_internal"](w["parsigex_broadcast"])
    w["parsigex_subscribe"](w["parsigdb_store_external"])
    w["parsigdb_subscribe_threshold"](w["sigagg_aggregate"])
    w["sigagg_subscribe"](w["aggsigdb_store"])
    w["sigagg_subscribe"](w["broadcaster_broadcast"])
