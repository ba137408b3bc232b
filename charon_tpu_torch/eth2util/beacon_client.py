"""Beacon-node HTTP client — the eth2wrap equivalent.

One class speaks beacon-API HTTP to a single node (`BeaconClient`); the
`MultiBeaconClient` fans every call out to all configured nodes and returns
the first success, recording per-node error/latency counters — mirroring
the reference's generated multi-client (app/eth2wrap/eth2wrap.go:70-90
NewMultiHTTP, :161-218 provide/submit fan-out).

The surface matches the in-process BeaconMock duck-type exactly, so
scheduler/fetcher/bcast run unchanged against either (the reference
pattern: beaconmock implements eth2wrap.Client).

Aggregator eligibility (`is_attestation_aggregator`,
`is_sync_comm_aggregator`) is computed locally from the spec rules —
it is a pure function of the selection proof, not a beacon-API call
(consensus-spec `is_aggregator`; reference computes it in
core/validatorapi via eth2exp).

A copy of the JAX package's eth2util/beacon_client.py over the port's
HTTP/1.1 client (`app/http1.py`) in place of aiohttp: the same methods,
results and `BeaconApiError` statuses against either package's mock.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import time

from . import beaconapi as api
from . import spec as spec_mod
from ..app.http1 import HTTPClient
from ..core.types import PubKey, pubkey_to_bytes

TARGET_AGGREGATORS_PER_COMMITTEE = 16
TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE = 16
SYNC_COMMITTEE_SUBNET_COUNT = 4


class BeaconApiError(Exception):
    def __init__(self, status: int, body: str, url: str):
        super().__init__(f"beacon api {status} at {url}: {body[:200]}")
        self.status = status


def is_attestation_aggregator_local(committee_length: int,
                                    selection_proof: bytes) -> bool:
    """consensus-spec is_aggregator: hash(sig)[0:8] mod max(1, n/16) == 0."""
    modulo = max(1, committee_length // TARGET_AGGREGATORS_PER_COMMITTEE)
    digest = hashlib.sha256(selection_proof).digest()
    return int.from_bytes(digest[:8], "little") % modulo == 0


def is_sync_comm_aggregator_local(selection_proof: bytes) -> bool:
    """consensus-spec is_sync_committee_aggregator (altair)."""
    modulo = max(1, 512 // SYNC_COMMITTEE_SUBNET_COUNT
                 // TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE)
    digest = hashlib.sha256(selection_proof).digest()
    return int.from_bytes(digest[:8], "little") % modulo == 0


class BeaconClient:
    """Typed beacon-API HTTP client for one node."""

    def __init__(self, base_url: str, timeout: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self._timeout = timeout
        self._session: HTTPClient | None = None
        self._spec_cache: dict | None = None
        self._genesis_cache: dict | None = None

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None

    def _sess(self) -> HTTPClient:
        if self._session is None:
            self._session = HTTPClient(timeout=self._timeout)
        return self._session

    async def _get(self, path: str, params: dict | None = None) -> dict:
        url = self.base_url + path
        resp = await self._sess().get(url, params=params)
        if resp.status != 200:
            raise BeaconApiError(resp.status, resp.text(), url)
        return resp.json()

    async def _post(self, path: str, payload) -> dict:
        url = self.base_url + path
        resp = await self._sess().post(url, json_body=payload)
        if resp.status not in (200, 202):
            raise BeaconApiError(resp.status, resp.text(), url)
        text = resp.text()
        return {} if not text else json.loads(text)

    # -- chain metadata -----------------------------------------------------

    async def spec(self) -> dict:
        if self._spec_cache is None:
            d = (await self._get("/eth/v1/config/spec"))["data"]
            self._spec_cache = {
                "SECONDS_PER_SLOT": float(d["SECONDS_PER_SLOT"]),
                "SLOTS_PER_EPOCH": int(d["SLOTS_PER_EPOCH"]),
                "GENESIS_FORK_VERSION":
                    api.to_bytes(d["GENESIS_FORK_VERSION"], 4),
            }
        return dict(self._spec_cache)

    async def _genesis(self) -> dict:
        if self._genesis_cache is None:
            self._genesis_cache = (
                await self._get("/eth/v1/beacon/genesis"))["data"]
        return self._genesis_cache

    async def genesis_time(self) -> float:
        return float((await self._genesis())["genesis_time"])

    async def genesis_validators_root(self) -> bytes:
        return api.to_bytes((await self._genesis())["genesis_validators_root"],
                            32)

    async def node_syncing(self) -> dict:
        d = (await self._get("/eth/v1/node/syncing"))["data"]
        return {"is_syncing": bool(d["is_syncing"]),
                "sync_distance": int(d["sync_distance"])}

    async def active_validators(
            self, pubkeys) -> dict[PubKey, spec_mod.Validator]:
        ids = [api.hex_of(pubkey_to_bytes(pk)) for pk in pubkeys]
        d = await self._post("/eth/v1/beacon/states/head/validators",
                             {"ids": ids})
        out: dict[PubKey, spec_mod.Validator] = {}
        by_hex = {api.hex_of(pubkey_to_bytes(pk)): pk for pk in pubkeys}
        for v in d["data"]:
            pk = by_hex.get(v["validator"]["pubkey"])
            if pk is not None and v.get(
                    "status", "active_ongoing").startswith("active"):
                out[pk] = api.validator_from(v)
        return out

    # -- duties -------------------------------------------------------------

    async def attester_duties(self, epoch: int, indices: list[int]):
        d = await self._post(f"/eth/v1/validator/duties/attester/{epoch}",
                             [str(i) for i in indices])
        return [api.attester_duty_from(x) for x in d["data"]]

    async def proposer_duties(self, epoch: int, indices: list[int]):
        d = await self._get(f"/eth/v1/validator/duties/proposer/{epoch}")
        want = set(indices)
        return [api.proposer_duty_from(x) for x in d["data"]
                if int(x["validator_index"]) in want]

    async def sync_duties(self, epoch: int, indices: list[int]):
        d = await self._post(f"/eth/v1/validator/duties/sync/{epoch}",
                             [str(i) for i in indices])
        return [api.sync_duty_from(x) for x in d["data"]]

    # -- duty data ----------------------------------------------------------

    async def attestation_data(self, slot: int, committee_index: int):
        d = await self._get("/eth/v1/validator/attestation_data",
                            {"slot": str(slot),
                             "committee_index": str(committee_index)})
        return api.att_data_from(d["data"])

    async def beacon_block_proposal(self, slot: int, randao_reveal: bytes,
                                    graffiti: bytes = b"",
                                    blinded: bool = False):
        if blinded:
            d = await self._get(f"/eth/v1/validator/blinded_blocks/{slot}",
                                {"randao_reveal": api.hex_of(randao_reveal)})
        else:
            params = {"randao_reveal": api.hex_of(randao_reveal)}
            if graffiti:
                params["graffiti"] = api.hex_of(graffiti)
            d = await self._get(f"/eth/v2/validator/blocks/{slot}", params)
        return api.block_from(d["data"])

    async def beacon_block_root(self, slot: int) -> bytes:
        d = await self._get(f"/eth/v1/beacon/blocks/{slot}/root")
        return api.to_bytes(d["data"]["root"], 32)

    async def aggregate_attestation(self, slot: int, att_data_root: bytes):
        d = await self._get("/eth/v1/validator/aggregate_attestation",
                            {"slot": str(slot),
                             "attestation_data_root":
                                 api.hex_of(att_data_root)})
        return api.attestation_from(d["data"])

    async def is_attestation_aggregator(self, slot: int, committee_length: int,
                                        selection_proof: bytes) -> bool:
        return is_attestation_aggregator_local(committee_length,
                                               selection_proof)

    async def is_sync_comm_aggregator(self, selection_proof: bytes) -> bool:
        return is_sync_comm_aggregator_local(selection_proof)

    async def sync_committee_contribution(self, slot: int,
                                          subcommittee_index: int,
                                          beacon_block_root: bytes):
        d = await self._get("/eth/v1/validator/sync_committee_contribution",
                            {"slot": str(slot),
                             "subcommittee_index": str(subcommittee_index),
                             "beacon_block_root":
                                 api.hex_of(beacon_block_root)})
        return api.sync_contribution_from(d["data"])

    # -- submissions --------------------------------------------------------

    async def submit_attestations(self, atts) -> None:
        await self._post("/eth/v1/beacon/pool/attestations",
                         [api.attestation_json(a) for a in atts])

    async def submit_beacon_block(self, block) -> None:
        path = ("/eth/v1/beacon/blinded_blocks" if block.message.blinded
                else "/eth/v1/beacon/blocks")
        await self._post(path, api.signed_block_json(block))

    async def submit_voluntary_exit(self, exit_) -> None:
        await self._post("/eth/v1/beacon/pool/voluntary_exits",
                         api.exit_json(exit_))

    async def submit_validator_registrations(self, regs) -> None:
        await self._post("/eth/v1/validator/register_validator",
                         [api.registration_json(r) for r in regs])

    async def submit_aggregate_attestations(self, aggs) -> None:
        await self._post("/eth/v1/validator/aggregate_and_proofs",
                         [api.agg_and_proof_json(a) for a in aggs])

    async def submit_sync_committee_messages(self, msgs) -> None:
        await self._post("/eth/v1/beacon/pool/sync_committees",
                         [api.sync_msg_json(m) for m in msgs])

    async def submit_sync_committee_contributions(self, contribs) -> None:
        await self._post("/eth/v1/validator/contribution_and_proofs",
                         [api.contribution_and_proof_json(c)
                          for c in contribs])


class MultiBeaconClient:
    """First-success fan-out over multiple beacon nodes
    (reference: app/eth2wrap/eth2wrap.go:161-218 `provide`).

    Every call launches the request against all nodes concurrently and
    returns the first success, cancelling the rest; per-node error and
    latency stats feed monitoring (eth2wrap.go:40-58 metrics)."""

    def __init__(self, clients: list[BeaconClient]):
        if not clients:
            raise ValueError("need at least one beacon client")
        self.clients = clients
        self.errors: dict[str, int] = {c.base_url: 0 for c in clients}
        self.latency: dict[str, float] = {c.base_url: 0.0 for c in clients}
        self._registry = None

    def bind_registry(self, registry) -> None:
        """Export per-node request stats as real metrics
        (``app_beacon_requests_total{node,result}`` +
        ``app_beacon_request_seconds{node}``) — the errors/latency dicts
        alone never reach /metrics (reference: eth2wrap.go:40-58
        incError/observeLatency)."""
        self._registry = registry

    @classmethod
    def from_urls(cls, urls: list[str], timeout: float = 10.0):
        return cls([BeaconClient(u, timeout) for u in urls])

    async def close(self) -> None:
        for c in self.clients:
            await c.close()

    async def _first_success(self, method: str, *args, **kw):
        async def call(c: BeaconClient):
            t0 = time.monotonic()
            try:
                out = await getattr(c, method)(*args, **kw)
            except asyncio.CancelledError:
                raise  # the fan-out loser, not a node failure
            except Exception:
                self.errors[c.base_url] += 1
                if self._registry is not None:
                    self._registry.inc(
                        "app_beacon_requests_total",
                        labels={"node": c.base_url, "result": "error"})
                raise
            dt = time.monotonic() - t0
            self.latency[c.base_url] = dt
            if self._registry is not None:
                self._registry.inc(
                    "app_beacon_requests_total",
                    labels={"node": c.base_url, "result": "ok"})
                self._registry.observe("app_beacon_request_seconds", dt,
                                       labels={"node": c.base_url})
            return out

        if len(self.clients) == 1:
            return await call(self.clients[0])
        tasks = [asyncio.ensure_future(call(c)) for c in self.clients]
        try:
            last_err: Exception | None = None
            pending = set(tasks)
            while pending:
                done, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED)
                for t in done:
                    if t.exception() is None:
                        # async-ok: completed-task read (t is in the done set)
                        return t.result()
                    last_err = t.exception()
            raise last_err or RuntimeError("all beacon nodes failed")
        finally:
            for t in tasks:
                if not t.done():
                    t.cancel()

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)

        async def fan(*args, **kw):
            return await self._first_success(name, *args, **kw)

        return fan
