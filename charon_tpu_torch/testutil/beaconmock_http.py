"""HTTP beacon-node mock: a real beacon-API HTTP server over BeaconMock.

The reference's beaconmock is an actual HTTP server (static JSON + Go-side
overridable funcs, testutil/beaconmock/beaconmock.go:66-91); round-1's
in-process-object mock could not exercise any HTTP path.  This module
serves the in-process BeaconMock over aiohttp using the same endpoints the
beacon client (eth2util/beacon_client.py) and the validator-API reverse
proxy consume, so e2e tests run the genuine wire stack.

A copy of the JAX package's testutil/beaconmock_http.py, every route of
it, over the port's HTTP/1.1 server (`app/http1.py`) in place of aiohttp.
"""

from __future__ import annotations

from ..app import http1
from ..app.http1 import json_response
from ..eth2util import beaconapi as api
from .beaconmock import BeaconMock


def _ok(data, **extra) -> http1.Response:
    body = {"data": data}
    body.update(extra)
    return json_response(body)


class BeaconMockServer:
    """Serves a BeaconMock over HTTP; `addr` after start()."""

    def __init__(self, mock: BeaconMock, host: str = "127.0.0.1",
                 port: int = 0):
        self.mock = mock
        self._host, self._port = host, port
        self.addr: str = ""
        self.requests: list[str] = []  # request log (assertion point)

        r = self._server = http1.HTTPServer()
        r.add_get("/eth/v1/config/spec", self._spec)
        r.add_get("/eth/v1/beacon/genesis", self._genesis)
        r.add_get("/eth/v1/node/syncing", self._syncing)
        r.add_get("/eth/v1/node/version", self._version)
        r.add_get("/eth/v1/beacon/states/{state}/validators", self._validators)
        r.add_post("/eth/v1/beacon/states/{state}/validators",
                   self._validators)
        r.add_post("/eth/v1/validator/duties/attester/{epoch}",
                   self._attester_duties)
        r.add_get("/eth/v1/validator/duties/proposer/{epoch}",
                  self._proposer_duties)
        r.add_post("/eth/v1/validator/duties/sync/{epoch}", self._sync_duties)
        r.add_get("/eth/v1/validator/attestation_data", self._att_data)
        r.add_get("/eth/v2/validator/blocks/{slot}", self._block_proposal)
        r.add_get("/eth/v1/validator/blinded_blocks/{slot}",
                  self._blinded_proposal)
        r.add_get("/eth/v1/validator/aggregate_attestation", self._agg_att)
        r.add_get("/eth/v1/beacon/blocks/{block_id}/root", self._block_root)
        r.add_get("/eth/v1/validator/sync_committee_contribution",
                  self._sync_contribution)
        r.add_post("/eth/v1/beacon/pool/attestations", self._submit_atts)
        r.add_post("/eth/v1/beacon/blocks", self._submit_block)
        r.add_post("/eth/v1/beacon/blinded_blocks", self._submit_block)
        r.add_post("/eth/v1/beacon/pool/voluntary_exits", self._submit_exit)
        r.add_post("/eth/v1/validator/register_validator", self._submit_regs)
        r.add_post("/eth/v1/validator/aggregate_and_proofs", self._submit_aggs)
        r.add_post("/eth/v1/beacon/pool/sync_committees", self._submit_sync)
        r.add_post("/eth/v1/validator/contribution_and_proofs",
                   self._submit_contribs)
        r.add_post("/eth/v1/validator/beacon_committee_subscriptions",
                   self._noop_post)
        r.add_post("/eth/v1/validator/sync_committee_subscriptions",
                   self._noop_post)
        r.add_post("/eth/v1/validator/prepare_beacon_proposer",
                   self._noop_post)
        r.on_request(self._log)

    def _log(self, request: http1.Request) -> None:
        self.requests.append(f"{request.method} {request.path}")

    async def start(self) -> None:
        await self._server.start(self._host, self._port)
        self.addr = self._server.addr

    async def stop(self) -> None:
        await self._server.stop()

    # -- handlers -----------------------------------------------------------

    async def _spec(self, request) -> http1.Response:
        s = await self.mock.spec()
        return _ok({
            "SECONDS_PER_SLOT": str(s["SECONDS_PER_SLOT"]),
            "SLOTS_PER_EPOCH": str(s["SLOTS_PER_EPOCH"]),
            "GENESIS_FORK_VERSION": api.hex_of(s["GENESIS_FORK_VERSION"]),
        })

    async def _genesis(self, request) -> http1.Response:
        return _ok({
            "genesis_time": str(self.mock.genesis),
            "genesis_validators_root":
                api.hex_of(self.mock.genesis_validators_root),
            "genesis_fork_version": api.hex_of(self.mock.fork_version),
        })

    async def _syncing(self, request) -> http1.Response:
        s = await self.mock.node_syncing()
        return _ok({"is_syncing": s["is_syncing"],
                    "sync_distance": str(s["sync_distance"]),
                    "head_slot": "0"})

    async def _version(self, request) -> http1.Response:
        return _ok({"version": "charon-tpu/beaconmock"})

    async def _validators(self, request) -> http1.Response:
        ids: list[str] = []
        if request.method == "POST":
            body = request.json()
            ids = body.get("ids", [])
        elif "id" in request.query:
            ids = request.query["id"].split(",")
        out = []
        for pk, v in self.mock.validators.items():
            h = api.hex_of(v.pubkey)
            if not ids or h in ids or str(v.index) in ids:
                out.append(api.validator_json(v))
        return _ok(out)

    async def _attester_duties(self, request) -> http1.Response:
        epoch = int(request.match_info["epoch"])
        indices = [int(i) for i in request.json()]
        duties = await self.mock.attester_duties(epoch, indices)
        return _ok([api.attester_duty_json(d) for d in duties])

    async def _proposer_duties(self, request) -> http1.Response:
        epoch = int(request.match_info["epoch"])
        indices = [v.index for v in self.mock.validators.values()]
        duties = await self.mock.proposer_duties(epoch, indices)
        return _ok([api.proposer_duty_json(d) for d in duties])

    async def _sync_duties(self, request) -> http1.Response:
        epoch = int(request.match_info["epoch"])
        indices = [int(i) for i in request.json()]
        duties = await self.mock.sync_duties(epoch, indices)
        return _ok([api.sync_duty_json(d) for d in duties])

    async def _att_data(self, request) -> http1.Response:
        slot = int(request.query["slot"])
        committee_index = int(request.query.get("committee_index", 0))
        data = await self.mock.attestation_data(slot, committee_index)
        return _ok(api.att_data_json(data))

    async def _block_proposal(self, request) -> http1.Response:
        slot = int(request.match_info["slot"])
        randao = api.to_bytes(request.query["randao_reveal"])
        graffiti = api.to_bytes(request.query.get("graffiti", "0x"))
        block = await self.mock.beacon_block_proposal(slot, randao, graffiti)
        return _ok(api.block_json(block), version="charon_tpu/simple")

    async def _blinded_proposal(self, request) -> http1.Response:
        slot = int(request.match_info["slot"])
        randao = api.to_bytes(request.query["randao_reveal"])
        block = await self.mock.beacon_block_proposal(slot, randao,
                                                      blinded=True)
        return _ok(api.block_json(block), version="charon_tpu/simple")

    async def _agg_att(self, request) -> http1.Response:
        slot = int(request.query["slot"])
        root = api.to_bytes(request.query["attestation_data_root"], 32)
        att = await self.mock.aggregate_attestation(slot, root)
        return _ok(api.attestation_json(att))

    async def _block_root(self, request) -> http1.Response:
        block_id = request.match_info["block_id"]
        slot = int(block_id) if block_id.isdigit() else 0
        root = await self.mock.beacon_block_root(slot)
        return _ok({"root": api.hex_of(root)})

    async def _sync_contribution(self, request) -> http1.Response:
        slot = int(request.query["slot"])
        sub = int(request.query["subcommittee_index"])
        root = api.to_bytes(request.query["beacon_block_root"], 32)
        c = await self.mock.sync_committee_contribution(slot, sub, root)
        return _ok(api.sync_contribution_json(c))

    # -- submissions --------------------------------------------------------

    async def _submit_atts(self, request) -> http1.Response:
        atts = [api.attestation_from(d) for d in request.json()]
        await self.mock.submit_attestations(atts)
        return json_response({})

    async def _submit_block(self, request) -> http1.Response:
        block = api.signed_block_from(request.json())
        await self.mock.submit_beacon_block(block)
        return json_response({})

    async def _submit_exit(self, request) -> http1.Response:
        await self.mock.submit_voluntary_exit(
            api.exit_from(request.json()))
        return json_response({})

    async def _submit_regs(self, request) -> http1.Response:
        regs = [api.registration_from(d) for d in request.json()]
        await self.mock.submit_validator_registrations(regs)
        return json_response({})

    async def _submit_aggs(self, request) -> http1.Response:
        aggs = [api.agg_and_proof_from(d) for d in request.json()]
        await self.mock.submit_aggregate_attestations(aggs)
        return json_response({})

    async def _submit_sync(self, request) -> http1.Response:
        msgs = [api.sync_msg_from(d) for d in request.json()]
        await self.mock.submit_sync_committee_messages(msgs)
        return json_response({})

    async def _submit_contribs(self, request) -> http1.Response:
        cs = [api.contribution_and_proof_from(d) for d in request.json()]
        await self.mock.submit_sync_committee_contributions(cs)
        return json_response({})

    async def _noop_post(self, request) -> http1.Response:
        return json_response({})
