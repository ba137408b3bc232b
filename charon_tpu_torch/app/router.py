"""Validator-API HTTP router — the VC-facing surface of the node.

Mirrors reference core/validatorapi/router.go:
- intercepts the DV-aware endpoints and routes them to the ValidatorAPI
  component (router.go:84-212),
- maps pubshare ↔ group pubkey on the wire so the downstream VC only ever
  sees its share key (validatorapi.go:980-1014): the validators and duties
  endpoints rewrite group pubkeys to pubshares in responses, and pubshare
  query ids to group ids in requests,
- everything else is reverse-proxied verbatim to the upstream beacon node
  (router.go:771-829).

The serving layer (app/serving.py) sits across all three paths:
duty-data fetches are coalesced and slot/epoch-scoped cached, every
request passes per-endpoint admission control (503 + Retry-After past
the queue bound), proxy response bodies stream instead of buffering, and
the whole surface exports ``app_vapi_*`` request/latency/inflight/shed
metrics plus spans joining the duty trace.

A copy of the JAX package's app/router.py over the port's HTTP/1.1
server and client (`app/http1.py`) in place of aiohttp: the same routes,
statuses, bodies and ``Retry-After``.  aiohttp's two middlewares (the
admission wrapper outermost, then the error mapping) are one wrapper
around each route's handler here.  Differences the transport brings: a
request body is read whole before the handler runs (the response body
streams, as in JAX); an upstream connection that is refused, reset or
malformed (`OSError`, `http1.HTTPError`) maps to the 502 that
``aiohttp.ClientError`` maps to; `ServingConfig.pool_limit` bounds the
idle upstream connections kept, not the open ones.
"""

from __future__ import annotations

import asyncio
import contextlib
import copy
import json
import time

from ..core.types import Duty, DutyType, PubKey
from ..core.validatorapi import ValidatorAPI, VapiError
from ..eth2util import beaconapi as api
from ..eth2util.beacon_client import BeaconApiError
from . import http1, serving
from .http1 import Request, Response, json_response
from .tracing import duty_trace_id


_HOP_HEADERS = {"host", "content-length", "transfer-encoding", "connection",
                "keep-alive", "te", "trailers", "upgrade",
                "proxy-authorization", "proxy-authenticate"}

#: Chain metadata the proxy may cache forever (immutable per network);
#: everything else streams through verbatim.
_IMMORTAL_PATHS = ("/eth/v1/beacon/genesis", "/eth/v1/config/spec",
                   "/eth/v1/config/fork_schedule",
                   "/eth/v1/config/deposit_contract")

_CODE_CLASS = {1: "1xx", 2: "2xx", 3: "3xx", 4: "4xx", 5: "5xx"}


def _body_json(request: Request):
    """The request body as JSON; an empty or malformed body raises
    ValueError (a 400), as aiohttp's ``request.json()`` does."""
    return json.loads(request.body)


class VapiRouter:
    """HTTP server in front of a ValidatorAPI component + reverse proxy."""

    def __init__(self, vapi: ValidatorAPI, beacon_addr: str,
                 pubkey_by_index=None, host: str = "127.0.0.1",
                 port: int = 0, fee_recipient: str = "0x" + "00" * 20,
                 builder_api: bool = False, registry=None, tracer=None,
                 serving_config: "serving.ServingConfig | None" = None):
        """`beacon_addr` is the upstream BN base URL for the proxy;
        `pubkey_by_index` optionally resolves validator_index → group
        PubKey (used by voluntary exits, reference SubmitVoluntaryExit).
        `registry`/`tracer` feed the serving-layer metrics and duty-trace
        spans; `serving_config` tunes cache TTLs and admission bounds."""
        self.vapi = vapi
        self.beacon_addr = beacon_addr.rstrip("/")
        self._pubkey_by_index = pubkey_by_index
        self.fee_recipient = fee_recipient
        self.builder_api = builder_api
        self._host, self._port = host, port
        self._registry = registry
        self._tracer = tracer
        self._client: http1.HTTPClient | None = None
        self.addr = ""
        self.proxied: list[str] = []  # proxied request log (assertion point)

        self.serving_cfg = serving_config or serving.ServingConfig()
        cfg = self.serving_cfg
        self.cache = serving.SingleFlightCache(
            max_entries=cfg.max_entries, registry=registry)
        self.admission = serving.AdmissionController(
            limits=cfg.admission_limits, default_limit=cfg.default_limit,
            default_queue=cfg.default_queue, max_wait=cfg.max_wait,
            retry_after=cfg.retry_after, registry=registry)
        #: plain request counters keyed (endpoint, code class) — the
        #: bench/test assertion point next to the registry metrics
        self.requests: dict = {}
        vapi.attach_serving_cache(self.cache, ttl=cfg.att_data_ttl)

        self._http = http1.HTTPServer()

        def route(method: str, pattern: str, handler) -> None:
            self._http.add_route(method, pattern, self._wrap(handler))

        # -- intercepted (router.go:84-212) ---------------------------------
        route("GET", "/eth/v1/validator/attestation_data", self._att_data)
        route("POST", "/eth/v1/beacon/pool/attestations", self._submit_atts)
        route("GET", "/eth/v2/validator/blocks/{slot}", self._block_proposal)
        route("GET", "/eth/v1/validator/blinded_blocks/{slot}",
              self._block_proposal)
        route("POST", "/eth/v1/beacon/blocks", self._submit_block)
        route("POST", "/eth/v1/beacon/blinded_blocks", self._submit_block)
        route("POST", "/eth/v1/beacon/pool/voluntary_exits",
              self._submit_exit)
        route("POST", "/eth/v1/validator/register_validator",
              self._submit_regs)
        route("POST", "/eth/v1/validator/aggregate_and_proofs",
              self._submit_aggs)
        route("GET", "/eth/v1/validator/aggregate_attestation", self._agg_att)
        route("POST", "/eth/v1/beacon/pool/sync_committees",
              self._submit_sync)
        route("POST", "/eth/v1/validator/contribution_and_proofs",
              self._submit_contribs)
        route("POST", "/eth/v1/validator/beacon_committee_selections",
              self._bcomm_selections)
        route("POST", "/eth/v1/validator/sync_committee_selections",
              self._sync_selections)
        route("GET", "/teku_proposer_config", self._teku_proposer_config)
        # -- pubkey-mapped passthroughs (validatorapi.go:980-1014) ----------
        route("GET", "/eth/v1/beacon/states/{state}/validators",
              self._validators)
        route("POST", "/eth/v1/beacon/states/{state}/validators",
              self._validators)
        route("POST", "/eth/v1/validator/duties/attester/{epoch}",
              self._duties_mapped)
        route("GET", "/eth/v1/validator/duties/proposer/{epoch}",
              self._duties_mapped)
        route("POST", "/eth/v1/validator/duties/sync/{epoch}",
              self._duties_mapped)
        # -- reverse proxy for the rest (router.go:771-829) -----------------
        route("*", "/{tail:.*}", self._proxy)

    def _wrap(self, handler):
        """Admission control + request accounting + duty-trace span
        (outermost: it sheds before any handler work and records the
        status every path produced, the error bodies included), then the
        beacon-API error mapping, around `handler`."""

        async def serve(request: Request) -> Response:
            ep = serving.endpoint_class(request.method, request.path)
            t0 = time.monotonic()
            span = (self._tracer.start_span(
                        "vapi/" + ep,
                        trace_id=self._duty_trace_for(request),
                        method=request.method, path=request.path)
                    if self._tracer is not None
                    else contextlib.nullcontext())
            with span:
                try:
                    resp = await self._admitted(ep, request, handler)
                except serving.ShedError as e:
                    self._record(ep, 503, t0)
                    return json_response(
                        {"code": 503,
                         "message": "serving capacity exceeded, retry later"},
                        status=503,
                        headers={"Retry-After": str(int(e.retry_after) or 1)})
            self._record(ep, resp.status, t0)
            return resp

        return serve

    async def _admitted(self, ep: str, request: Request, handler) -> Response:
        """Run `handler` under `ep`'s admission; a streamed response
        holds its admission until the stream ends, as the JAX proxy's
        does (it writes the stream inside the handler)."""
        adm = self.admission.admit(ep)
        await adm.__aenter__()
        try:
            resp = await self._mapped(request, handler)
        except BaseException:
            await adm.__aexit__(None, None, None)
            raise
        if resp.stream is None:
            await adm.__aexit__(None, None, None)
        else:
            resp.stream = self._hold(resp.stream, adm)
        return resp

    @staticmethod
    async def _hold(stream, adm):
        try:
            async for piece in stream:
                yield piece
        finally:
            await stream.aclose()
            await adm.__aexit__(None, None, None)

    def _record(self, ep: str, status: int, t0: float) -> None:
        code = _CODE_CLASS.get(status // 100, "other")
        self.requests[(ep, code)] = self.requests.get((ep, code), 0) + 1
        if self._registry is None:
            return
        self._registry.inc("app_vapi_requests_total",
                           labels={"endpoint": ep, "code": code})
        self._registry.observe("app_vapi_request_seconds",
                               time.monotonic() - t0,
                               labels={"endpoint": ep})

    def _duty_trace_for(self, request: Request) -> str | None:
        """Join the cluster-wide duty trace when the request addresses a
        specific duty (reference: core/tracing.go duty-deterministic
        trace IDs): attestation endpoints key on the slot query param,
        proposal endpoints on the slot path segment."""
        try:
            path = request.path
            if ("/validator/attestation_data" in path
                    or "/validator/aggregate_attestation" in path):
                return duty_trace_id(
                    Duty(int(request.query["slot"]), DutyType.ATTESTER))
            if "/blocks/" in path or "/blinded_blocks/" in path:
                slot = request.match_info.get("slot")
                if slot is not None:
                    return duty_trace_id(Duty(int(slot), DutyType.PROPOSER))
        except (KeyError, ValueError):
            return None
        return None

    async def _mapped(self, request: Request, handler) -> Response:
        """Beacon-API error convention: {"code": N, "message": ...}
        (reference: router.go writeError).  Upstream beacon failures map
        to 502 — the node's own fault surface is 4xx/504, a broken BN
        behind it must not masquerade as a router bug.  A timeout is
        tested before the connection errors: `TimeoutError` is an
        `OSError`."""
        try:
            return await handler(request)
        except (VapiError, ValueError, KeyError) as e:
            return json_response({"code": 400, "message": str(e)},
                                 status=400)
        except BeaconApiError as e:
            return json_response(
                {"code": 502, "message": f"upstream beacon error: {e}"},
                status=502)
        except asyncio.TimeoutError:
            return json_response({"code": 504, "message": "timeout"},
                                 status=504)
        except (http1.HTTPError, OSError) as e:
            return json_response(
                {"code": 502,
                 "message": f"upstream beacon unreachable: {e}"},
                status=502)

    async def start(self) -> None:
        # one pooled client for every upstream edge: mapped fetches,
        # cacheable metadata and the streaming proxy all share its
        # connection pool (reference: eth2wrap's shared http.Client)
        self._client = http1.HTTPClient(
            timeout=30.0, pool_size=self.serving_cfg.pool_limit)
        await self._http.start(self._host, self._port)
        self.addr = self._http.addr

    async def stop(self) -> None:
        if self._client is not None:
            await self._client.close()
        await self._http.stop()

    # -- helpers ------------------------------------------------------------

    def _share_for_group(self, group_hex: str) -> str:
        """group pubkey hex → this node's pubshare hex (response mapping)."""
        pk = PubKey(group_hex)
        share = self.vapi._pubshare_by_group.get(pk)
        return api.hex_of(share) if share is not None else group_hex

    def _group_for_share(self, share_hex: str) -> str:
        """pubshare hex → group pubkey hex (request mapping)."""
        try:
            pk = self.vapi.group_pubkey_for_share(api.to_bytes(share_hex, 48))
            return str(pk)
        except (VapiError, ValueError):
            return share_hex

    def _multi_params(self, request: Request,
                      map_ids: bool = False) -> list[tuple[str, str]]:
        """Rebuild the query string as a multi-value list: the beacon API
        allows REPEATED params as well as comma-separated values, and a
        first-value dict silently drops all but the first repeat.  With
        `map_ids`, pubshare hex values under the ``id`` key are rewritten
        to group pubkeys."""
        params: list[tuple[str, str]] = []
        for key in dict.fromkeys(k for k, _ in request.query_items):
            values = request.getall(key)
            if map_ids and key == "id":
                mapped = ",".join(
                    self._group_for_share(i) if i.startswith("0x") else i
                    for raw in values for i in raw.split(","))
                params.append((key, mapped))
            else:
                params.extend((key, v) for v in values)
        return params

    # -- intercepted handlers -----------------------------------------------

    async def _att_data(self, request) -> Response:
        slot = int(request.query["slot"])
        ci = int(request.query.get("committee_index", 0))
        data = await self.vapi.attestation_data(slot, ci)
        return json_response({"data": api.att_data_json(data)})

    async def _submit_atts(self, request) -> Response:
        atts = [api.attestation_from(d) for d in _body_json(request)]
        await self.vapi.submit_attestations(atts)
        return json_response({})

    async def _block_proposal(self, request) -> Response:
        slot = int(request.match_info["slot"])
        randao = api.to_bytes(request.query["randao_reveal"])
        graffiti = api.to_bytes(request.query.get("graffiti", "0x"))
        block = await self.vapi.beacon_block_proposal(slot, randao, graffiti)
        return json_response({"data": api.block_json(block),
                              "version": "charon_tpu/simple"})

    async def _submit_block(self, request) -> Response:
        block = api.signed_block_from(_body_json(request))
        await self.vapi.submit_beacon_block(block)
        return json_response({})

    async def _submit_exit(self, request) -> Response:
        exit_ = api.exit_from(_body_json(request))
        if self._pubkey_by_index is None:
            return Response(500, b"no validator index map")
        group_pk = await self._pubkey_by_index(exit_.message.validator_index)
        await self.vapi.submit_voluntary_exit(exit_, group_pk)
        return json_response({})

    async def _submit_regs(self, request) -> Response:
        regs = [api.registration_from(d) for d in _body_json(request)]
        await self.vapi.submit_validator_registrations(regs)
        return json_response({})

    async def _submit_aggs(self, request) -> Response:
        aggs = [api.agg_and_proof_from(d) for d in _body_json(request)]
        await self.vapi.submit_aggregate_attestations(aggs)
        return json_response({})

    async def _agg_att(self, request) -> Response:
        # aggregate is served from the DutyDB (consensus-agreed), mirroring
        # vapi.AggregateBeaconCommitteeAttestation
        slot = int(request.query["slot"])
        root = api.to_bytes(request.query["attestation_data_root"], 32)
        agg = await self.vapi._await_agg_attestation(slot, root)
        return json_response({"data": api.attestation_json(agg)})

    async def _submit_sync(self, request) -> Response:
        msgs = [api.sync_msg_from(d) for d in _body_json(request)]
        await self.vapi.submit_sync_committee_messages(msgs)
        return json_response({})

    async def _submit_contribs(self, request) -> Response:
        cs = [api.contribution_and_proof_from(d) for d in _body_json(request)]
        await self.vapi.submit_sync_contributions(cs)
        return json_response({})

    async def _bcomm_selections(self, request) -> Response:
        sels = [api.bcomm_selection_from(d) for d in _body_json(request)]
        out = await self.vapi.submit_beacon_committee_selections(sels)
        return json_response(
            {"data": [api.bcomm_selection_json(s) for s in out]})

    async def _sync_selections(self, request) -> Response:
        sels = [api.sync_selection_from(d) for d in _body_json(request)]
        out = await self.vapi.submit_sync_committee_selections(sels)
        return json_response(
            {"data": [api.sync_selection_json(s) for s in out]})

    async def _teku_proposer_config(self, request) -> Response:
        """Teku proposer-config endpoint (reference:
        core/validatorapi/teku.go): maps each PUBSHARE to its proposer
        settings so Teku VCs configure fee recipients per share key."""
        entries = {}
        for group_pk, share in self.vapi._pubshare_by_group.items():
            entries[api.hex_of(share)] = {
                "fee_recipient": self.fee_recipient,
                "builder": {"enabled": self.builder_api,
                            "gas_limit": "30000000"},
            }
        return json_response({
            "proposer_config": entries,
            "default_config": {
                "fee_recipient": self.fee_recipient,
                "builder": {"enabled": self.builder_api},
            },
        })

    # -- pubkey-mapped passthroughs ----------------------------------------

    async def _validators(self, request) -> Response:
        """Map pubshare ids → group ids upstream, group pubkeys → pubshares
        downstream (reference: validatorapi.go getValidators pubshare
        mapping).  The upstream snapshot is coalesced + cached per
        distinct id-set."""
        state = request.match_info["state"]
        if request.method == "POST":
            body = _body_json(request)
            ids = [self._group_for_share(i) if i.startswith("0x") else i
                   for i in body.get("ids", [])]
            upstream = await self._upstream_json(
                "POST", f"/eth/v1/beacon/states/{state}/validators",
                json_body={"ids": ids},
                cache=("validators", (state, tuple(ids))),
                ttl=self.serving_cfg.validators_ttl)
        else:
            params = self._multi_params(request, map_ids=True)
            upstream = await self._upstream_json(
                "GET", f"/eth/v1/beacon/states/{state}/validators",
                params=params,
                cache=("validators", (state, tuple(params))),
                ttl=self.serving_cfg.validators_ttl)
        for v in upstream.get("data", []):
            v["validator"]["pubkey"] = self._share_for_group(
                v["validator"]["pubkey"])
        return json_response(upstream)

    async def _duties_mapped(self, request) -> Response:
        """Forward duties requests, rewriting group pubkeys → pubshares in
        the response so the VC recognises its keys.  N VCs asking for one
        epoch's duties share a single coalesced, epoch-TTL'd upstream
        fetch."""
        path = request.path
        if request.method == "POST":
            body = _body_json(request)
            upstream = await self._upstream_json(
                "POST", path, json_body=body,
                cache=("duties", (path, tuple(
                    body if isinstance(body, list) else [repr(body)]))),
                ttl=self.serving_cfg.duties_ttl)
        else:
            params = self._multi_params(request)
            upstream = await self._upstream_json(
                "GET", path, params=params,
                cache=("duties", (path, tuple(params))),
                ttl=self.serving_cfg.duties_ttl)
        for d in upstream.get("data", []):
            if "pubkey" in d:
                d["pubkey"] = self._share_for_group(d["pubkey"])
        return json_response(upstream)

    async def _upstream_json(self, method: str, path: str,
                             params=None, json_body=None,
                             cache: tuple | None = None,
                             ttl: float | None = None) -> dict:
        """One upstream JSON fetch, optionally coalesced + cached under
        `cache=(endpoint, key)`.  Cached payloads are deep-copied out so
        per-request pubkey rewrites never mutate the shared entry."""
        url = self.beacon_addr + path

        async def fetch() -> dict:
            resp = await self._client.request(method, url, params=params,
                                              json_body=json_body)
            if resp.status != 200:
                raise BeaconApiError(resp.status, resp.text(), url)
            return resp.json()

        if cache is None:
            return await fetch()
        endpoint, key = cache
        out = await self.cache.get(endpoint, key, fetch, ttl=ttl)
        return copy.deepcopy(out)

    # -- reverse proxy ------------------------------------------------------

    async def _proxy(self, request: Request) -> Response:
        """Reverse proxy to the beacon node (reference:
        router.go:771-829 proxyHandler).  Immutable chain metadata is
        served from the coalescing cache; everything else passes through
        verbatim, the response body streamed chunk by chunk as it
        arrives, never held whole."""
        self.proxied.append(f"{request.method} {request.path}")
        if (request.method == "GET" and not request.query_string
                and request.path in _IMMORTAL_PATHS):
            ctype, body = await self.cache.get(
                "metadata", request.path, lambda: self._fetch_raw(request))
            return Response(200, body, ctype)
        url = self.beacon_addr + request.path_qs
        headers = {k: v for k, v in request.headers.items()
                   if k not in _HOP_HEADERS}
        data = (request.body if request.body
                or request.method in ("POST", "PUT", "PATCH") else None)
        resp = await self._client.open(request.method, url, headers=headers,
                                       data=data)
        out_headers = {k: v for k, v in resp.headers.items()
                       if k not in _HOP_HEADERS}

        async def body():
            try:
                async for piece in resp.iter_chunks():
                    yield piece
            finally:
                resp.release()

        return Response(resp.status, headers=out_headers, stream=body())

    async def _fetch_raw(self, request: Request) -> tuple:
        """Body fetch for the cacheable metadata paths; non-200 raises so
        failures reject the coalesced waiters without being cached."""
        url = self.beacon_addr + request.path
        resp = await self._client.request("GET", url)
        if resp.status != 200:
            raise BeaconApiError(resp.status, resp.text(), url)
        return (resp.headers.get("content-type", "application/json"),
                resp.body)
