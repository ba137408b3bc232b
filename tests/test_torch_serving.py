"""The serving layer on the port (`charon_tpu_torch.app.serving`,
`app.router` over `app.http1`) held against the JAX package's
(`charon_tpu.app.serving`, `app.router` over aiohttp): the counterpart of
each case of tests/test_serving.py.  Every case runs one script against
both stacks — the same cache calls, or the same HTTP requests against
each package's router in front of an upstream of its own HTTP stack — and
compares what the scripts observe exactly: results and counters, status
codes, parsed JSON bodies, ``Retry-After``, the requests the upstream
saw and its fetch counts.  No latency is compared.  Pure asyncio over
in-process HTTP, no device work."""

import asyncio
import collections
import json
import types

import aiohttp
import pytest
import torch
from aiohttp import web

torch.set_num_threads(1)

import bench  # noqa: E402  — the JAX package's serving arms
from charon_tpu.app import monitoring as j_monitoring  # noqa: E402
from charon_tpu.app import router as j_router  # noqa: E402
from charon_tpu.app import serving as j_serving  # noqa: E402
from charon_tpu.core import validatorapi as j_vapi  # noqa: E402
from charon_tpu.eth2util import beacon_client as j_bc  # noqa: E402
from charon_tpu.testutil import beaconmock as j_bmock  # noqa: E402
from charon_tpu.testutil import beaconmock_http as j_bmock_http  # noqa: E402
from charon_tpu_torch.app import http1  # noqa: E402
from charon_tpu_torch.app import monitoring as t_monitoring  # noqa: E402
from charon_tpu_torch.app import router as t_router  # noqa: E402
from charon_tpu_torch.app import serving as t_serving  # noqa: E402
from charon_tpu_torch.core import validatorapi as t_vapi  # noqa: E402
from charon_tpu_torch.eth2util import beacon_client as t_bc  # noqa: E402
from charon_tpu_torch.testutil import beaconmock as t_bmock  # noqa: E402
from charon_tpu_torch.testutil import beaconmock_http as t_bmock_http  # noqa
from charon_tpu_torch.testutil import serving_load  # noqa: E402

FORK = bytes(4)


class _AiohttpUpstream:
    """The JAX side's recording upstream (tests/test_serving.py's): every
    request's multi-value query and body, answered with {"data": []} or
    an error body."""

    def __init__(self, status=200, delay=0.0):
        self.calls = []     # (method, path, [(key, value)...], body)
        self.status = status
        self.delay = delay
        self.addr = ""
        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", self._handle)
        self._app = app
        self._runner = None

    async def _handle(self, request):
        params = [(k, v) for k in dict.fromkeys(request.query.keys())
                  for v in request.query.getall(k)]
        body = await request.text() if request.can_read_body else ""
        self.calls.append((request.method, request.path, params, body))
        if self.delay:
            await asyncio.sleep(self.delay)
        if self.status != 200:
            return web.json_response(
                {"code": self.status, "message": "upstream boom"},
                status=self.status)
        return web.json_response({"data": []})

    async def start(self):
        self._runner = web.AppRunner(self._app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        self.addr = f"http://127.0.0.1:{port}"

    async def stop(self):
        await self._runner.cleanup()


class _Http1Upstream:
    """The port side's recording upstream, on `app.http1`: a ``*`` route
    over ``{tail:.*}`` and the query's repeated keys in order."""

    def __init__(self, status=200, delay=0.0):
        self.calls = []
        self.status = status
        self.delay = delay
        self.addr = ""
        self._server = http1.HTTPServer()
        self._server.add_route("*", "/{tail:.*}", self._handle)

    async def _handle(self, request):
        params = [(k, v) for k in dict.fromkeys(
            k for k, _ in request.query_items) for v in request.getall(k)]
        self.calls.append((request.method, request.path, params,
                           request.body.decode()))
        if self.delay:
            await asyncio.sleep(self.delay)
        if self.status != 200:
            return http1.json_response(
                {"code": self.status, "message": "upstream boom"},
                status=self.status)
        return http1.json_response({"data": []})

    async def start(self):
        await self._server.start()
        self.addr = self._server.addr

    async def stop(self):
        await self._server.stop()


JAX = types.SimpleNamespace(
    name="jax", serving=j_serving, router=j_router, Registry=j_monitoring.Registry,
    ValidatorAPI=j_vapi.ValidatorAPI, BeaconApiError=j_bc.BeaconApiError,
    BeaconClient=j_bc.BeaconClient, MultiBeaconClient=j_bc.MultiBeaconClient,
    BeaconMock=j_bmock.BeaconMock, BeaconMockServer=j_bmock_http.BeaconMockServer,
    Upstream=_AiohttpUpstream)
PORT = types.SimpleNamespace(
    name="port", serving=t_serving, router=t_router, Registry=t_monitoring.Registry,
    ValidatorAPI=t_vapi.ValidatorAPI, BeaconApiError=t_bc.BeaconApiError,
    BeaconClient=t_bc.BeaconClient, MultiBeaconClient=t_bc.MultiBeaconClient,
    BeaconMock=t_bmock.BeaconMock, BeaconMockServer=t_bmock_http.BeaconMockServer,
    Upstream=_Http1Upstream)


def both(scenario):
    """`scenario(pkg)` on the JAX package and on the port → (jax, port)."""
    return scenario(JAX), scenario(PORT)


def _families(text: str) -> list:
    """A rendered registry's series without their values."""
    return sorted(line.rsplit(" ", 1)[0] for line in text.splitlines()
                  if line and not line.startswith("#"))


async def _request(client: str, method: str, url: str, json_body=None):
    """(status, Retry-After, parsed JSON body or None) of one exchange,
    through aiohttp or the port's `http1` client."""
    if client == "aiohttp":
        async with aiohttp.ClientSession() as s:
            async with s.request(method, url, json=json_body) as resp:
                text = await resp.text()
                ra = resp.headers.get("Retry-After")
                status = resp.status
    else:
        c = http1.HTTPClient()
        try:
            resp = await c.request(method, url, json_body=json_body)
        finally:
            await c.close()
        text, ra, status = resp.text(), resp.headers.get("retry-after"), \
            resp.status
    try:
        body = json.loads(text)
    except ValueError:
        body = None
    return status, ra, body


def _mk_router(pkg, upstream_addr, serving_config=None, registry=None):
    vapi = pkg.ValidatorAPI(share_idx=1, pubshare_by_group={},
                            fork_version=FORK)
    return pkg.router.VapiRouter(vapi, upstream_addr,
                                 serving_config=serving_config,
                                 registry=registry)


# ---------------------------------------------------------------------------
# SingleFlightCache
# ---------------------------------------------------------------------------


def test_coalesced_waiters_share_one_fetch():
    """N concurrent requesters of one key share ONE upstream fetch and
    all observe its result; the counters attribute the fan-in."""

    def scenario(pkg):
        async def main():
            reg = pkg.Registry()
            cache = pkg.serving.SingleFlightCache(registry=reg)
            gate = asyncio.Event()
            calls = []

            async def fetch():
                calls.append(1)
                await gate.wait()
                return {"v": len(calls)}

            tasks = [asyncio.ensure_future(cache.get("duties", "k", fetch))
                     for _ in range(16)]
            await asyncio.sleep(0)
            gate.set()
            results = await asyncio.gather(*tasks)
            first = (len(calls), results, cache.stats())
            again = await cache.get("duties", "k", fetch)
            return first, again, len(calls), cache.stats(), reg.render()

        return asyncio.run(main())

    j, t = both(scenario)
    assert t == j
    (calls, results, stats), again, calls2, stats2, rendered = t
    assert calls == 1 and all(r == {"v": 1} for r in results)
    assert stats["duties"]["misses"] == 1
    assert stats["duties"]["coalesced"] == 15
    assert again == {"v": 1} and calls2 == 1
    assert stats2["duties"]["hits"] == 1
    for fam in ("app_serving_coalesced_total",
                "app_serving_cache_hits_total",
                "app_serving_cache_misses_total"):
        assert fam in rendered


def test_failed_fetch_rejects_all_waiters_without_poisoning():
    """A failed fetch propagates to EVERY coalesced waiter and caches
    nothing — the next request starts a fresh fetch and succeeds."""

    def scenario(pkg):
        async def main():
            cache = pkg.serving.SingleFlightCache()
            gate = asyncio.Event()
            calls = []

            async def fetch():
                calls.append(1)
                if len(calls) == 1:
                    await gate.wait()
                    raise pkg.BeaconApiError(503, "flap", "stub")
                return "recovered"

            tasks = [asyncio.ensure_future(cache.get("duties", "k", fetch))
                     for _ in range(8)]
            await asyncio.sleep(0)
            gate.set()
            results = await asyncio.gather(*tasks, return_exceptions=True)
            out = [len(calls), [type(r).__name__ for r in results],
                   [getattr(r, "status", None) for r in results]]
            out.append(await cache.get("duties", "k", fetch))
            out.append(len(calls))
            out.append(await cache.get("duties", "k", fetch))
            out.append(len(calls))
            return out

        return asyncio.run(main())

    j, t = both(scenario)
    assert t == j
    assert t[0] == 1 and set(t[1]) == {"BeaconApiError"}
    assert set(t[2]) == {503}
    assert t[3:] == ["recovered", 2, "recovered", 2]


def test_cancelled_waiter_does_not_kill_shared_fetch():
    """asyncio.shield: one waiter's cancellation must not cancel the
    in-flight fetch the other waiters share."""

    def scenario(pkg):
        async def main():
            cache = pkg.serving.SingleFlightCache()
            gate = asyncio.Event()

            async def fetch():
                await gate.wait()
                return "shared"

            t1 = asyncio.ensure_future(cache.get("x", "k", fetch))
            t2 = asyncio.ensure_future(cache.get("x", "k", fetch))
            await asyncio.sleep(0)
            t2.cancel()
            gate.set()
            first = await t1
            try:
                await t2
                second = "done"
            except asyncio.CancelledError:
                second = "cancelled"
            return first, second

        return asyncio.run(main())

    j, t = both(scenario)
    assert t == j == ("shared", "cancelled")


def test_lru_bound_evicts_oldest():
    def scenario(pkg):
        async def main():
            cache = pkg.serving.SingleFlightCache(max_entries=4)

            async def fetch_v(k):
                return k

            for k in range(6):
                await cache.get("x", k, lambda k=k: fetch_v(k))
            out = [len(cache._entries), sorted(k for _, k in cache._entries)]
            before = cache.stats()["x"]["misses"]
            await cache.get("x", 5, lambda: fetch_v(5))
            out.append(cache.stats()["x"]["misses"] - before)
            await cache.get("x", 0, lambda: fetch_v(0))
            out.append(cache.stats()["x"]["misses"] - before)
            return out

        return asyncio.run(main())

    j, t = both(scenario)
    assert t == j == [4, [2, 3, 4, 5], 0, 1]


# ---------------------------------------------------------------------------
# CachingBeaconClient: fake-clock deadlines + retries
# ---------------------------------------------------------------------------


class _StubBeacon:
    def __init__(self, error_cls):
        self.calls = collections.Counter()
        self.fail_next = 0
        self._error = error_cls

    async def spec(self):
        self.calls["spec"] += 1
        return {"SECONDS_PER_SLOT": 12.0, "SLOTS_PER_EPOCH": 32}

    async def attestation_data(self, slot, committee_index):
        self.calls["att"] += 1
        if self.fail_next > 0:
            self.fail_next -= 1
            raise self._error(503, "flap", "stub")
        return {"slot": slot, "ci": committee_index,
                "gen": self.calls["att"]}

    async def attester_duties(self, epoch, indices):
        self.calls["duties"] += 1
        return [{"epoch": epoch, "gen": self.calls["duties"]}]

    async def submit_attestations(self, atts):
        self.calls["submit"] += 1


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def test_slot_boundary_never_serves_stale_attestation_data():
    """Attestation data is cached only until ITS slot's boundary in the
    injected clock's domain; duties until their epoch's; spec forever;
    submissions pass through uncached."""

    def scenario(pkg):
        async def main():
            stub, clk = _StubBeacon(pkg.BeaconApiError), _Clock(5.0)
            cl = pkg.serving.CachingBeaconClient(
                stub, clock=clk, slot_duration=12.0, slots_per_epoch=32,
                genesis_time=0.0)
            out = []
            for t, call in ((5.0, lambda: cl.attestation_data(0, 1)),
                            (11.999, lambda: cl.attestation_data(0, 1)),
                            (12.0, lambda: cl.attestation_data(0, 1)),
                            (100.0, lambda: cl.attester_duties(0, [1, 2])),
                            (383.9, lambda: cl.attester_duties(0, [1, 2])),
                            (384.0, lambda: cl.attester_duties(0, [1, 2]))):
                clk.t = t
                got = await call()
                out.append(got["gen"] if isinstance(got, dict)
                           else got[0]["gen"])
            clk.t = 1e9
            await cl.spec()
            await cl.spec()
            await cl.submit_attestations([])
            await cl.submit_attestations([])
            return out, dict(stub.calls)

        return asyncio.run(main())

    j, t = both(scenario)
    assert t == j
    gens, calls = t
    assert gens == [1, 1, 2, 1, 1, 2]
    assert calls == {"att": 2, "duties": 2, "spec": 1, "submit": 2}


def test_caching_client_bounded_retry_absorbs_flap():
    def scenario(pkg):
        async def main():
            async def no_sleep(_):
                return None

            stub = _StubBeacon(pkg.BeaconApiError)
            stub.fail_next = 2
            cl = pkg.serving.CachingBeaconClient(stub, retries=3,
                                                 sleep=no_sleep)
            out = (await cl.attestation_data(7, 0))["slot"]
            stub2 = _StubBeacon(pkg.BeaconApiError)
            stub2.fail_next = 5
            cl2 = pkg.serving.CachingBeaconClient(stub2, retries=1,
                                                  sleep=no_sleep)
            try:
                await cl2.attestation_data(8, 0)
                err = None
            except pkg.BeaconApiError as e:
                err = e.status
            return out, stub.calls["att"], err, stub2.calls["att"]

        return asyncio.run(main())

    j, t = both(scenario)
    assert t == j == (7, 3, 503, 2)


def test_retryable_errors_are_the_ports_transport_failures():
    """The one deliberate difference: the port retries its own HTTP
    stack's failures (`http1.HTTPError`, `OSError`: a refused or reset
    connection) where the JAX package retries ``aiohttp.ClientError``."""
    assert set(t_serving.RETRYABLE_ERRORS) == {
        t_bc.BeaconApiError, http1.HTTPError, OSError,
        asyncio.TimeoutError, ConnectionError}
    assert aiohttp.ClientError in j_serving.RETRYABLE_ERRORS

    async def main():
        calls = []

        class Flaky:
            async def spec(self):
                calls.append(1)
                if len(calls) < 3:
                    raise (http1.HTTPError("reset") if len(calls) == 1
                           else ConnectionRefusedError("refused"))
                return {"SLOTS_PER_EPOCH": 4}

        async def no_sleep(_):
            return None

        cl = t_serving.CachingBeaconClient(Flaky(), retries=2,
                                           sleep=no_sleep)
        return await cl.spec(), len(calls)

    assert asyncio.run(main()) == ({"SLOTS_PER_EPOCH": 4}, 3)


# ---------------------------------------------------------------------------
# AdmissionController
# ---------------------------------------------------------------------------


def test_admission_sheds_past_queue_bound():
    def scenario(pkg):
        async def main():
            ctl = pkg.serving.AdmissionController(limits={"duties": (1, 1)})
            first = ctl.admit("duties")
            await first.__aenter__()
            waiter = asyncio.ensure_future(ctl.admit("duties").__aenter__())
            await asyncio.sleep(0)
            try:
                async with ctl.admit("duties"):
                    pass
                shed_ep = None
            except pkg.serving.ShedError as e:
                shed_ep = (e.endpoint, e.retry_after)
            out = [shed_ep, dict(ctl.shed)]
            await first.__aexit__(None, None, None)
            adm = await waiter
            await adm.__aexit__(None, None, None)
            out.append(dict(ctl.admitted))
            return out

        return asyncio.run(main())

    j, t = both(scenario)
    assert t == j == [("duties", 1.0), {"duties": 1}, {"duties": 2}]


def test_endpoint_classes_are_bounded():
    cases = [("GET", "/eth/v1/validator/attestation_data"),
             ("POST", "/eth/v1/validator/duties/attester/3"),
             ("GET", "/eth/v1/validator/duties/proposer/3"),
             ("GET", "/eth/v1/beacon/states/head/validators"),
             ("POST", "/eth/v1/beacon/states/head/validators"),
             ("GET", "/eth/v2/validator/blocks/5"),
             ("GET", "/eth/v1/validator/blinded_blocks/5"),
             ("POST", "/eth/v1/beacon/blocks"),
             ("GET", "/eth/v1/validator/aggregate_attestation"),
             ("POST", "/eth/v1/validator/contribution_and_proofs"),
             ("POST", "/eth/v1/beacon/pool/sync_committees"),
             ("POST", "/eth/v1/beacon/pool/attestations"),
             ("GET", "/eth/v1/config/spec"), ("GET", "/eth/v1/beacon/genesis"),
             ("GET", "/eth/v1/config/fork_schedule"),
             ("GET", "/eth/v1/config/deposit_contract"),
             ("GET", "/eth/v1/node/version"), ("GET", "/teku_proposer_config")]
    got = [t_serving.endpoint_class(m, p) for m, p in cases]
    assert got == [j_serving.endpoint_class(m, p) for m, p in cases]
    assert got[:3] == ["attestation_data", "duties", "duties"]
    assert got[-2:] == ["proxy", "proxy"] and got[12] == "metadata"


# ---------------------------------------------------------------------------
# Router over HTTP: param forwarding, shedding, error mapping
# ---------------------------------------------------------------------------


def test_repeated_query_params_forwarded():
    """The beacon API allows repeated query params; both mapped GET
    surfaces forward every occurrence, in order — the same requests reach
    either package's upstream."""

    def scenario(pkg):
        async def main():
            up = pkg.Upstream()
            await up.start()
            router = _mk_router(pkg, up.addr)
            await router.start()
            try:
                out = [await _request(
                    "http1", "GET", router.addr + path) for path in (
                    "/eth/v1/validator/duties/proposer/0"
                    "?index=1&index=2&status=a&status=b",
                    "/eth/v1/beacon/states/head/validators"
                    "?id=0&id=1&status=active_ongoing&status=exited")]
            finally:
                await router.stop()
                await up.stop()
            return out, up.calls

        return asyncio.run(main())

    j, t = both(scenario)
    assert t == j
    statuses, calls = t
    assert [s for s, _, _ in statuses] == [200, 200]
    (_, _, duty_params, _), (_, _, val_params, _) = calls
    assert duty_params == [("index", "1"), ("index", "2"),
                           ("status", "a"), ("status", "b")]
    assert val_params == [("id", "0,1"), ("status", "active_ongoing"),
                          ("status", "exited")]


def test_admission_shed_503_with_retry_after():
    """Above the admission bound the router sheds with 503 +
    Retry-After; below it (sequential requests) there are ZERO 503s.
    The same script through aiohttp and through `http1` clients."""

    def scenario(pkg, client):
        async def main():
            up = pkg.Upstream(delay=0.2)
            await up.start()
            cfg = pkg.serving.ServingConfig(
                admission_limits={"duties": (1, 0)}, retry_after=2.0)
            router = _mk_router(pkg, up.addr, serving_config=cfg)
            await router.start()
            try:
                def one(epoch):
                    return _request(client, "GET", router.addr
                                    + f"/eth/v1/validator/duties/proposer/"
                                    f"{epoch}")
                burst = await asyncio.gather(*[one(k) for k in range(4)])
                shed = sum(router.admission.shed.values())
                seq = [await one(e) for e in range(10, 13)]
                shed2 = sum(router.admission.shed.values())
            finally:
                await router.stop()
                await up.stop()
            return (sorted(burst, key=lambda r: r[0]), shed, seq, shed2,
                    len(up.calls), dict(router.requests))

        return asyncio.run(main())

    for client in ("aiohttp", "http1"):
        j, t = scenario(JAX, client), scenario(PORT, client)
        assert t == j, client
        burst, shed, seq, shed2, fetches, reqs = t
        assert [s for s, _, _ in burst] == [200, 503, 503, 503]
        assert all(ra == "2" for s, ra, _ in burst if s == 503)
        assert burst[1][2] == {"code": 503, "message":
                               "serving capacity exceeded, retry later"}
        assert shed == 3 and shed2 == 3
        assert [s for s, _, _ in seq] == [200, 200, 200]
        assert fetches == 4
        assert reqs == {("duties", "2xx"): 4, ("duties", "5xx"): 3}


def test_upstream_errors_map_to_502():
    """A broken BN surfaces as 502 with a beacon-API error body — not as a
    router 4xx/500 — whether it answers 500 or refuses the connection."""

    def scenario(pkg):
        async def main():
            up = pkg.Upstream(status=500)
            await up.start()
            router = _mk_router(pkg, up.addr)
            await router.start()
            try:
                broken = await _request(
                    "http1", "GET",
                    router.addr + "/eth/v1/validator/duties/proposer/0")
            finally:
                await router.stop()
                await up.stop()
            router = _mk_router(pkg, "http://127.0.0.1:1")
            await router.start()
            try:
                refused = await _request(
                    "http1", "POST",
                    router.addr + "/eth/v1/validator/duties/attester/0",
                    json_body=["0"])
                proxied = await _request(
                    "http1", "GET", router.addr + "/eth/v1/node/version")
            finally:
                await router.stop()
            # the message up to the exception's own text
            return [(s, ra, b["code"], b["message"].split(":")[0])
                    for s, ra, b in (broken, refused, proxied)]

        return asyncio.run(main())

    j, t = both(scenario)
    assert t == j
    assert t == [(502, None, 502, "upstream beacon error"),
                 (502, None, 502, "upstream beacon unreachable"),
                 (502, None, 502, "upstream beacon unreachable")]


def test_metadata_proxy_coalesced_and_requests_metered():
    """Immortal metadata rides the coalescing cache (one upstream fetch
    for N requests); other paths stream through the proxy verbatim; every
    request lands in the app_vapi_* meters."""

    def scenario(pkg):
        async def main():
            up = pkg.Upstream()
            await up.start()
            reg = pkg.Registry()
            router = _mk_router(pkg, up.addr, registry=reg)
            await router.start()
            try:
                out = [await _request("aiohttp", "GET",
                                      router.addr + "/eth/v1/config/spec")
                       for _ in range(5)]
                out.append(await _request(
                    "http1", "POST", router.addr + "/eth/v1/node/peers",
                    json_body={"x": [1, 2]}))
                out.append(await _request(
                    "aiohttp", "GET",
                    router.addr + "/eth/v1/config/spec?x=1"))
            finally:
                await router.stop()
                await up.stop()
            return (out, up.calls, dict(router.requests), router.proxied,
                    _families(reg.render()))

        return asyncio.run(main())

    j, t = both(scenario)
    # the series equal but for the latency histogram's buckets
    assert t[:4] == j[:4]
    fams = [f for f in t[4] if "_bucket" not in f]
    assert fams == [f for f in j[4] if "_bucket" not in f]
    out, calls, reqs, proxied, _ = t
    assert [s for s, _, _ in out] == [200] * 7
    assert [c[:2] for c in calls] == [
        ("GET", "/eth/v1/config/spec"), ("POST", "/eth/v1/node/peers"),
        ("GET", "/eth/v1/config/spec")]
    assert calls[1][3] == json.dumps({"x": [1, 2]})
    assert reqs == {("metadata", "2xx"): 6, ("submit", "2xx"): 1}
    assert any("app_vapi_requests_total" in f for f in fams)
    assert any("app_vapi_request_seconds" in f for f in fams)


def test_vapi_attestation_data_coalesced():
    """N VCs awaiting the same (slot, committee) attestation data share
    ONE DutyDB wait through the attached serving cache."""

    def scenario(pkg):
        async def main():
            vapi = pkg.ValidatorAPI(share_idx=1, pubshare_by_group={},
                                    fork_version=FORK)
            cache = pkg.serving.SingleFlightCache()
            vapi.attach_serving_cache(cache, ttl=64.0)
            gate = asyncio.Event()
            calls = []

            async def await_att(slot, ci):
                calls.append((slot, ci))
                await gate.wait()
                return {"slot": slot, "ci": ci}

            vapi.register_await_attestation(await_att)
            tasks = [asyncio.ensure_future(vapi.attestation_data(9, 2))
                     for _ in range(8)]
            await asyncio.sleep(0)
            gate.set()
            return calls, await asyncio.gather(*tasks), cache.stats()

        return asyncio.run(main())

    j, t = both(scenario)
    assert t == j
    calls, results, _ = t
    assert calls == [(9, 2)]
    assert all(r == {"slot": 9, "ci": 2} for r in results)


# ---------------------------------------------------------------------------
# MultiBeaconClient per-node metrics
# ---------------------------------------------------------------------------


def test_multi_beacon_client_exports_node_metrics():
    def scenario(pkg):
        async def main():
            bmock = pkg.BeaconMock(slot_duration=1.0, slots_per_epoch=8)
            server = pkg.BeaconMockServer(bmock)
            await server.start()
            reg = pkg.Registry()
            multi = pkg.MultiBeaconClient.from_urls([server.addr],
                                                    timeout=5.0)
            multi.bind_registry(reg)
            try:
                genesis = await multi.genesis_time()
                await multi.spec()
            finally:
                await multi.close()
                await server.stop()
            ok = reg.render().replace(server.addr, "URL")
            reg2 = pkg.Registry()
            dead = pkg.MultiBeaconClient([pkg.BeaconClient(
                "http://127.0.0.1:1", timeout=1.0)])
            dead.bind_registry(reg2)
            try:
                await dead.genesis_time()
                raised = False
            except Exception:
                raised = True
            await dead.close()
            return (genesis == pytest.approx(bmock.genesis), raised,
                    [f for f in _families(ok) if "_bucket" not in f],
                    'result="error"' in reg2.render())

        return asyncio.run(main())

    j, t = both(scenario)
    assert t == j
    assert t[0] and t[1] and t[3]
    assert any('result="ok"' in f and "URL" in f for f in t[2])


# ---------------------------------------------------------------------------
# The serving arms (bench.py's, at small counts)
# ---------------------------------------------------------------------------


def test_bench_serving_coalesce_and_shed_arms():
    """bench.py's serving arms and the port's (`testutil.serving_load`) at
    16 VCs × 2 rounds: the same requests and upstream fetches, ≥ 5× fewer
    fetches than requests, no 503 in the coalesce arm; the overload arm
    sheds with Retry-After in both, the rest served."""
    jco, jov = bench._run_serving_configs(n_vc=16, rounds=2)

    async def arms():
        return (await serving_load.coalesce_arm(16, 2),
                await serving_load.overload_arm())

    tco, tov = asyncio.run(arms())
    for key in ("config", "clients", "rounds", "requests",
                "upstream_fetches", "shed"):
        assert tco[key] == jco[key], key
    assert tco["coalesce_ratio"] == pytest.approx(jco["coalesce_ratio"],
                                                  abs=0.05)
    assert tco["coalesce_ratio"] >= 5.0 and tco["upstream_fetches"] == 3
    assert tco["rps"] > 0 and tco["p99_ms"] > 0
    for ep, st in tco["per_endpoint"].items():
        assert {k: st[k] for k in ("hits", "misses", "coalesced")} == {
            k: jco["per_endpoint"][ep][k]
            for k in ("hits", "misses", "coalesced")}, ep
    for key in ("config", "clients", "limit", "queue", "requests"):
        assert tov[key] == jov[key], key
    assert tov["shed"] > 0 and jov["shed"] > 0 and jov["retry_after_seen"]
    assert tov["served"] + tov["shed"] == tov["requests"] == 32
    assert tov["retry_after"] == ["1"]
