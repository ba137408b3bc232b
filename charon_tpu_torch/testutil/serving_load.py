"""HTTP load on the validator-API serving layer: the port's counterpart of
the root ``bench.py``'s two serving arms (`_run_serving_configs`), over
the port's own HTTP stack (`app/http1.py`): a swarm of HTTP clients
against a live `VapiRouter` reverse-proxying the HTTP beacon mock.

- **coalesce** (nominal): `n_vc` concurrent VCs × `rounds` rounds of the
  shared duty-data reads (spec, attester duties, validators snapshot),
  the upstream's duties answer delayed `upstream_latency` seconds.  The
  single-flight cache must collapse the fan-in to a handful of upstream
  fetches — ≥ 5× fewer than the requests — and the swarm sits below the
  admission bound, so ZERO 503s are allowed.
- **overload**: the duties class pinned to 2 concurrent + 2 queued over a
  50 ms-slow upstream while 32 clients hit DISTINCT epochs (defeating the
  cache).  Admission control must shed with 503 + Retry-After instead of
  piling latency.

Each arm raises AssertionError when its rule fails and returns its
counts, requests a second and p50/p99 latencies (all endpoints and by
endpoint).  The latencies are host-clock seconds of this process.
"""

from __future__ import annotations

import asyncio
import time

from ..app.http1 import HTTPClient
from ..app.router import VapiRouter
from ..app.serving import ServingConfig
from ..core.types import pubkey_from_bytes
from ..core.validatorapi import ValidatorAPI
from .beaconmock import BeaconMock
from .beaconmock_http import BeaconMockServer

#: injected upstream latency of the coalesce arm (its coalesce window)
UPSTREAM_LAT = 0.02
#: the overload arm's upstream latency, clients and admission bound
OVERLOAD_LAT, OVERLOAD_CLIENTS, OVERLOAD_LIMIT = 0.05, 32, (2, 2)


def _percentile(sorted_times: list, q: float) -> float:
    return sorted_times[min(len(sorted_times) - 1,
                            int(len(sorted_times) * q))]


async def _stack(serving_config: ServingConfig, latency: float):
    bmock = BeaconMock(slot_duration=1.0, slots_per_epoch=8)
    for i in range(4):
        bmock.add_validator(pubkey_from_bytes(
            bytes([0xC0, i + 1]) + bytes(46)))

    async def _stall(*_a):
        await asyncio.sleep(latency)
        return None          # fall through to the default handler

    bmock.overrides["attester_duties"] = _stall
    server = BeaconMockServer(bmock)
    await server.start()
    vapi = ValidatorAPI(share_idx=1, pubshare_by_group={},
                        fork_version=bytes(4))
    router = VapiRouter(vapi, server.addr, serving_config=serving_config)
    await router.start()
    return server, router


async def coalesce_arm(n_vc: int = 64, rounds: int = 5,
                       upstream_latency: float = UPSTREAM_LAT) -> dict:
    server, router = await _stack(ServingConfig(), upstream_latency)
    lat: dict[str, list] = {"metadata": [], "duties": [], "validators": []}
    statuses: list[int] = []
    reqs = (("metadata", "GET", "/eth/v1/config/spec", None),
            ("duties", "POST", "/eth/v1/validator/duties/attester/0",
             ["0", "1", "2", "3"]),
            ("validators", "POST", "/eth/v1/beacon/states/head/validators",
             {"ids": ["0", "1", "2", "3"]}))

    async def one_vc():
        client = HTTPClient(timeout=30.0)
        try:
            for _ in range(rounds):
                for ep, method, path, body in reqs:
                    t0 = time.perf_counter()
                    resp = await client.request(method, router.addr + path,
                                                json_body=body)
                    statuses.append(resp.status)
                    lat[ep].append(time.perf_counter() - t0)
        finally:
            await client.close()

    try:
        t0 = time.perf_counter()
        await asyncio.gather(*[one_vc() for _ in range(n_vc)])
        wall = time.perf_counter() - t0
    finally:
        await router.stop()
        await server.stop()
    upstream = len(server.requests)
    total = len(statuses)
    stats = router.cache.stats()
    assert all(st == 200 for st in statuses), \
        f"non-200 under the admission bound: {sorted(set(statuses))}"
    shed = sum(router.admission.shed.values())
    assert shed == 0, f"{shed} sheds below the admission bound"
    ratio = total / max(1, upstream)
    assert ratio >= 5.0, \
        f"coalesce ratio {ratio:.1f}x < 5x ({upstream} upstream " \
        f"fetches for {total} client requests)"
    times = sorted(t for ts in lat.values() for t in ts)
    return {
        "config": f"serving-coalesce-{n_vc}vc",
        "clients": n_vc, "rounds": rounds, "requests": total,
        "upstream_latency_ms": upstream_latency * 1e3,
        "wall_ms": wall * 1e3,
        "rps": total / wall,
        "p50_ms": _percentile(times, 0.50) * 1e3,
        "p99_ms": _percentile(times, 0.99) * 1e3,
        "per_endpoint": {
            ep: {"p50_ms": _percentile(sorted(ts), 0.50) * 1e3,
                 "p99_ms": _percentile(sorted(ts), 0.99) * 1e3,
                 **stats.get(ep, {})}
            for ep, ts in lat.items()},
        "upstream_fetches": upstream,
        "coalesce_ratio": ratio,
        "shed": 0,
    }


async def overload_arm(clients: int = OVERLOAD_CLIENTS,
                       limit: tuple[int, int] = OVERLOAD_LIMIT,
                       upstream_latency: float = OVERLOAD_LAT) -> dict:
    cfg = ServingConfig(admission_limits={"duties": limit}, retry_after=1.0)
    server, router = await _stack(cfg, upstream_latency)
    results: list[tuple[int, str | None, float]] = []

    async def one_shot(k):
        client = HTTPClient(timeout=30.0)
        try:
            t0 = time.perf_counter()
            resp = await client.post(
                router.addr + f"/eth/v1/validator/duties/attester/{k}",
                ["0"])
            results.append((resp.status, resp.headers.get("retry-after"),
                            time.perf_counter() - t0))
        finally:
            await client.close()

    try:
        t0 = time.perf_counter()
        await asyncio.gather(*[one_shot(k) for k in range(clients)])
        wall = time.perf_counter() - t0
    finally:
        await router.stop()
        await server.stop()
    shed = sum(router.admission.shed.values())
    codes = [st for st, _, _ in results]
    n503 = codes.count(503)
    assert n503 > 0 and shed == n503, f"overload arm never shed ({codes})"
    assert all(ra is not None for st, ra, _ in results if st == 503), \
        "503 without Retry-After"
    assert all(st in (200, 503) for st in codes), f"unexpected {codes}"
    by_code = {c: sorted(t for st, _, t in results if st == c)
               for c in (200, 503)}
    return {
        "config": "serving-overload-shed",
        "clients": clients, "limit": limit[0], "queue": limit[1],
        "upstream_latency_ms": upstream_latency * 1e3,
        "wall_ms": wall * 1e3,
        "rps": len(codes) / wall,
        "requests": len(codes),
        "served": codes.count(200),
        "shed": n503,
        "shed_rate": n503 / len(codes),
        "retry_after": sorted({ra for st, ra, _ in results if st == 503}),
        "upstream_fetches": len(server.requests),
        "per_code": {str(c): {"p50_ms": _percentile(ts, 0.50) * 1e3,
                              "p99_ms": _percentile(ts, 0.99) * 1e3}
                     for c, ts in by_code.items() if ts},
    }


def run_serving_arms(n_vc: int = 64, rounds: int = 5) -> list[dict]:
    """Both arms in one event loop, coalesce first."""

    async def arms():
        return [await coalesce_arm(n_vc, rounds), await overload_arm()]

    return asyncio.run(arms())
