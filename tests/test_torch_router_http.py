"""The validator API over HTTP on the port: VCs (`testutil.httpvc`) reach
DV nodes through `app.router.VapiRouter`, the nodes reach one HTTP beacon
mock, and every attestation and block the mock receives carries the
oracle's bytes (the group secret's signature, insecure-test scheme).

(i)   the counterpart of tests/test_http.py's `test_http_simnet`: four port
      `Node`s, 3-of-4, each behind a port router, with port VCs over real
      sockets; the VCs' genesis and spec queries ride the reverse proxy;
(ii)  the JAX package's aiohttp VC against the port's routers, and the
      port's VC against the JAX package's routers (over JAX nodes): the
      same bytes at the mock;
(iii) `teku_proposer_config` from both routers, equal;
(iv)  the port's proxy streams a response body chunk by chunk.
"""

import asyncio
import json
import time
import types

import aiohttp
import pytest
import torch

torch.set_num_threads(1)

from charon_tpu.app import node as j_node  # noqa: E402
from charon_tpu.app import router as j_router  # noqa: E402
from charon_tpu.core import leadercast as j_lc  # noqa: E402
from charon_tpu.core import parsigex as j_psx  # noqa: E402
from charon_tpu.core import validatorapi as j_vapi  # noqa: E402
from charon_tpu.core.types import pubkey_from_bytes as j_pk  # noqa: E402
from charon_tpu.eth2util import beacon_client as j_bc  # noqa: E402
from charon_tpu.tbls import api as japi  # noqa: E402
from charon_tpu.testutil import beaconmock as j_bmock  # noqa: E402
from charon_tpu.testutil import beaconmock_http as j_bmock_http  # noqa: E402
from charon_tpu.testutil import cluster as j_cluster  # noqa: E402
from charon_tpu.testutil import httpvc as j_httpvc  # noqa: E402
from charon_tpu_torch.app import http1  # noqa: E402
from charon_tpu_torch.app import node as t_node  # noqa: E402
from charon_tpu_torch.app import router as t_router  # noqa: E402
from charon_tpu_torch.core import leadercast as t_lc  # noqa: E402
from charon_tpu_torch.core import parsigex as t_psx  # noqa: E402
from charon_tpu_torch.core import validatorapi as t_vapi  # noqa: E402
from charon_tpu_torch.core.types import pubkey_from_bytes as t_pk  # noqa
from charon_tpu_torch.eth2util import beacon_client as t_bc  # noqa: E402
from charon_tpu_torch.eth2util.signing import (DomainName,  # noqa: E402
                                               signing_root)
from charon_tpu_torch.tbls import api as tbls  # noqa: E402
from charon_tpu_torch.testutil import beaconmock as t_bmock  # noqa: E402
from charon_tpu_torch.testutil import beaconmock_http as t_bmock_http  # noqa
from charon_tpu_torch.testutil import cluster as t_cluster  # noqa: E402
from charon_tpu_torch.testutil import httpvc as t_httpvc  # noqa: E402

SLOT_DUR, SPE = 0.25, 4
FORK = bytes(4)

JAX = types.SimpleNamespace(
    Node=j_node.Node, NodeConfig=j_node.NodeConfig, Router=j_router.VapiRouter,
    LeaderCast=j_lc.LeaderCast, MemTransportNetwork=j_lc.MemTransportNetwork,
    MemParSigExNetwork=j_psx.MemParSigExNetwork, pk=j_pk,
    BeaconClient=j_bc.BeaconClient, BeaconMock=j_bmock.BeaconMock,
    BeaconMockServer=j_bmock_http.BeaconMockServer,
    new_cluster=j_cluster.new_cluster_for_test,
    ValidatorAPI=j_vapi.ValidatorAPI, VC=j_httpvc.HttpValidatorClient)
PORT = types.SimpleNamespace(
    Node=t_node.Node, NodeConfig=t_node.NodeConfig, Router=t_router.VapiRouter,
    LeaderCast=t_lc.LeaderCast, MemTransportNetwork=t_lc.MemTransportNetwork,
    MemParSigExNetwork=t_psx.MemParSigExNetwork, pk=t_pk,
    BeaconClient=t_bc.BeaconClient, BeaconMock=t_bmock.BeaconMock,
    BeaconMockServer=t_bmock_http.BeaconMockServer,
    new_cluster=t_cluster.new_cluster_for_test,
    ValidatorAPI=t_vapi.ValidatorAPI, VC=t_httpvc.HttpValidatorClient)


@pytest.fixture(autouse=True)
def insecure_scheme():
    tbls.set_scheme("insecure-test")
    japi.set_scheme("insecure-test")
    yield
    tbls.set_scheme("bls")
    japi.set_scheme("bls")


def run_http_cluster(nodes_pkg, vc_pkg, n: int, t: int, v: int):
    """n `nodes_pkg` nodes, each behind a `nodes_pkg` router, one
    `vc_pkg` VC a node over real sockets, one HTTP beacon mock, until an
    attestation and a block have arrived → (cluster, mock, routers)."""
    cluster = nodes_pkg.new_cluster(t, n, v)

    async def main():
        bmock = nodes_pkg.BeaconMock(slot_duration=SLOT_DUR,
                                     slots_per_epoch=SPE)
        for val in cluster.validators:
            bmock.add_validator(val.group_pubkey)
        server = nodes_pkg.BeaconMockServer(bmock)
        await server.start()
        pubshares_by_peer = {i: cluster.pubshare_map(i)
                             for i in range(1, n + 1)}
        psx_net = nodes_pkg.MemParSigExNetwork()
        lc_net = nodes_pkg.MemTransportNetwork()
        by_index = {x.index: nodes_pkg.pk(x.pubkey)
                    for x in bmock.validators.values()}

        async def pubkey_by_index(idx):
            return by_index[idx]

        nodes, routers, vcs, clients = [], [], [], []
        for idx in range(1, n + 1):
            cl = nodes_pkg.BeaconClient(server.addr)
            clients.append(cl)
            cfg = nodes_pkg.NodeConfig(share_idx=idx, threshold=t,
                                       pubshares_by_peer=pubshares_by_peer,
                                       fork_version=FORK)
            node = nodes_pkg.Node(
                cfg, cl, consensus=nodes_pkg.LeaderCast(lc_net, idx - 1, n),
                parsigex=psx_net.join(), slots_per_epoch=SPE,
                genesis_time=bmock.genesis, slot_duration=SLOT_DUR)
            router = nodes_pkg.Router(node.vapi, server.addr,
                                      pubkey_by_index=pubkey_by_index)
            await router.start()
            vcs.append(vc_pkg.VC(router.addr, {
                val.pubshares[idx]: val.share_privkeys[idx]
                for val in cluster.validators}))
            nodes.append(node)
            routers.append(router)
        for node in nodes:
            node.start()
        tasks = [asyncio.ensure_future(vc.run(max_slots=4 * SPE))
                 for vc in vcs]
        deadline = time.time() + 4 * SPE * SLOT_DUR + 5.0
        while time.time() < deadline:
            await asyncio.sleep(0.1)
            if bmock.attestations and bmock.blocks:
                await asyncio.sleep(2 * SLOT_DUR)
                break
        for vc in vcs:
            vc.stop()
        for node in nodes:
            node.stop()
        for task in tasks:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        for r in routers:
            await r.stop()
        for c in clients:
            await c.close()
        await server.stop()
        return bmock, routers

    bmock, routers = asyncio.run(main())
    return cluster, bmock, routers


def oracle_check(cluster, bmock) -> int:
    """Every attestation and block at the mock is byte-equal to the
    signature of the validator's group secret (its shares recombined) →
    the number checked."""
    secrets = {bytes(v.tss.group_pubkey): tbls.combine_shares(
        dict(list(v.share_privkeys.items())[:cluster.threshold]))
        for v in cluster.validators}
    checked = 0
    for att in bmock.attestations:
        root = signing_root(DomainName.BEACON_ATTESTER,
                            att.data.hash_tree_root(), FORK)
        assert att.signature in {tbls.sign(sk, root)
                                 for sk in secrets.values()}
        checked += 1
    for blk in bmock.blocks:
        root = signing_root(DomainName.BEACON_PROPOSER,
                            blk.message.hash_tree_root(), FORK)
        assert blk.signature in {tbls.sign(sk, root)
                                 for sk in secrets.values()}
        checked += 1
    return checked


def test_http_simnet_four_port_nodes():
    """Four port nodes (3-of-4) behind port routers, port VCs over HTTP:
    attestations and blocks arrive threshold-aggregated under the group
    keys with the oracle's bytes; the reverse proxy served the VCs'
    genesis and spec queries, and the router mapped pubshares."""
    cluster, bmock, routers = run_http_cluster(PORT, PORT, 4, 3, 2)
    assert bmock.attestations, "no attestations over the HTTP stack"
    assert bmock.blocks, "no blocks over the HTTP stack"
    assert oracle_check(cluster, bmock) >= 2
    assert all(any("/eth/v1/beacon/genesis" in p for p in r.proxied)
               for r in routers)
    for r in routers:
        assert r.requests.get(("attestation_data", "2xx"), 0) > 0
        assert r.requests.get(("submit", "2xx"), 0) > 0
        assert r.requests.get(("validators", "2xx"), 0) == 1
        assert not any(code == "5xx" for _, code in r.requests)


@pytest.mark.parametrize("nodes_pkg,vc_pkg", [(PORT, JAX), (JAX, PORT)],
                         ids=["jax_vc_port_router", "port_vc_jax_router"])
def test_vcs_and_routers_across_packages(nodes_pkg, vc_pkg):
    """The JAX package's aiohttp VC through the port's routers, and the
    port's `http1` VC through the JAX package's routers: both sides of
    the wire interoperate, and every duty at the mock carries the
    oracle's bytes."""
    cluster, bmock, routers = run_http_cluster(nodes_pkg, vc_pkg, 3, 2, 2)
    assert bmock.attestations and bmock.blocks
    assert oracle_check(cluster, bmock) >= 2
    assert any("/eth/v1/config/spec" in p for r in routers for p in r.proxied)


def test_teku_proposer_config():
    """Teku proposer-config endpoint maps pubshares to proposer settings
    (reference: core/validatorapi/teku.go): the same body from both
    routers, through either client."""

    def scenario(pkg):
        async def main():
            cluster = pkg.new_cluster(2, 3, 2)
            bmock = pkg.BeaconMock()
            server = pkg.BeaconMockServer(bmock)
            await server.start()
            vapi = pkg.ValidatorAPI(share_idx=1,
                                    pubshare_by_group=cluster.pubshare_map(1),
                                    fork_version=FORK)
            router = pkg.Router(vapi, server.addr,
                                fee_recipient="0x" + "ab" * 20)
            await router.start()
            try:
                async with aiohttp.ClientSession() as s:
                    async with s.get(router.addr
                                     + "/teku_proposer_config") as resp:
                        first = resp.status, await resp.json()
                c = http1.HTTPClient()
                resp = await c.get(router.addr + "/teku_proposer_config")
                await c.close()
                second = resp.status, resp.json()
            finally:
                await router.stop()
                await server.stop()
            shares = {"0x" + v.pubshares[1].hex() for v in cluster.validators}
            return first, second, shares

        return asyncio.run(main())

    j, t = scenario(JAX), scenario(PORT)
    assert t == j
    (status, body), second, shares = t
    assert status == 200 and second == (status, body)
    assert set(body["proposer_config"]) == shares
    assert body["default_config"]["fee_recipient"] == "0x" + "ab" * 20
    assert json.dumps(body, sort_keys=True) == json.dumps(j[0][1],
                                                          sort_keys=True)


def test_proxy_streams_the_body_chunk_by_chunk():
    """The port's proxy streams, as the JAX one does: a client of the
    router (aiohttp here) reads the upstream's first chunk while the
    upstream still holds the rest back; `http1`'s ``*`` and
    ``{name:regex}`` routes serve the upstream; a streamed response of
    1 MiB arrives whole, chunked, through the router."""

    async def main():
        release = asyncio.Event()
        big = bytes(range(256)) * 4096

        async def stream(request):
            async def body():
                yield b"first:" + request.match_info["rest"].encode()
                await release.wait()
                for i in range(0, len(big), 50_000):
                    yield big[i:i + 50_000]
            return http1.Response(200, headers={
                "Content-Type": "application/octet-stream",
                "X-Upstream": "yes"}, stream=body())

        upstream = http1.HTTPServer()
        upstream.add_route("*", "/eth/v1/debug/{rest:.*}", stream)
        await upstream.start()
        vapi = t_vapi.ValidatorAPI(share_idx=1, pubshare_by_group={},
                                   fork_version=FORK)
        router = t_router.VapiRouter(vapi, upstream.addr)
        await router.start()
        try:
            async with aiohttp.ClientSession() as s:
                async with s.get(router.addr
                                 + "/eth/v1/debug/a/b?x=1") as resp:
                    first = await resp.content.readexactly(9)
                    release.set()
                    rest = await resp.read()
                    headers = resp.headers.copy()   # case-insensitive
        finally:
            await router.stop()
            await upstream.stop()
        return first, rest, headers, router.proxied

    first, rest, headers, proxied = asyncio.run(main())
    assert first == b"first:a/b"
    assert rest == bytes(range(256)) * 4096
    assert headers["Transfer-Encoding"] == "chunked"
    assert headers["X-Upstream"] == "yes"
    assert headers["Content-Type"] == "application/octet-stream"
    assert proxied == ["GET /eth/v1/debug/a/b"]


def test_proxied_head_and_empty_statuses_keep_the_connection():
    """A proxied HEAD, 204 and 304 carry no body, so the next response
    on the same keep-alive connection parses: one raw connection to each
    router sends HEAD, GET, GET (204), GET, GET (304), GET through the
    reverse proxy to an aiohttp upstream; the port's answers equal the
    JAX router's, and no byte is left over on either connection."""
    from aiohttp import web

    async def version(request):
        return web.json_response({"data": {"version": "mock/v1"}})

    async def empty(request):
        return web.Response(status=int(request.match_info["code"]))

    script = [("HEAD", "/eth/v1/node/version"),
              ("GET", "/eth/v1/node/version"),
              ("GET", "/eth/v1/node/empty/204"),
              ("GET", "/eth/v1/node/version"),
              ("GET", "/eth/v1/node/empty/304"),
              ("GET", "/eth/v1/node/version")]

    async def exchange(reader, writer, method, path):
        writer.write(f"{method} {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        await writer.drain()
        status = int((await reader.readline()).split()[1])
        headers = await http1._read_headers(reader)
        body = b""
        if method != "HEAD" and status not in (204, 304):
            body = await http1._read_body(reader, headers, to_eof=False)
        framing = sorted(k for k in ("content-length", "transfer-encoding")
                         if k in headers)
        return status, body, framing if body == b"" else None

    def scenario(pkg):
        async def main():
            up = web.Application()
            up.router.add_get("/eth/v1/node/version", version)
            up.router.add_get("/eth/v1/node/empty/{code}", empty)
            runner = web.AppRunner(up)
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            addr = "http://127.0.0.1:%d" % runner.addresses[0][1]
            vapi = pkg.ValidatorAPI(share_idx=1, pubshare_by_group={},
                                    fork_version=FORK)
            router = pkg.Router(vapi, addr)
            await router.start()
            host, port = router.addr.rsplit("/", 1)[1].split(":")
            reader, writer = await asyncio.open_connection(host, int(port))
            try:
                answers = [await exchange(reader, writer, m, p)
                           for m, p in script]
                try:
                    left = await asyncio.wait_for(reader.read(64), 0.3)
                except asyncio.TimeoutError:
                    left = b""
            finally:
                writer.close()
                await router.stop()
                await runner.cleanup()
            return answers, left, router.proxied

        return asyncio.run(main())

    j, t = scenario(JAX), scenario(PORT)
    answers, left, proxied = t
    assert [a[0] for a in answers] == [200, 200, 204, 200, 304, 200]
    assert json.loads(answers[1][1]) == {"data": {"version": "mock/v1"}}
    assert answers[2][2] == answers[4][2] == []
    assert left == b""
    assert proxied == [f"{m} {p}" for m, p in script]
    assert t == j
