"""The node as a process, on the port: `python -m charon_tpu_torch create
cluster`, then `App`s (or `run` subprocesses) booted from the lock,
talking over the authenticated TCP mesh and to an HTTP beacon mock.

(i)   the counterpart of tests/test_app_run.py: the port's CLI writes a
      3-node, 2-of-3 cluster; three port `App`s run QBFT over the mesh
      against the port's `BeaconMockServer` (insecure-test scheme, 0.5 s
      slots); duties reach the mock under the group keys, and monitoring,
      tracker, peerinfo, infosync and the shared BatchVerifier all work.
(ii)  a mixed cluster from one lock: two port `App`s and one JAX `App`
      decide, exchange partials and broadcast together; every aggregate
      the mock holds for one (duty, validator) is the same bytes, whichever
      package's node broadcast it, and verifies under the group key.
(iii) the counterpart of tests/test_smoke_multiprocess.py: three
      `python -m charon_tpu_torch run` subprocesses, readiness-gated,
      one of them sent SIGTERM, the other two go on attesting; every
      process exits 0.
(iv)  `run` with the bls scheme and the card's backend on a machine with
      no card exits non-zero and names the missing device: nothing falls
      back to the CPU; under real BLS the App's validator mock signs in a
      spawned process, with the bytes of signing inline.
(v)   the validator API over HTTP: two port `App`s and one JAX `App` from
      one lock, each serving its router at the address
      ``--validator-api-address`` sets (`RunConfig.vapi_port`), with no
      validator mock: HTTP VCs (the port's for the port nodes, the JAX
      package's for the JAX node) sign every attestation and block through
      the routers, and every node broadcasts the same bytes; and what the
      App wires around them, as the JAX App does: the caching beacon
      client, the router in the lifecycle, the OTLP and Loki sinks from
      the environment and the auto-profiler on the slot budget's hook.
"""

import asyncio
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

from charon_tpu_torch.app.run import App, RunConfig
from charon_tpu_torch.cluster.definition import load_json, lock_from_json
from charon_tpu_torch.cmd import main as cli_main
from charon_tpu_torch.core.types import pubkey_from_bytes
from charon_tpu_torch.eth2util.signing import DomainName, signing_root
from charon_tpu_torch.tbls import api as tbls
from charon_tpu_torch.testutil.beaconmock import BeaconMock
from charon_tpu_torch.testutil.beaconmock_http import BeaconMockServer

ROOT = Path(__file__).resolve().parent.parent
FORK = bytes(4)


def free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def free_base_port(n: int) -> int:
    """A base port whose n consecutive ports are free now."""
    for _ in range(50):
        base = free_ports(1)[0]
        if base + n >= 65535:
            continue
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port range")


@pytest.fixture(autouse=True)
def insecure_scheme():
    tbls.set_scheme("insecure-test")
    yield
    tbls.set_scheme("bls")


#: how long a test waits for what it asserts.  The Apps run on wall-clock
#: slots: on a host whose cores the suite's other workers share, their
#: duties come late, not wrong, so the tests poll for the state they then
#: assert; the limit only keeps a broken run from hanging
WAIT_LIMIT = 240.0
#: an App's lifecycle stop: the JAX App's aiohttp router waits up to 60 s
#: for a validator-API handler still awaiting a duty that will never be
#: decided once the nodes stop
STOP_LIMIT = 90.0


async def wait_until(cond, limit: float = WAIT_LIMIT) -> bool:
    """Poll `cond()` every 0.1 s until it holds (→ True) or `limit`
    seconds pass (→ False)."""
    deadline = time.time() + limit
    while time.time() < deadline:
        if cond():
            return True
        await asyncio.sleep(0.1)
    return False


async def stop_vcs(vcs, tasks) -> None:
    """Stop the HTTP VCs and let each finish the duty it has in flight
    while the nodes still serve it (a request cancelled mid-flight leaves
    its handler waiting on the node), cancelling what is left after 30 s."""
    for vc in vcs:
        vc.stop()
    await asyncio.wait(tasks, timeout=30)
    for task in tasks:
        task.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)


def create_cluster(tmp_path, n: int, t: int, m: int) -> tuple[str, object]:
    cluster_dir = str(tmp_path / "cluster")
    assert cli_main(["create", "cluster", "--name", "e2e",
                     "--nodes", str(n), "--threshold", str(t),
                     "--num-validators", str(m),
                     "--cluster-dir", cluster_dir,
                     "--base-port", str(free_base_port(n)),
                     "--tbls-scheme", "insecure-test"]) == 0
    lock = lock_from_json(load_json(os.path.join(cluster_dir, "node0",
                                                 "cluster-lock.json")))
    return cluster_dir, lock


def node_cfg(cluster_dir: str, i: int, addr: str, cls=RunConfig):
    node_dir = os.path.join(cluster_dir, f"node{i}")
    return cls(lock_file=os.path.join(node_dir, "cluster-lock.json"),
               identity_key_file=os.path.join(node_dir,
                                              "charon-enr-private-key"),
               beacon_urls=[addr], simnet_vmock=True,
               keystore_dir=os.path.join(node_dir, "validator_keys"),
               ping_interval=0.5, peerinfo_interval=0.5)


def check_group_signatures(bmock, lock) -> None:
    for att in bmock.attestations:
        root = signing_root(DomainName.BEACON_ATTESTER,
                            att.data.hash_tree_root(), FORK)
        assert any(tbls.verify(v.public_key, root, att.signature)
                   for v in lock.validators), "bad group signature"


def test_cli_create_cluster_and_run(tmp_path):
    # 0.5 s slots, where the JAX package's test takes 0.25 s: the port's
    # pure-Python Ed25519 signs and verifies every QBFT message of three
    # Apps on one process's loop (PERF.md: the mesh's crypto cost)
    n, t, m, slot, spe = 3, 2, 2, 0.5, 4
    cluster_dir, lock = create_cluster(tmp_path, n, t, m)
    for i in range(n):
        node_dir = os.path.join(cluster_dir, f"node{i}")
        for name in ("cluster-lock.json", "charon-enr-private-key",
                     "deposit-data.json",
                     os.path.join("validator_keys", f"keystore-{m - 1}.json")):
            assert os.path.exists(os.path.join(node_dir, name)), name

    async def main():
        bmock = BeaconMock(slot_duration=slot, slots_per_epoch=spe)
        for v in lock.validators:
            bmock.add_validator(pubkey_from_bytes(v.public_key))
        server = BeaconMockServer(bmock)
        await server.start()
        apps = [App(node_cfg(cluster_dir, i, server.addr)) for i in range(n)]
        runners = []
        for app in apps:
            await app.setup()
            runners.append(asyncio.ensure_future(app.life.run()))
        try:
            if await wait_until(
                    lambda: (bmock.attestations and bmock.blocks
                             and bmock.sync_messages
                             and bmock.sync_contributions
                             and any(a.infosync._results for a in apps)
                             and any(r.success for a in apps
                                     for r in a.tracker.reports)
                             and all(a.peerinfo.peer_versions
                                     for a in apps)
                             and all(a.verifier.launches > 0
                                     for a in apps))):
                await asyncio.sleep(3 * slot)  # settle + GC

            # duties reached the BN under the group keys, the sync family
            # across the real mesh
            assert bmock.attestations and bmock.blocks
            assert bmock.sync_messages and bmock.sync_contributions
            check_group_signatures(bmock, lock)

            # monitoring: /readyz ok, /metrics, /debug/qbft, /debug/memory
            port = apps[0].monitoring.port

            def get(path):
                resp = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=5)
                return resp.headers.get("Content-Type"), resp.read()

            # readiness needs every peer's ping fresh (1.5 s): on a loaded
            # host a ping can come late, so it is waited for like the duties
            deadline = time.time() + WAIT_LIMIT
            while not await asyncio.to_thread(_readyz, port) \
                    and time.time() < deadline:
                await asyncio.sleep(0.1)
            _, body = await asyncio.to_thread(get, "/readyz")
            assert body == b"ok"
            assert (await asyncio.to_thread(get, "/livez"))[1] == b"ok"
            ctype, metrics = await asyncio.to_thread(get, "/metrics")
            metrics = metrics.decode()
            assert ctype == "text/plain; version=0.0.4"
            for family in ("app_peers", "core_bcast_delay_seconds",
                           "core_verify_launches_total",
                           "core_verify_launches_by_path",
                           "app_p2p_peer_sent_bytes_total",
                           "app_p2p_ping_rtt_seconds", "app_boot_seconds",
                           "core_qbft_decided_total",
                           "core_slot_phase_seconds"):
                assert family in metrics, family
            assert 'path="insecure-test"' in metrics
            all_metrics = [metrics] + [
                (await asyncio.to_thread(
                    lambda p=a.monitoring.port: urllib.request.urlopen(
                        f"http://127.0.0.1:{p}/metrics", timeout=5
                    ).read())).decode() for a in apps[1:]]
            assert any("charon_tpu_tracker_participation" in x
                       for x in all_metrics)
            assert any("charon_tpu_tracker_inclusion_delay_bucket" in x
                       for x in all_metrics)
            _, qdbg = await asyncio.to_thread(get, "/debug/qbft")
            qdbg = json.loads(qdbg)
            assert any(i["decided"] for i in qdbg["instances"])
            _, mem = await asyncio.to_thread(get, "/debug/memory")
            assert "verifier_launches" in json.loads(mem)
            _, enr = await asyncio.to_thread(get, "/enr")
            assert enr.decode() == lock.definition.operators[0].enr.split(
                "@")[0]

            # tracker, deadliner GC, peerinfo, infosync
            assert any(r.success for a in apps for r in a.tracker.reports)
            assert all(len(a.consensus._tasks) < 64 for a in apps)
            assert all(a.peerinfo.peer_versions for a in apps)
            assert any(a.infosync._results for a in apps)

            # one BatchVerifier serves the vapi and the inbound parsigex
            for a in apps:
                assert a.vapi._verifier is a.verifier
            assert all(a.verifier.launches > 0 for a in apps)

            # one duty's deterministic trace joins spans across nodes
            from charon_tpu_torch.app.tracing import duty_trace_id

            ok_duty = next(r.duty for a in apps for r in a.tracker.reports
                           if r.success)
            tid = duty_trace_id(ok_duty)
            assert sum(1 for a in apps if a.tracer_spans.trace(tid)) >= 2
        finally:
            for app in apps:
                app.life.stop()
            for r in runners:
                await asyncio.wait_for(r, timeout=STOP_LIMIT)
            await server.stop()

    asyncio.run(main())


def test_mixed_cluster_port_and_jax_apps_broadcast_equal_aggregates(
        tmp_path):
    """Two port nodes and one JAX node from one lock: QBFT, parsigex and
    peerinfo over one mesh, one beacon mock; every aggregate the mock holds
    for a (slot, validator) is the same bytes from every node."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from charon_tpu.app import run as jrun
    from charon_tpu.tbls import api as japi

    n, t, m, slot, spe = 3, 2, 2, 0.5, 4
    cluster_dir, lock = create_cluster(tmp_path, n, t, m)
    japi.set_scheme("insecure-test")
    try:
        async def main():
            bmock = BeaconMock(slot_duration=slot, slots_per_epoch=spe)
            for v in lock.validators:
                bmock.add_validator(pubkey_from_bytes(v.public_key))
            server = BeaconMockServer(bmock)
            await server.start()
            apps = [App(node_cfg(cluster_dir, 0, server.addr)),
                    App(node_cfg(cluster_dir, 1, server.addr)),
                    jrun.App(node_cfg(cluster_dir, 2, server.addr,
                                      jrun.RunConfig))]
            runners = []
            for app in apps:
                await app.setup()
                runners.append(asyncio.ensure_future(app.life.run()))
            try:
                if await wait_until(
                        lambda: (len({a.data.slot
                                      for a in bmock.attestations}) >= 3
                                 and len(bmock.sync_messages) >= 6
                                 and all(a.bcast.broadcast_delays
                                         for a in apps)
                                 and set(apps[2].peerinfo.peer_versions)
                                 == {0, 1}
                                 and apps[2].consensus._decided)):
                    await asyncio.sleep(2 * slot)
            finally:
                for app in apps:
                    app.life.stop()
                for r in runners:
                    await asyncio.wait_for(r, timeout=STOP_LIMIT)
                await server.stop()
            return bmock, apps

        bmock, apps = asyncio.run(main())
    finally:
        japi.set_scheme("bls")

    assert len({a.data.slot for a in bmock.attestations}) >= 3
    check_group_signatures(bmock, lock)
    by_duty: dict = {}
    for att in bmock.attestations:
        by_duty.setdefault(("att", att.data.hash_tree_root(),
                            att.aggregation_bits), set()).add(att.signature)
    for msg in bmock.sync_messages:
        by_duty.setdefault(("sync", msg.slot, msg.validator_index),
                           set()).add(msg.signature)
    assert all(len(sigs) == 1 for sigs in by_duty.values()), by_duty
    # every node, the JAX one among them, broadcast
    assert all(a.bcast.broadcast_delays for a in apps)
    # the JAX node's peerinfo saw both port peers and QBFT decided on it
    assert set(apps[2].peerinfo.peer_versions) == {0, 1}
    assert apps[2].consensus._decided


def _readyz(port: int) -> bool:
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=2)
        conn.request("GET", "/readyz")
        ok = conn.getresponse().status == 200
        conn.close()
        return ok
    except OSError:
        return False


def _http_status(port: int, path: str) -> int:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    try:
        conn.request("GET", path)
        return conn.getresponse().status
    finally:
        conn.close()


def test_smoke_subprocess_cluster(tmp_path):
    """Three `python -m charon_tpu_torch run` processes: readiness first,
    then one node sent SIGTERM; the two left keep attesting, and every
    process exits 0 with no traceback."""
    n, t, m, slot, spe = 3, 2, 1, 1.0, 8
    cluster_dir, lock = create_cluster(tmp_path, n, t, m)

    async def main():
        bmock = BeaconMock(slot_duration=slot, slots_per_epoch=spe)
        for v in lock.validators:
            bmock.add_validator(pubkey_from_bytes(v.public_key))
        server = BeaconMockServer(bmock)
        await server.start()
        mon = free_ports(n)
        vapi = free_ports(n)
        env = dict(os.environ, CHARON_TPU_TBLS_SCHEME="insecure-test",
                   OMP_NUM_THREADS="1")
        procs = []
        for i in range(n):
            node_dir = os.path.join(cluster_dir, f"node{i}")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "charon_tpu_torch", "run",
                 "--lock-file", os.path.join(node_dir, "cluster-lock.json"),
                 "--identity-key-file",
                 os.path.join(node_dir, "charon-enr-private-key"),
                 "--beacon-node-endpoints", server.addr,
                 "--monitoring-address", f"127.0.0.1:{mon[i]}",
                 "--validator-api-address", f"127.0.0.1:{vapi[i]}",
                 "--simnet-validator-mock"],
                env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE))
        outs = [None] * n
        try:
            deadline = time.time() + 90
            pending = set(range(n))
            while pending:
                for p in procs:
                    assert p.poll() is None, p.stderr.read().decode()[-3000:]
                pending = {i for i in pending if not _readyz(mon[i])}
                assert time.time() < deadline, f"never ready: {pending}"
                await asyncio.sleep(0.2)
            # each node's validator API answers at the address its flag
            # set: a proxied path and the intercepted duties path
            for i in range(n):
                for path in ("/eth/v1/node/version",
                             "/eth/v1/validator/duties/proposer/0"):
                    status = await asyncio.to_thread(
                        _http_status, vapi[i], path)
                    assert status == 200, (i, path, status)
            procs[-1].send_signal(signal.SIGTERM)
            seen = len(bmock.attestations)
            deadline = time.time() + 60
            while len(bmock.attestations) <= seen:
                assert time.time() < deadline, "no attestation after SIGTERM"
                for p in procs[:-1]:
                    assert p.poll() is None, p.stderr.read().decode()[-3000:]
                await asyncio.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.send_signal(signal.SIGTERM)
            for i, p in enumerate(procs):
                try:
                    outs[i] = await asyncio.to_thread(p.communicate,
                                                      timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    outs[i] = p.communicate()
            await server.stop()
        return bmock, procs, outs

    bmock, procs, outs = asyncio.run(main())
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
        assert b"Traceback" not in err, err.decode()[-3000:]
    assert bmock.attestations
    check_group_signatures(bmock, lock)


def test_validator_mock_signs_in_a_spawned_process():
    """Under real BLS the App's validator mock signs in a process of its
    own (spawned, as after CUDA is up): the same bytes as signing inline."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from charon_tpu_torch.testutil.validatormock import ValidatorMock

    tbls.set_scheme("bls")
    sk = tbls.int_to_privkey(0xC0FFEE)
    pk = "0x" + tbls.privkey_to_pubkey(sk).hex()
    with ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        vm = ValidatorMock(None, {pk: sk}, bytes.fromhex("01017000"),
                           genesis_validators_root=b"\x07" * 32,
                           signer=pool)
        got = asyncio.run(vm._signed(pk, DomainName.SYNC_COMMITTEE,
                                     b"\x05" * 32, 3))
    assert got == vm._sign(pk, DomainName.SYNC_COMMITTEE, b"\x05" * 32, 3)


def test_run_with_bls_and_no_card_names_the_missing_device(tmp_path):
    """The card's backend with no card: `run` exits non-zero at the lock's
    verification and says why — it never verifies on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cluster_dir = tmp_path / "cluster"
    # a real-BLS cluster of one validator (pure-Python keys and signatures)
    tbls.set_scheme("bls")
    assert cli_main(["create", "cluster", "--nodes", "3", "--threshold", "2",
                     "--num-validators", "1",
                     "--cluster-dir", str(cluster_dir),
                     "--base-port", str(free_base_port(3))]) == 0
    node_dir = cluster_dir / "node0"
    res = subprocess.run(
        [sys.executable, "-m", "charon_tpu_torch", "run",
         "--lock-file", str(node_dir / "cluster-lock.json"),
         "--identity-key-file", str(node_dir / "charon-enr-private-key"),
         "--beacon-node-endpoints", "http://127.0.0.1:9",
         "--monitoring-address", "127.0.0.1:0"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr, res.stderr[-2000:]


def test_port_and_jax_apps_attest_through_their_routers(tmp_path,
                                                         monkeypatch):
    """Two port `App`s and one JAX `App` from one lock, each serving the
    validator API at its own address (what ``--validator-api-address``
    sets), no validator mock: HTTP VCs sign with the share keys through
    the routers — the port's VC at the port nodes, the JAX package's at
    the JAX node — and every duty at the mock carries the same bytes,
    valid under the group key, from every node."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from charon_tpu.app import run as jrun
    from charon_tpu.tbls import api as japi
    from charon_tpu.testutil.httpvc import HttpValidatorClient as JVC
    from charon_tpu_torch.eth2util import keystore
    from charon_tpu_torch.testutil.httpvc import (HttpValidatorClient,
                                                  load_share_keys)

    n, t, m, slot, spe = 3, 2, 2, 0.5, 4
    cluster_dir, lock = create_cluster(tmp_path, n, t, m)
    vapi = free_ports(n)
    cfgs = []
    for i in range(n):
        cls = RunConfig if i < 2 else jrun.RunConfig
        cfg = node_cfg(cluster_dir, i, "", cls)
        cfg.simnet_vmock = False
        cfg.vapi_port = vapi[i]
        cfgs.append(cfg)
    japi.set_scheme("insecure-test")
    try:
        async def main():
            bmock = BeaconMock(slot_duration=slot, slots_per_epoch=spe)
            for v in lock.validators:
                bmock.add_validator(pubkey_from_bytes(v.public_key))
            server = BeaconMockServer(bmock)
            await server.start()
            for cfg in cfgs:
                cfg.beacon_urls = [server.addr]
            apps = [App(cfgs[0]), App(cfgs[1]), jrun.App(cfgs[2])]
            runners, vcs = [], []
            for app in apps:
                if isinstance(app, jrun.App):
                    # the JAX App's auto-profiler starts and stops
                    # jax.profiler on its loop, here the one loop of all
                    # three Apps; the port's Apps keep theirs (off the loop)
                    monkeypatch.setenv("CHARON_TPU_AUTOPROFILE", "0")
                await app.setup()
                monkeypatch.delenv("CHARON_TPU_AUTOPROFILE", raising=False)
                runners.append(asyncio.ensure_future(app.life.run()))
            for i, app in enumerate(apps):
                while not app.router.addr:
                    await asyncio.sleep(0.01)
                assert app.router.addr == f"http://127.0.0.1:{vapi[i]}"
                keys = load_share_keys(cfgs[i].keystore_dir)
                assert len(keystore.load_keys(cfgs[i].keystore_dir)) == m
                vcs.append((HttpValidatorClient if i < 2 else JVC)(
                    app.router.addr, keys))
            # the VCs run until stopped (a slot cap could end them before
            # a loaded host's cluster is through its duties)
            tasks = [asyncio.ensure_future(
                vc.run(max_slots=int(2 * WAIT_LIMIT / slot)))
                for vc in vcs]
            try:
                if await wait_until(
                        lambda: (len({a.data.slot
                                      for a in bmock.attestations}) >= 3
                                 and bmock.blocks
                                 and all(a.bcast.broadcast_delays
                                         for a in apps)
                                 and all(vc.submitted_atts > 0
                                         for vc in vcs)
                                 and all(a.router.requests.get(
                                     (ep, "2xx"), 0) > 0 for a in apps
                                     for ep in ("submit",
                                                "attestation_data")))):
                    await asyncio.sleep(2 * slot)
            finally:
                await stop_vcs(vcs, tasks)
                for app in apps:
                    app.life.stop()
                for r in runners:
                    await asyncio.wait_for(r, timeout=STOP_LIMIT)
                await server.stop()
            return bmock, apps, vcs

        bmock, apps, vcs = asyncio.run(main())
    finally:
        japi.set_scheme("bls")

    assert len({a.data.slot for a in bmock.attestations}) >= 3
    assert bmock.blocks
    check_group_signatures(bmock, lock)
    for blk in bmock.blocks:
        root = signing_root(DomainName.BEACON_PROPOSER,
                            blk.message.hash_tree_root(), FORK)
        assert any(tbls.verify(v.public_key, root, blk.signature)
                   for v in lock.validators)
    by_duty: dict = {}
    for att in bmock.attestations:
        by_duty.setdefault((att.data.hash_tree_root(),
                            att.aggregation_bits), set()).add(att.signature)
    assert all(len(sigs) == 1 for sigs in by_duty.values()), by_duty
    # every node broadcast; every VC's submissions went through its router
    assert all(a.bcast.broadcast_delays for a in apps)
    assert all(vc.submitted_atts > 0 for vc in vcs)
    assert [a.autoprofiler is None for a in apps] == [False, False, True]
    for app in apps:
        assert app.router.requests.get(("submit", "2xx"), 0) > 0
        assert app.router.requests.get(("attestation_data", "2xx"), 0) > 0
        assert any("/eth/v1/beacon/genesis" in p for p in app.router.proxied)


def test_app_wires_the_serving_layer(tmp_path, monkeypatch):
    """`App.setup` wires what the JAX App wires around the workflow: the
    caching beacon client over the multi-client, the validator-API router
    at the configured address with its start and stop hooks, the OTLP file
    and HTTP sinks and the Loki sink from the environment (``{node}``
    expanded), and the auto-profiler — on by default — on the slot
    budget's late-duty hook; the stop hook drains the sinks."""
    from charon_tpu_torch.app import log as applog
    from charon_tpu_torch.app import otlp
    from charon_tpu_torch.app.autoprofile import AutoProfiler
    from charon_tpu_torch.app.lifecycle import StartOrder, StopOrder
    from charon_tpu_torch.app.serving import CachingBeaconClient
    from charon_tpu_torch.eth2util.beacon_client import MultiBeaconClient

    monkeypatch.delenv("CHARON_TPU_AUTOPROFILE", raising=False)
    monkeypatch.setenv("CHARON_TPU_AUTOPROFILE_DIR",
                       str(tmp_path / "prof-{node}"))
    monkeypatch.setenv("CHARON_TPU_TRACE_FILE",
                       str(tmp_path / "{node}.otlp.jsonl"))
    monkeypatch.setenv("CHARON_TPU_TRACE_ENDPOINT",
                       "http://127.0.0.1:9/v1/traces")
    monkeypatch.setenv("CHARON_TPU_LOKI_ENDPOINT",
                       "http://127.0.0.1:9/loki/api/v1/push")
    cluster_dir, lock = create_cluster(tmp_path, 3, 2, 1)
    vapi_port = free_ports(1)[0]

    async def main():
        bmock = BeaconMock(slot_duration=1.0, slots_per_epoch=4)
        server = BeaconMockServer(bmock)
        await server.start()
        cfg = node_cfg(cluster_dir, 1, server.addr)
        cfg.simnet_vmock = False
        cfg.vapi_port = vapi_port
        app = App(cfg)
        await app.setup()
        try:
            hooks = {(h.order, h.name) for h in app.life._start_hooks}
            stops = {(h.order, h.name) for h in app.life._stop_hooks}
            await app.router.start()
            status = await asyncio.to_thread(
                _http_status, vapi_port, "/eth/v1/node/version")
            await app.router.stop()
            sinks = [type(x).__name__ for x in app._otlp_sinks]
            out = (hooks, stops, status, sinks,
                   app._otlp_sinks[0].path, app._loki_sink._labels,
                   app._loki_sink in applog._sinks)
            with app.tracer_spans.start_span("core/test"):
                pass
            await app._stop_monitoring()
            return app, out
        finally:
            await app.eth2cl.close()
            await server.stop()

    app, (hooks, stops, status, sinks, path, labels, installed) = \
        asyncio.run(main())
    assert isinstance(app.eth2cl, CachingBeaconClient)
    assert isinstance(app.eth2cl.inner, MultiBeaconClient)
    assert (StartOrder.VALIDATOR_API, "vapi-router") in hooks
    assert (StopOrder.VALIDATOR_API, "vapi-router") in stops
    assert status == 200 and app.router.addr == \
        f"http://127.0.0.1:{vapi_port}"
    assert sinks == ["FileSink", "AsyncHTTPSink"]
    assert path == str(tmp_path / "node1.otlp.jsonl")
    assert installed and labels["node"] == "node1"
    assert app._loki_sink not in applog._sinks      # detached at stop
    # the router's span of the request and one of the test's, drained to
    # the file at stop
    assert [s.name for s in otlp.parse_export_lines(
        open(path).read())] == ["vapi/proxy", "core/test"]
    assert isinstance(app.autoprofiler, AutoProfiler)
    assert app.autoprofiler.out_dir == str(tmp_path / "prof-node1")
    assert len(app.slotbudget._late_hooks) == 1



@pytest.mark.parametrize("duties,fetched,signed", [
    ((), None, None),
    (("attester:vc", "sync_message"), {"attester"}, {"sync_message"}),
    (("attester", "proposer"), {"attester", "proposer"},
     {"attester", "proposer"}),
    (("attester:vc",), {"attester"}, set()),
])
def test_simnet_duties_leave_vc_flows_to_the_validator_api(
        tmp_path, monkeypatch, duties, fetched, signed):
    """``run --simnet-duties``: the scheduler fetches every flow named,
    the validator mock signs those not marked ``:vc`` (no mock when every
    flow is) — the `cluster` layout of the smoke run, where HTTP VCs sign
    the attestations and the mock the sync messages.  `run` itself parses
    the flag and builds the App, which stops once set up."""
    from charon_tpu_torch.app import run as run_mod
    from charon_tpu_torch.app.run import _FETCHED_BY_FLOW, simnet_flows
    from charon_tpu_torch.tbls import dispatch
    from charon_tpu_torch.core.scheduler import _FETCHED_TYPES
    from charon_tpu_torch.testutil.validatormock import FLOWS

    cluster_dir, _ = create_cluster(tmp_path, 3, 2, 1)
    node_dir = os.path.join(cluster_dir, "node1")
    seen = []

    class SetUpOnly(App):
        async def run(self):
            await self.setup()
            try:
                seen.append((self.cfg.simnet_duties,
                             self.scheduler._fetched_types, self.vmock))
            finally:
                await self._stop_monitoring()
                await self.eth2cl.close()

    monkeypatch.setattr(run_mod, "App", SetUpOnly)
    # `run` shuts the process's dispatch pipeline down as it returns and
    # leaves SIGINT / SIGTERM ignored: give it a pipeline of its own, and
    # put back this process's pipeline and handlers after it
    monkeypatch.setattr(dispatch, "_default", None)
    handlers = {s: signal.getsignal(s)
                for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        rc = cli_main(
            ["run", "--lock-file",
             os.path.join(node_dir, "cluster-lock.json"),
             "--identity-key-file",
             os.path.join(node_dir, "charon-enr-private-key"),
             "--simnet-beacon-mock", "--simnet-validator-mock",
             "--monitoring-address", "127.0.0.1:0",
             "--validator-api-address", "127.0.0.1:0",
             "--tbls-scheme", "insecure-test"]
            + (["--simnet-duties", ",".join(duties)] if duties else []))
    finally:
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
    assert rc == 0
    [(cfg_duties, types_, vmock)] = seen
    assert cfg_duties == duties
    if fetched is None:
        assert types_ == tuple(_FETCHED_TYPES) and vmock._flows == set(FLOWS)
        return
    assert set(types_) == {t for f in fetched
                           for t in _FETCHED_BY_FLOW.get(f, ())}
    if signed:
        assert vmock._flows == signed
    else:
        assert vmock is None
    assert simnet_flows(duties)[0] == tuple(d.split(":")[0] for d in duties)
    with pytest.raises(ValueError):
        simnet_flows(("attester:mock",))
