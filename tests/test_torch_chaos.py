"""Chaos/soak simnet tests of the port — deterministic fault injection
over the in-memory cluster (charon_tpu_torch/testutil/chaos.py).

Every case of the JAX package's tests/test_chaos_simnet.py on the port's
modules.  Fast lane: every catalogue scenario except the soak — ≥ 200
slots across partitions, asymmetric loss, clock skew, leader crash
mid-round, node restart mid-slot, byzantine equivocation/pre-prepares/
garbage and the two late-blame ground-truth scenarios — CPU-only,
crypto-free (insecure-test tbls scheme).  Slow lane: the 1200-slot
randomised mixed soak.  Plus the satellite pins: EquivocationDetector vs a
live adversary over both the in-memory transport and the real wire codec,
the TCP mesh's expbackoff reconnect gate under a 1000-slot flapping link,
the mesh's fault hooks, fake-clock deadliner driving, and the replay
contract (failure messages embed the seed+plan; same seed ⇒ bit-identical
rerun).

Added for the port:
- each fast scenario's `ChaosResult.fingerprint()` equals the JAX
  harness's at seed 0, and the port's equals itself on a second run;
- the seam: every node of a run dispatches through the harness's one
  inline `DispatchPipeline`, and no executor thread runs a stage;
- the inline pipeline returns the threaded pipeline's verdicts, combined
  bytes and counters, and a device entry point called bare from a
  coroutine still raises;
- chip_smoke's chaos phase keeps a verify bucket per replaying stream
  while it runs, and no longer;
- `TCPMesh(faults=)` consults the hooks on its dial and send paths.
"""

import asyncio
import dataclasses
import os
import random
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from charon_tpu.testutil import chaos as jchaos
from charon_tpu_torch.app.monitoring import Registry
from charon_tpu_torch.core import serialize
from charon_tpu_torch.core.deadline import Deadliner
from charon_tpu_torch.core.parsigex import (EquivocationDetector,
                                            MemParSigExNetwork)
from charon_tpu_torch.core.types import (Duty, DutyType, ParSignedData,
                                         SignedAttestation)
from charon_tpu_torch.eth2util import spec
from charon_tpu_torch.eth2util.signing import DomainName, signing_root
from charon_tpu_torch.p2p.protocols import P2PParSigEx
from charon_tpu_torch.p2p.transport import Peer, TCPMesh
from charon_tpu_torch.tbls import api as tbls
from charon_tpu_torch.tbls import dispatch
from charon_tpu_torch.testutil import chaos
from charon_tpu_torch.testutil.cluster import new_cluster_for_test

FORK = bytes(4)
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def insecure_scheme():
    tbls.set_scheme("insecure-test")
    yield
    tbls.set_scheme("bls")


# ---------------------------------------------------------------------------
# Fast chaos lane: the whole catalogue minus the soak
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", chaos.FAST_SCENARIOS)
def test_fast_scenario(name):
    res = chaos.run_scenario(name, seed=0)
    assert res.attestations, f"{name}: no attestations at all"
    assert res.healthy_slots, f"{name}: empty healthy-slot set"


def test_fast_lane_coverage():
    """The acceptance floor: ≥ 200 slots across ≥ 6 distinct scenario
    kinds, including every hard failure mode."""
    assert len(chaos.FAST_SCENARIOS) >= 6
    total = sum(chaos.SCENARIOS[n].slots for n in chaos.FAST_SCENARIOS)
    assert total >= 200, f"fast lane only covers {total} slots"
    required = {"partition", "asymmetric_loss", "clock_skew", "leader_crash",
                "node_restart", "byzantine_equivocation"}
    assert required <= set(chaos.FAST_SCENARIOS)


@pytest.mark.slow
def test_soak_mixed():
    """1200-slot randomised chaos soak: the full fault vocabulary, one
    window at a time, liveness/safety/telemetry-truth all green."""
    res = chaos.run_scenario("soak", seed=0)
    assert len(res.healthy_slots) > 800
    assert res.router_stats["dropped"] > 0  # the plan actually injected


@pytest.mark.slow
def test_soak_more_seeds():
    for seed in (7, 23):
        chaos.run_scenario("soak", seed=seed)


# ---------------------------------------------------------------------------
# The port against the JAX harness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", chaos.FAST_SCENARIOS)
def test_fingerprint_equals_jax_and_replays(name):
    """Same scenario, same seed: the port's run digests to the JAX
    harness's fingerprint (attestations, decisions, aggregates, tracker
    reports, equivocation and late-duty counters, router stats), and a
    second port run to the same one."""
    port = chaos.run_scenario(name, seed=0)
    jax = jchaos.run_scenario(name, seed=0)
    assert port.fingerprint() == jax.fingerprint()
    assert port.attestations == jax.attestations
    assert chaos.run_scenario(name, seed=0).fingerprint() == \
        port.fingerprint()


# ---------------------------------------------------------------------------
# The inline pipeline seam
# ---------------------------------------------------------------------------

def test_every_node_dispatches_through_the_harness_inline_pipeline(
        monkeypatch):
    """During a run (a restart included) every node's verifier and
    aggregator hold the harness's one inline pipeline, and every stage
    runs on the loop's own thread — never on a ``charon-cuda-*``
    executor thread."""
    stage_threads = set()
    for attr in ("_run_prep", "_run_launch"):
        orig = getattr(dispatch.DispatchPipeline, attr)

        def spy(self, *args, _orig=orig, **kwargs):
            stage_threads.add(threading.current_thread().name)
            return _orig(self, *args, **kwargs)

        monkeypatch.setattr(dispatch.DispatchPipeline, attr, spy)
    harness = chaos.ChaosHarness(chaos.SCENARIOS["node_restart"], seed=0)
    res = harness.run()
    harness.check(res)
    pipe = harness.pipe
    assert pipe.inline
    assert pipe._prep_pool is None and pipe._launch_pool is None
    for holder in harness._slots:
        assert holder.node.dispatcher is pipe
        assert holder.node.verifier._dispatcher is pipe
        assert holder.node.sigagg._dispatcher is pipe
    assert pipe.launches > 0 and pipe.verify_rows > 0
    assert {"verify", "combine"} <= {op for op, _ in pipe.stage_seconds}
    assert stage_threads == {threading.current_thread().name}


def _entries(n_bad: int = 1):
    sk = b"inline".ljust(32, b"\0")
    pk = tbls.privkey_to_pubkey(sk)
    entries = [(pk, b"msg-%d" % k, tbls.sign(sk, b"msg-%d" % k))
               for k in range(5)]
    for k in range(n_bad):
        pk_, msg, sig = entries[k]
        entries[k] = (pk_, msg, bytes(96))
    return entries


def _combine_batch():
    _, shares = tbls.generate_tss(2, 3, seed=b"inline-combine")
    return [{i: tbls.sign(shares[i], b"root-%d" % v) for i in (1, 3)}
            for v in range(3)]


def _through(pipe, entries, batch):
    async def drive():
        stats: dict = {}
        oks = await pipe.batch_verify(entries, stats=stats)
        combined = await pipe.threshold_combine(batch)
        return oks, combined, stats
    try:
        return asyncio.run(drive())
    finally:
        pipe.shutdown()


def test_inline_pipeline_matches_threaded():
    """One verify batch (a bad row in it) and one combine: the inline
    pipeline gives the threaded pipeline's verdicts, combined bytes and
    counters, stage keys included."""
    entries, batch = _entries(), _combine_batch()
    threaded, inline = (dispatch.DispatchPipeline(),
                        dispatch.DispatchPipeline(inline=True))
    oks_t, comb_t, stats_t = _through(threaded, entries, batch)
    oks_i, comb_i, stats_i = _through(inline, entries, batch)
    assert oks_i == oks_t == [False] + [True] * 4
    # off any loop the scheme's combine runs bare
    assert comb_i == comb_t == tbls.threshold_combine(batch)
    for name in ("launches", "tiles", "verify_rows", "queue_depth"):
        assert getattr(inline, name) == getattr(threaded, name), name
    assert set(inline.stage_seconds) == set(threaded.stage_seconds)
    assert set(stats_i) == set(stats_t)
    assert stats_i["tiles"] == stats_t["tiles"] == 1


def test_bare_device_entry_points_still_raise_on_the_loop():
    """An inline pipeline's flag covers only its own stages: after (and
    beside) them, a bare `tbls.batch_verify` / `threshold_combine` or the
    cuda backend's device stage from a coroutine still raises, and the
    threaded pipeline's prewarm still runs off the loop."""
    from charon_tpu_torch.tbls.backend_cuda import CUDABackend

    entries = _entries(0)
    be = CUDABackend(device="cpu")
    tbls.set_scheme("bls")
    sk = b"bare".ljust(32, b"\0")
    prepared = be.combine_host_prep([{1: tbls.sign(sk, b"m")}])
    tbls.set_scheme("insecure-test")

    async def drive():
        pipe = dispatch.DispatchPipeline(inline=True)
        assert await pipe.batch_verify(entries) == [True] * 5
        with pytest.raises(RuntimeError, match="event-loop thread"):
            tbls.batch_verify(entries)
        with pytest.raises(RuntimeError, match="event-loop thread"):
            tbls.threshold_combine(_combine_batch())
        with pytest.raises(RuntimeError, match="event-loop thread"):
            be.combine_device_exec(prepared)
        report = await pipe.prewarm([], num_validators=1, threshold=1)
        assert report == {"skipped": "insecure-test scheme"}

    asyncio.run(drive())


def test_verify_buckets_are_kept_per_stream(monkeypatch):
    """chip_smoke's chaos phase runs side by side on streams of their own:
    while its `verify_graphs_per_stream` is open each stream replays its
    own copy of a verify bucket and one stream shares one copy; at exit
    the copies go and `backend_cuda` keeps its one bucket per padded
    size."""
    from charon_tpu_torch.tbls import backend_cuda

    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    monkeypatch.setattr(backend_cuda, "_GRAPHS", {})
    cpu = torch.device("cpu")
    shared = backend_cuda._verify_graph(cpu, 4)
    stream = {"key": 11}
    with chip_smoke.verify_graphs_per_stream(
            lambda device: stream["key"]) as copies:
        g_a = backend_cuda._verify_graph(cpu, 4)
        assert backend_cuda._verify_graph(cpu, 4) is g_a
        stream["key"] = 12
        g_b = backend_cuda._verify_graph(cpu, 4)
        assert len({id(shared), id(g_a), id(g_b)}) == 3
        assert g_a.inputs["pks"].data_ptr() != g_b.inputs["pks"].data_ptr()
        assert sorted(copies) == [("cpu", 4, 11), ("cpu", 4, 12)]
    assert not copies
    assert backend_cuda._verify_graph(cpu, 4) is shared
    assert backend_cuda.resident_graph_keys() == ["resident:rlc:v=4"]


def test_inline_stage_failure_raises_after_counting():
    """A failing exec stage raises from the inline pipeline as from the
    threaded one, and the pipeline's counters stay balanced."""
    def prep(payload):
        return payload

    def boom(prepared):
        raise ValueError("device stage failed")

    pipe = dispatch.DispatchPipeline(inline=True)

    async def drive():
        with pytest.raises(ValueError, match="device stage failed"):
            await pipe._pipelined((prep, boom), [1, 2], op="verify")

    asyncio.run(drive())
    assert pipe.queue_depth == 0
    assert pipe.launches == 1 and pipe.tiles == 2
    assert pipe.stage_seconds == {}


# ---------------------------------------------------------------------------
# Replay contract
# ---------------------------------------------------------------------------

def test_failure_message_contains_replay_recipe():
    """Any scenario failure must print the (seed, FaultPlan) replay
    recipe.  Forced here via an impossible telemetry expectation."""
    scn = dataclasses.replace(
        chaos.SCENARIOS["clock_skew"], name="clock_skew",
        expect_late_phase="sigagg", min_late=1)
    harness = chaos.ChaosHarness(scn, seed=4)
    res = harness.run()
    with pytest.raises(chaos.ChaosFailure) as exc_info:
        harness.check(res)
    msg = str(exc_info.value)
    assert "python -m charon_tpu_torch.testutil.chaos" in msg
    assert "--scenario clock_skew" in msg
    assert "--seed 4" in msg
    assert "FaultPlan(" in msg


def test_same_seed_replays_bit_identically():
    """The determinism contract behind the replay recipe: identical
    (seed, plan) ⇒ identical fingerprint, including an rng-consuming
    plan (probabilistic loss + jitter)."""

    def lossy_plan(scn, rng):
        links = tuple(
            chaos.LinkFault(a, b, 4, 16, drop=0.25, latency=0.05,
                            jitter=0.08, reorder=0.1)
            for a, b in ((0, 1), (1, 0)))
        return chaos.FaultPlan(links=links)

    scn = chaos.Scenario("lossy_replay", 22, lossy_plan)
    fps = []
    for _ in range(2):
        harness = chaos.ChaosHarness(scn, seed=11)
        res = harness.run()
        harness.check(res)
        fps.append(res.fingerprint())
    assert fps[0] == fps[1], "same seed produced different runs"


def test_cli_replay_entrypoint():
    """`python -m charon_tpu_torch.testutil.chaos --seed N --scenario X`
    is the local replay tool for a failed run."""
    out = subprocess.run(
        [sys.executable, "-m", "charon_tpu_torch.testutil.chaos",
         "--scenario", "node_restart", "--seed", "0"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert "PASS node_restart" in out.stdout
    assert "fingerprint=" in out.stdout


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a machine with a card runs the bls scenario")
def test_cli_bls_without_a_card_exits_one_naming_the_device():
    """``--tbls-scheme bls`` verifies and combines on the card: with no
    card it stops before any scenario, naming the device — nothing falls
    back to the CPU."""
    out = subprocess.run(
        [sys.executable, "-m", "charon_tpu_torch.testutil.chaos",
         "--scenario", "garbage", "--slots", "8", "--tbls-scheme", "bls"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 1, out.stdout + out.stderr
    assert "no CUDA device" in out.stderr
    assert "PASS" not in out.stdout
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos.ChaosHarness(chaos.SCENARIOS["garbage"], seed=0,
                           scheme="bls").run()
    assert tbls.scheme_name() == "insecure-test"


# ---------------------------------------------------------------------------
# EquivocationDetector vs a live adversary (satellite)
# ---------------------------------------------------------------------------

def _attestation_pset(cluster, share_idx: int, slot: int,
                      block_root: bytes) -> dict:
    """One validator's validly-signed attester partial from `share_idx`."""
    v = cluster.validators[0]
    data = spec.AttestationData(
        slot=slot, index=0, beacon_block_root=block_root,
        source=spec.Checkpoint(), target=spec.Checkpoint(epoch=1))
    root = signing_root(DomainName.BEACON_ATTESTER, data.hash_tree_root(),
                        FORK, bytes(32))
    sig = tbls.sign(v.share_privkeys[share_idx], root)
    att = spec.Attestation(aggregation_bits=(b"\x01", 1), data=data,
                           signature=sig)
    return {v.group_pubkey: ParSignedData(data=SignedAttestation(att),
                                          share_idx=share_idx)}


def _verify_fn(cluster, spe=8):
    async def verify(duty, pset):
        for group_pk, psig in pset.items():
            pubshare = cluster.validators[0].pubshares[psig.share_idx]
            domain, _ = psig.data.signing_info(spe)
            root = signing_root(domain, psig.data.message_root(), FORK,
                                bytes(32))
            if not tbls.verify(pubshare, root, psig.signature):
                raise ValueError("invalid partial signature")
    return verify


def test_equivocation_live_adversary_mem_transport():
    """Byzantine node sends two DIFFERENT validly-signed partials for the
    same (duty, pk, share) over MemParSigEx: detection + per-peer counter
    fire; an honest re-broadcast of the SAME bytes never counts."""
    cluster = new_cluster_for_test(2, 3, 1)
    net = MemParSigExNetwork()
    reg = Registry()
    receiver = net.join(verify_fn=_verify_fn(cluster), registry=reg)
    sender = net.join()
    duty = Duty(9, DutyType.ATTESTER)

    honest = _attestation_pset(cluster, 2, 9, b"A" * 32)
    conflicting = _attestation_pset(cluster, 2, 9, b"B" * 32)

    async def drive():
        await sender.broadcast(duty, honest)
        await sender.broadcast(duty, honest)       # same bytes: no count
        await sender.broadcast(duty, conflicting)  # detected + counted

    asyncio.run(drive())
    assert receiver._equiv.equivocations == 1
    assert chaos.metric_value(reg, "core_parsigex_equivocations_total",
                              {"peer": "2"}) == 1.0
    assert chaos.metric_value(reg, "core_parsigex_equivocations_total",
                              {"peer": "1"}) == 0.0


def test_equivocation_live_adversary_wire_codec():
    """Same adversary through the REAL wire codec (P2PParSigEx frame
    handler on serialize-encoded bytes): decode → verify → pin."""

    class FakeMesh:
        def __init__(self):
            self.handlers = {}

        def register_handler(self, proto, fn):
            self.handlers[proto] = fn

        async def broadcast(self, proto, payload):
            pass

    cluster = new_cluster_for_test(2, 3, 1)
    reg = Registry()
    mesh = FakeMesh()
    psx = P2PParSigEx(mesh, verify_fn=_verify_fn(cluster), registry=reg)
    handler = mesh.handlers["/charon_tpu/parsigex/1.0.0"]
    duty = Duty(5, DutyType.ATTESTER)

    honest_bytes = serialize.encode_parsig_set(
        duty, _attestation_pset(cluster, 3, 5, b"C" * 32))
    conflict_bytes = serialize.encode_parsig_set(
        duty, _attestation_pset(cluster, 3, 5, b"D" * 32))
    garbage_bytes = serialize.encode_parsig_set(
        duty, {k: dataclasses.replace(
            v, data=v.data.set_signature(b"\xff" * 96))
            for k, v in _attestation_pset(cluster, 3, 5, b"C" * 32).items()})

    async def drive():
        await handler(2, honest_bytes)
        await handler(2, honest_bytes)   # byte-identical re-broadcast
        await handler(2, conflict_bytes)
        with pytest.raises(ValueError):
            await handler(2, garbage_bytes)  # bad sig: rejected pre-pin

    asyncio.run(drive())
    assert psx._equiv.equivocations == 1
    assert chaos.metric_value(reg, "core_parsigex_equivocations_total",
                              {"peer": "3"}) == 1.0


def test_equivocation_detector_bounded_memory():
    det = EquivocationDetector(max_duties=4)
    for slot in range(32):
        det.check(Duty(slot, DutyType.ATTESTER),
                  {"pk": ParSignedData(
                      data=SignedAttestation(spec.Attestation(
                          aggregation_bits=(b"\x01", 1),
                          data=spec.AttestationData(slot=slot,
                                                    source=spec.Checkpoint(),
                                                    target=spec.Checkpoint()),
                          signature=bytes(96))),
                      share_idx=1)})
    assert len(det._seen) == 4


# ---------------------------------------------------------------------------
# TCP mesh reconnect gate (satellite): no storm under a flapping link
# ---------------------------------------------------------------------------

class _StubWriter:
    def __init__(self):
        self.closed = False
        self.data = b""

    def write(self, b):
        self.data += b

    async def drain(self):
        pass

    def close(self):
        self.closed = True

    def is_closing(self):
        return self.closed


class _StubChannel:
    def __init__(self, peer_index):
        self.peer_index = peer_index
        self.writer = _StubWriter()
        self.reader = asyncio.StreamReader()  # never fed: read loop parks

    def seal(self, body):
        return b"\x00\x00\x00\x04" + body[:4]


def _mesh(rng_seed=5, ceiling=30.0, faults=None):
    peers = [Peer(0, "127.0.0.1", 0), Peer(1, "127.0.0.1", 1)]
    return TCPMesh(0, peers, node_identity=None, peer_pubkeys={},
                   rng=random.Random(rng_seed), backoff_ceiling=ceiling,
                   faults=faults)


def test_reconnect_backoff_bounds_dial_rate_over_1000_slots():
    """Flapping-link soak: 5 sends/slot for 1000 one-second slots against
    a dead peer.  Without the gate that is 5000 dials; with the jittered
    expbackoff ceiling the dial rate is bounded by the schedule, every
    send still fails fast, and the failure-streak gauge surfaces the
    give-up state."""
    mesh = _mesh()

    async def dead_dial(peer):
        raise ConnectionError("link down")

    mesh._dial = dead_dial
    sends = 5000

    async def drive():
        for _ in range(1000):
            for _ in range(5):
                await mesh.send_async(1, "/p", b"x")
            await asyncio.sleep(1.0)

    chaos.run_sim(drive())
    dials = mesh.dial_attempts.get(1, 0)
    assert mesh.send_failures[1] == sends  # every send failed (fast)
    # schedule bound: ramp (~10 dials to hit the 30 s ceiling) plus
    # 1000 s / 30 s·(1−jitter) ≈ 42 — anything near the send count is
    # a storm regression
    assert 20 <= dials <= 80, f"dial storm: {dials} dials for {sends} sends"


def test_reconnect_gate_clears_on_success():
    mesh = _mesh(ceiling=2.0)
    state = {"up": False}

    async def flappy_dial(peer):
        if not state["up"]:
            raise ConnectionError("down")
        return asyncio.StreamReader(), _StubWriter()

    async def fake_handshake(reader, writer, peer_index):
        return _StubChannel(peer_index)

    mesh._dial = flappy_dial
    mesh._handshake_initiator = fake_handshake

    async def drive():
        for _ in range(10):
            await mesh.send_async(1, "/p", b"x")
            await asyncio.sleep(0.5)
        down_dials = mesh.dial_attempts.get(1, 0)
        assert mesh.send_failures[1] == 10
        state["up"] = True
        await asyncio.sleep(2.5)       # let the gate expire
        await mesh.send_async(1, "/p", b"x")
        assert mesh.send_failures[1] == 0       # streak reset on success
        assert 1 not in mesh._backoff           # gate cleared
        assert mesh.dial_attempts[1] == down_dials + 1
        # a healthy channel is reused: no further dials
        await mesh.send_async(1, "/p", b"x")
        assert mesh.dial_attempts[1] == down_dials + 1
        await mesh.stop()

    chaos.run_sim(drive())


def test_inbound_handshake_reopens_backoff_gate():
    """A recovered peer dialing IN proves the link is up: the outbound
    reconnect gate must open immediately instead of fast-failing sends
    for the rest of a ceiling-length backoff window."""
    mesh = _mesh(ceiling=60.0)

    async def dead_dial(peer):
        raise ConnectionError("down")

    async def fake_responder_handshake(reader, writer):
        return _StubChannel(1)

    mesh._dial = dead_dial
    mesh._handshake_responder = fake_responder_handshake

    async def drive():
        for _ in range(6):
            await mesh.send_async(1, "/p", b"x")
            await asyncio.sleep(1.0)
        assert 1 in mesh._backoff
        inbound = asyncio.get_event_loop().create_task(
            mesh._on_inbound(asyncio.StreamReader(), _StubWriter()))
        await asyncio.sleep(0.1)
        assert 1 not in mesh._backoff
        inbound.cancel()

    chaos.run_sim(drive())


def test_mesh_fault_hooks_drive_dial_and_send():
    """MeshLinkFaults: the FaultPlan's directed cut blacks out dials;
    healing restores them."""
    plan = chaos.FaultPlan(links=(
        chaos.LinkFault(0, 1, 0, 10, drop=1.0),))
    faults = chaos.MeshLinkFaults(plan, random.Random(0), 0,
                                  slot_duration=1.0)

    async def drive():
        with pytest.raises(ConnectionError):
            await faults.on_dial(1)
        with pytest.raises(ConnectionError):
            await faults.on_send(1, "/p", 4)
        await asyncio.sleep(12.0)  # past the fault window
        await faults.on_dial(1)    # open again: no raise
        await faults.on_send(1, "/p", 4)

    chaos.run_sim(drive())


def test_tcp_mesh_consults_its_fault_hooks():
    """TCPMesh(faults=MeshLinkFaults(...)): a cut dial fails before the
    socket is touched and closes the backoff gate; once the link heals
    the dial goes through, and a frame cut on the send path (the link cut
    again, the channel up) fails the send without a redial; a link with
    latency delays the frame by the plan's seconds."""
    plan = chaos.FaultPlan(links=(
        chaos.LinkFault(0, 1, 0, 5, drop=1.0),
        chaos.LinkFault(0, 1, 10, 15, drop=1.0),
        chaos.LinkFault(0, 1, 20, 25, latency=0.3)))
    mesh = _mesh(ceiling=1.0, faults=chaos.MeshLinkFaults(
        plan, random.Random(0), 0, slot_duration=1.0))
    dialed, channels = [], []

    async def dial(peer):
        dialed.append(asyncio.get_running_loop().time())
        return asyncio.StreamReader(), _StubWriter()

    async def handshake(reader, writer, peer_index):
        ch = _StubChannel(peer_index)
        channels.append(ch)
        return ch

    mesh._dial = dial
    mesh._handshake_initiator = handshake

    async def drive():
        loop = asyncio.get_running_loop()
        await mesh.send_async(1, "/p", b"x")
        assert dialed == [] and mesh.send_failures[1] == 1
        assert mesh.dial_attempts[1] == 1 and 1 in mesh._backoff
        await asyncio.sleep(6.0)                 # healed
        await mesh.send_async(1, "/p", b"x")
        assert len(dialed) == 1 and mesh.send_failures[1] == 0
        sent = channels[0].writer.data
        await asyncio.sleep(5.0)                 # slot 11: cut again
        await mesh.send_async(1, "/p", b"x")
        assert mesh.send_failures[1] == 1 and len(dialed) == 1
        assert channels[0].writer.data == sent   # the frame never left
        await asyncio.sleep(10.0)                # slot 21: 0.3 s latency
        t0 = loop.time()
        await mesh.send_async(1, "/p", b"x")
        assert loop.time() - t0 == pytest.approx(0.3)
        assert channels[0].writer.data != sent
        await mesh.stop()

    chaos.run_sim(drive())


# ---------------------------------------------------------------------------
# Fake-clock deadliner (satellite)
# ---------------------------------------------------------------------------

def test_deadliner_fake_clock_poke():
    """A jumped fake clock plus poke() expires duties deterministically
    without waiting out the wall-time poll cap."""
    now = [100.0]
    d = Deadliner(lambda duty: 100.0 + duty.slot, clock=lambda: now[0])

    async def drive():
        d.start()
        assert d.add(Duty(50, DutyType.ATTESTER))   # deadline 150
        assert not d.add(Duty(0, DutyType.ATTESTER))  # already expired
        await asyncio.sleep(0)
        now[0] = 200.0
        d.poke()
        agen = d.expired()
        duty = await asyncio.wait_for(agen.__anext__(), timeout=5.0)
        assert duty == Duty(50, DutyType.ATTESTER)
        d.stop()

    asyncio.run(drive())


def test_healthy_slots_require_a_clique_not_a_star():
    """A hub node pairwise-open to two mutually-cut spokes is NOT a
    quorum that can exchange prepares: healthy_slots must demand mutual
    connectivity within the group, or liveness would be asserted on
    slots that cannot complete."""
    def star_plan(scn, rng):
        cuts = [(1, 2), (2, 1)]                       # spokes cut
        cuts += [(3, t) for t in (0, 1, 2)] + [(t, 3) for t in (0, 1, 2)]
        return chaos.FaultPlan(links=tuple(
            chaos.LinkFault(a, b, 5, 15, drop=1.0) for a, b in cuts))

    scn = chaos.Scenario("star_cut", 20, star_plan)
    harness = chaos.ChaosHarness(scn, seed=0)
    healthy = harness.healthy_slots()
    # node 0 is pairwise-open to 1 and 2, but {0,1,2} is no clique and
    # node 3 is fully cut: no quorum group exists inside the window
    assert not any(7 <= s <= 13 for s in healthy), sorted(healthy)
    assert 2 in healthy and 17 in healthy  # outside the window: fine


def test_backoff_gate_survives_slow_failing_dials():
    """The gate deadline must be stamped AFTER the failed dial: a dial
    that burns seconds before failing (handshake timeout, dropped SYNs)
    must still close the gate for the next send."""
    mesh = _mesh(ceiling=30.0)

    async def slow_dead_dial(peer):
        await asyncio.sleep(5.0)  # burns more than the early backoffs
        raise ConnectionError("handshake timeout")

    mesh._dial = slow_dead_dial

    async def drive():
        for _ in range(100):
            await mesh.send_async(1, "/p", b"x")
            await asyncio.sleep(1.0)

    chaos.run_sim(drive())
    dials = mesh.dial_attempts.get(1, 0)
    # 100 sends over ~100 s of 5 s-failing dials: without the fix every
    # send redials (gate always pre-expired) ≈ 20+ dials back-to-back;
    # with it the schedule bounds the rate
    assert dials <= 15, f"gate inert under slow dial failures: {dials}"


# ---------------------------------------------------------------------------
# Virtual-time loop basics
# ---------------------------------------------------------------------------

def test_sim_loop_jumps_time_deterministically():
    async def drive():
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        await asyncio.sleep(3600.0)
        return loop.time() - t0

    import time as _time
    wall0 = _time.monotonic()
    elapsed = chaos.run_sim(drive())
    assert elapsed == pytest.approx(3600.0)
    assert _time.monotonic() - wall0 < 5.0  # virtual hour, wall instant


def test_sim_loop_detects_deadlock():
    async def drive():
        await asyncio.get_running_loop().create_future()  # never resolves

    with pytest.raises(RuntimeError, match="deadlock"):
        chaos.run_sim(drive())
