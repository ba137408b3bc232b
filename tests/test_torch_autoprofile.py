"""The port's SLO-triggered auto-profiler (`charon_tpu_torch.app.
autoprofile`) and `/debug/profile`, held against the JAX package's: the
counterparts of tests/test_autoprofile.py's cases — rate limit, the
process-global guard, the ring bound and its meta stamps, capture errors
counted, a real capture (a CPU `torch.profiler` trace where the JAX one
takes a `jax.profiler` trace), the loop-lag breach hook, the induced
slot-budget breach on a simnet node, the environment knobs — each run on
both packages with stub captures and compared; and `/debug/profile`: a
gzipped tarball holding the trace, 409 while a capture runs, 400 for a
bad duration, 500 for a failed or empty capture."""

import asyncio
import io
import json
import os
import tarfile
import time
import urllib.error
import urllib.request

import pytest
import torch

torch.set_num_threads(1)

from charon_tpu.app import autoprofile as j_autoprofile  # noqa: E402
from charon_tpu.app import monitoring as j_monitoring  # noqa: E402
from charon_tpu.app.tracing import duty_trace_id as j_trace_id  # noqa: E402
from charon_tpu_torch.app import autoprofile as t_autoprofile  # noqa: E402
from charon_tpu_torch.app import monitoring as t_monitoring  # noqa: E402
from charon_tpu_torch.app.tracing import duty_trace_id  # noqa: E402
from charon_tpu_torch.core.types import Duty, DutyType  # noqa: E402
from charon_tpu_torch.tbls import api as tbls  # noqa: E402

PKGS = {"jax": (j_autoprofile, j_monitoring),
        "port": (t_autoprofile, t_monitoring)}


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def _stub_capture(paths):
    def capture(cap_dir):
        paths.append(cap_dir)
        with open(os.path.join(cap_dir, "trace.bin"), "wb") as fh:
            fh.write(b"x")

    return capture


def _caps(out_dir):
    return sorted(d for d in os.listdir(out_dir) if d.startswith("cap"))


def test_rate_limit_exactly_one_capture(tmp_path):
    """A breach storm captures ONCE per min_interval; advancing the fake
    clock past the interval re-arms — the same on both packages."""

    def scenario(k):
        autoprofile, _ = PKGS[k]
        clock, paths = FakeClock(), []
        ap = autoprofile.AutoProfiler(str(tmp_path / k), ring=8,
                                      min_interval=300, clock=clock,
                                      capture_fn=_stub_capture(paths))

        async def storm():
            return [await ap.trigger("late_duty") for _ in range(5)]

        got = asyncio.run(storm())
        out = [[g is not None for g in got], ap.captures,
               ap.skipped_rate_limited, _caps(tmp_path / k)]
        clock.now += 301
        out += [asyncio.run(ap.trigger("late_duty")) is not None,
                ap.captures]
        return out

    assert scenario("port") == scenario("jax") == [
        [True, False, False, False, False], 1, 4, ["cap0001-late_duty"],
        True, 2]


def test_process_global_guard_respected(tmp_path):
    """A /debug/profile in flight (the process-wide guard held) makes the
    trigger skip, never queue or double-start; the capture releases it."""

    def scenario(k):
        autoprofile, monitoring = PKGS[k]
        paths = []
        ap = autoprofile.AutoProfiler(str(tmp_path / k), min_interval=0,
                                      clock=FakeClock(),
                                      capture_fn=_stub_capture(paths))
        assert monitoring.profile_guard_acquire()
        try:
            skipped = asyncio.run(ap.trigger("loop_lag")) is None
            out = [skipped, ap.skipped_guard_busy, ap.captures]
        finally:
            monitoring.profile_guard_release()
        out += [asyncio.run(ap.trigger("loop_lag")) is not None,
                asyncio.run(ap.trigger("loop_lag")) is not None,
                monitoring._PROFILE_ACTIVE]
        return out

    assert scenario("port") == scenario("jax") == [True, 1, 0, True, True,
                                                   False]


def test_ring_bounded_and_meta_stamped(tmp_path):
    def scenario(k):
        autoprofile, monitoring = PKGS[k]
        reg = monitoring.Registry()
        ap = autoprofile.AutoProfiler(str(tmp_path / k), registry=reg, ring=2,
                                      min_interval=0, clock=FakeClock(),
                                      capture_fn=_stub_capture([]))

        async def three():
            for i in range(3):
                assert await ap.trigger("late_duty", trace_id=f"{i:032x}",
                                        detail="sigagg") is not None

        asyncio.run(three())
        caps = _caps(tmp_path / k)
        meta = json.loads((tmp_path / k / caps[-1] / "meta.json").read_text())
        meta.pop("unix_time")
        lines = [line for line in reg.render().splitlines()
                 if line.startswith("app_autoprofile")]
        return caps, meta, lines, ap.stats()["ring"]

    j, t = scenario("jax"), scenario("port")
    assert t[0] == j[0] == ["cap0002-late_duty", "cap0003-late_duty"]
    assert t[1] == j[1] == {"reason": "late_duty", "trace_id": f"{2:032x}",
                            "detail": "sigagg", "seconds": 1.0}
    assert t[2] == j[2]
    assert 'app_autoprofile_captures_total{reason="late_duty"} 3.0' in t[2]
    assert t[3] == j[3] == 2


def test_capture_error_counted_never_raised(tmp_path):
    def boom(cap_dir):
        raise OSError("disk full")

    def scenario(k):
        autoprofile, monitoring = PKGS[k]
        ap = autoprofile.AutoProfiler(str(tmp_path / k), min_interval=0,
                                      clock=FakeClock(), capture_fn=boom)
        got = asyncio.run(ap.trigger("late_duty"))
        return got, ap.capture_errors, _caps(tmp_path / k), \
            monitoring._PROFILE_ACTIVE

    assert scenario("port") == scenario("jax") == (None, 1, [], False)


def test_real_profiler_capture_nonempty(tmp_path):
    """The default capture is a real profiler trace — the port's a
    `torch.profiler` trace (CPU activity here), the JAX one's a
    `jax.profiler` trace: each ring directory holds profiler output next
    to the meta stamp; the port's is a Chrome trace with events."""
    found = {}
    for k, (autoprofile, _) in PKGS.items():
        ap = autoprofile.AutoProfiler(str(tmp_path / k), min_interval=0,
                                      seconds=0.05)
        cap = asyncio.run(ap.trigger("loop_lag"))
        assert cap is not None, k
        found[k] = [os.path.relpath(os.path.join(dp, f), cap)
                    for dp, _, fns in os.walk(cap) for f in fns]
        assert "meta.json" in found[k] and len(found[k]) > 1, found
    assert sorted(found["port"]) == ["meta.json", "trace.json"]
    doc = json.loads((tmp_path / "port" / "cap0001-loop_lag"
                      / "trace.json").read_text())
    assert any(e.get("cat") == "cpu_op" for e in doc["traceEvents"])


def test_loop_lag_breach_fires_autoprofiler_hook():
    """p99 over the rolling window above the SLO → on_breach fires (the
    profiler's own rate limit bounds captures)."""
    reg = t_monitoring.Registry()
    breaches = []

    async def main():
        probe = asyncio.ensure_future(t_monitoring.loop_lag_probe(
            reg, interval=0.002, lag_slo=0.01, on_breach=breaches.append))
        try:
            await asyncio.sleep(0.1)
            for _ in range(3):
                time.sleep(0.03)       # blocking: the loop stalls
                await asyncio.sleep(0.01)
            for _ in range(100):
                if breaches:
                    return
                await asyncio.sleep(0.005)
        finally:
            probe.cancel()

    asyncio.run(main())
    assert breaches and breaches[0] == "loop_lag"
    assert "core_dispatch_overlap_efficiency" not in reg.render()


def _observable_node():
    """One port simnet `Node` of a 4-node QBFT cluster with a registry
    and tracer (tests/test_observability_e2e.py's build, on the port)."""
    from charon_tpu_torch.app.monitoring import Registry
    from charon_tpu_torch.app.node import Node, NodeConfig
    from charon_tpu_torch.app.tracing import Tracer
    from charon_tpu_torch.core.consensus import (ConsensusMemNetwork,
                                                 QBFTConsensus)
    from charon_tpu_torch.core.parsigex import MemParSigExNetwork
    from charon_tpu_torch.testutil.beaconmock import BeaconMock
    from charon_tpu_torch.testutil.cluster import new_cluster_for_test

    cluster = new_cluster_for_test(3, 4, 2)
    bmock = BeaconMock(slot_duration=0.25, slots_per_epoch=4)
    for v in cluster.validators:
        bmock.add_validator(v.group_pubkey)
    pubshares_by_peer = {i: cluster.pubshare_map(i) for i in range(1, 5)}
    registry = Registry(const_labels={"node": "node0"})
    tracer = Tracer(registry)
    consensus = QBFTConsensus(ConsensusMemNetwork(), 0, 4,
                              round_timeout_base=0.3, registry=registry,
                              tracer=tracer, trace_id_fn=duty_trace_id)
    return Node(NodeConfig(share_idx=1, threshold=3,
                           pubshares_by_peer=pubshares_by_peer,
                           fork_version=bytes(4)), bmock,
                consensus=consensus, parsigex=MemParSigExNetwork().join(
                    registry=registry),
                slots_per_epoch=4, genesis_time=bmock.genesis,
                slot_duration=0.25, registry=registry, tracer=tracer)


def test_slotbudget_breach_one_bounded_capture(tmp_path, monkeypatch):
    """An induced slot-budget breach on a port simnet node produces
    exactly ONE bounded capture (a real `torch.profiler` trace), stamped
    with the triggering duty's deterministic trace ID — the JAX package's
    ID for the same duty — and the blamed phase; a second breach inside
    the rate-limit window captures nothing."""
    monkeypatch.setenv("CHARON_TPU_AUTOPROFILE", "1")
    monkeypatch.setenv("CHARON_TPU_AUTOPROFILE_DIR",
                       str(tmp_path / "ring-{node}"))
    monkeypatch.setenv("CHARON_TPU_AUTOPROFILE_SECONDS", "0.05")
    tbls.set_scheme("insecure-test")
    try:
        async def induce():
            node = _observable_node()
            assert node.autoprofiler is not None
            duty = Duty(slot=0, type=DutyType.ATTESTER)
            sb = node.slotbudget
            await sb.on_duty_scheduled(duty, None)
            await sb.on_fetched(duty, None)
            await sb.on_consensus(duty, None)
            await sb.on_threshold(duty, None, None)
            await sb.on_aggregated(duty, None, None)
            before = node.autoprofiler.captures
            sb.finalize(duty)
            deadline = time.time() + 20
            while (node.autoprofiler.captures == before
                   and time.time() < deadline):
                await asyncio.sleep(0.02)
            duty2 = Duty(slot=1, type=DutyType.ATTESTER)
            await sb.on_duty_scheduled(duty2, None)
            sb.finalize(duty2)
            await asyncio.sleep(0.2)
            return node, duty

        node, duty = asyncio.run(induce())
        assert node.autoprofiler.captures == 1
        assert node.autoprofiler.skipped_rate_limited >= 1
        ring = tmp_path / "ring-node0"
        caps = _caps(ring)
        assert len(caps) == 1, "exactly one bounded capture expected"
        meta = json.loads((ring / caps[0] / "meta.json").read_text())
        assert meta["reason"] == "late_duty"
        from charon_tpu.core.types import Duty as JDuty
        from charon_tpu.core.types import DutyType as JDutyType

        assert meta["trace_id"] == duty_trace_id(duty) == j_trace_id(
            JDuty(slot=0, type=JDutyType.ATTESTER))
        assert meta["detail"] == "bcast"   # the phase that never happened
        assert (ring / caps[0] / "trace.json").stat().st_size > 0
    finally:
        tbls.set_scheme("bls")


def test_from_env_defaults(monkeypatch):
    for k, (autoprofile, _) in PKGS.items():
        monkeypatch.delenv("CHARON_TPU_AUTOPROFILE", raising=False)
        assert autoprofile.from_env(default_on=False) is None
        assert autoprofile.from_env(default_on=True) is not None
        monkeypatch.setenv("CHARON_TPU_AUTOPROFILE", "0")
        assert autoprofile.from_env(default_on=True) is None
        monkeypatch.setenv("CHARON_TPU_AUTOPROFILE", "1")
        monkeypatch.setenv("CHARON_TPU_AUTOPROFILE_RING", "3")
        monkeypatch.setenv("CHARON_TPU_AUTOPROFILE_INTERVAL", "42")
        monkeypatch.setenv("CHARON_TPU_AUTOPROFILE_SECONDS", "99")
        ap = autoprofile.from_env(default_on=False, node_name="n7")
        assert ap is not None and "n7" in ap.out_dir, k
        assert (ap.ring, ap.min_interval, ap.seconds) == (
            3, 42.0, t_monitoring.PROFILE_MAX_SECONDS), k
        monkeypatch.delenv("CHARON_TPU_AUTOPROFILE_RING")
        monkeypatch.delenv("CHARON_TPU_AUTOPROFILE_INTERVAL")
        monkeypatch.delenv("CHARON_TPU_AUTOPROFILE_SECONDS")


# ---------------------------------------------------------------------------
# /debug/profile
# ---------------------------------------------------------------------------


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _profile_requests(paths, before=None):
    async def main():
        api = t_monitoring.MonitoringAPI(t_monitoring.Registry(),
                                         readyz=lambda: (True, "ok"))
        await api.start()
        try:
            out = []
            for p in paths:
                if before is not None:
                    before()
                out.append(await asyncio.to_thread(_get, api.port, p))
            return out
        finally:
            await api.stop()

    return asyncio.run(main())


def test_debug_profile_returns_a_trace_tarball():
    """A CPU `torch.profiler` capture, sent back gzipped: the capture's
    directory as ``profile/`` with a Chrome trace of CPU events; the
    guard is released after it, and a bad duration is a 400."""
    [(status, ctype, body), (bad, _, msg)] = _profile_requests(
        ["/debug/profile?seconds=0.1", "/debug/profile?seconds=abc"])
    assert status == 200 and ctype == "application/octet-stream"
    with tarfile.open(fileobj=io.BytesIO(body), mode="r:gz") as tar:
        names = tar.getnames()
        assert "profile/trace.json" in names
        doc = json.load(tar.extractfile("profile/trace.json"))
    assert doc["traceEvents"]
    assert bad == 400 and b"number" in msg
    assert not t_monitoring._PROFILE_ACTIVE


def test_debug_profile_conflict_failure_and_empty_capture(monkeypatch):
    """409 while another capture holds the guard; a capture that raises
    or records no event is a 500 — never an empty 200 — and the guard is
    released either way."""
    assert t_monitoring.profile_guard_acquire()
    try:
        [(status, _, body)] = _profile_requests(["/debug/profile"])
    finally:
        t_monitoring.profile_guard_release()
    assert status == 409 and b"already running" in body

    async def boom(out_dir, seconds):
        raise RuntimeError("CUPTI unavailable")

    monkeypatch.setattr(t_monitoring, "run_profile_capture", boom)
    [(status, _, body)] = _profile_requests(["/debug/profile?seconds=0"])
    assert status == 500 and b"CUPTI unavailable" in body
    assert not t_monitoring._PROFILE_ACTIVE
    monkeypatch.undo()

    monkeypatch.setattr(t_monitoring, "_export_trace", lambda prof, path: 0)
    [(status, _, body)] = _profile_requests(["/debug/profile?seconds=0"])
    assert status == 500 and b"no event" in body
    assert not t_monitoring._PROFILE_ACTIVE


def test_capture_leaves_the_loop_free(tmp_path, monkeypatch):
    """A capture runs off the event loop, the profiler's start and stop
    included: with the profiler's start made to take 1.5 s (a card's
    first start spends ≈ 14 s in CUPTI's set-up with the interpreter lock
    released: tools/profile_stall_probe.py), a 0.5 s capture — through
    `run_profile_capture`, which `/debug/profile` serves, and through the
    auto-profiler's trigger — never holds a 10 ms loop probe for longer
    than its own 0.5 s."""
    from torch.profiler import profile

    seconds, setup = 0.5, 1.5
    start = profile.start

    def slow_start(self):
        time.sleep(setup)
        start(self)

    monkeypatch.setattr(profile, "start", slow_start)

    async def watched(capture):
        loop = asyncio.get_running_loop()
        lags, done = [], asyncio.Event()

        async def probe():
            while not done.is_set():
                t0 = loop.time()
                await asyncio.sleep(0.01)
                lags.append(loop.time() - t0 - 0.01)

        task = asyncio.create_task(probe())
        await asyncio.sleep(0.05)
        t0 = time.monotonic()
        out = await capture()
        wall = time.monotonic() - t0
        done.set()
        await task
        return out, wall, max(lags), len(lags)

    ap = t_autoprofile.AutoProfiler(str(tmp_path / "ring"), min_interval=0,
                                    seconds=seconds)
    runs = {
        "run_profile_capture": asyncio.run(watched(
            lambda: t_monitoring.run_profile_capture(str(tmp_path),
                                                     seconds))),
        "trigger": asyncio.run(watched(lambda: ap.trigger("loop_lag"))),
    }
    for name, (_, wall, max_lag, ticks) in runs.items():
        assert wall >= setup + seconds, name
        assert max_lag < seconds, (name, max_lag)
        assert ticks >= wall / 0.05, (name, ticks, wall)
    timings = runs["run_profile_capture"][0]
    assert timings["start_s"] >= setup and timings["events"] > 0
    assert runs["trigger"][0] is not None and ap.captures == 1


def test_prewarm_pays_the_profiler_setup_at_boot(tmp_path, monkeypatch):
    """`AutoProfiler.prewarm`, which the App runs after the dispatch
    prewarm: one throwaway capture on a worker thread, under the
    process-global guard → its seconds; skipped (None) while another
    capture holds the guard or when the capture is a stub; a failure is
    counted, never raised; the guard is free after each."""
    ap = t_autoprofile.AutoProfiler(str(tmp_path / "ring"))
    seconds = asyncio.run(ap.prewarm())
    assert isinstance(seconds, float) and seconds >= 0
    assert not t_monitoring._PROFILE_ACTIVE
    assert not (tmp_path / "ring").exists()      # nothing kept
    assert t_monitoring.profile_guard_acquire()
    try:
        assert asyncio.run(ap.prewarm()) is None
    finally:
        t_monitoring.profile_guard_release()
    stub = t_autoprofile.AutoProfiler(str(tmp_path / "stub"),
                                      capture_fn=lambda cap_dir: None)
    assert asyncio.run(stub.prewarm()) is None

    def boom(out_dir, seconds):
        raise RuntimeError("CUPTI unavailable")

    monkeypatch.setattr(t_monitoring, "profile_capture_sync", boom)
    assert asyncio.run(ap.prewarm()) is None and ap.capture_errors == 1
    assert not t_monitoring._PROFILE_ACTIVE
