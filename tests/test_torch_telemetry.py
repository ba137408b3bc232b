"""The port's telemetry against the JAX package's: `app/monitoring`'s
registry, `app/tracing`, `core/tracker`, `core/slotbudget`,
`core/deadline`, `core/background`'s error counter and the dispatch stage
histograms with the `cuda/*` spans.

Each pure-host case feeds the same sequence (the same calls, an injected
clock) to both packages and compares the results exactly: reports,
phases, the order of expiries, and the registries' Prometheus text byte
for byte.  The device-boundary case runs one verify flush and one combine
of the port's `CUDABackend(device="cpu")` through `DispatchPipeline` and
checks the stage histograms, the graph-capture family and the spans'
attributes; the same flush and combine under the insecure-test scheme on
both packages give the same attribute and label sets.
"""

import asyncio
import threading

import pytest
import torch

# one intra-op thread: the suite runs several workers on the same cores
torch.set_num_threads(1)

from charon_tpu.app import monitoring as jmonitoring
from charon_tpu.app import tracing as jtracing
from charon_tpu.core import background as jbackground
from charon_tpu.core import deadline as jdeadline
from charon_tpu.core import sigagg as jsigagg
from charon_tpu.core import slotbudget as jslotbudget
from charon_tpu.core import tracker as jtracker
from charon_tpu.core import types as jtypes
from charon_tpu.core import verify as jverify
from charon_tpu.tbls import api as japi
from charon_tpu.tbls import dispatch as jdispatch
from charon_tpu_torch.app import monitoring as tmonitoring
from charon_tpu_torch.app import tracing as ttracing
from charon_tpu_torch.core import background as tbackground
from charon_tpu_torch.core import deadline as tdeadline
from charon_tpu_torch.core import sigagg as tsigagg
from charon_tpu_torch.core import slotbudget as tslotbudget
from charon_tpu_torch.core import tracker as ttracker
from charon_tpu_torch.core import types as ttypes
from charon_tpu_torch.core import verify as tverify
from charon_tpu_torch.tbls import api as tapi
from charon_tpu_torch.tbls import backend_cuda
from charon_tpu_torch.tbls import dispatch as tdispatch

MODS = {
    "jax": dict(monitoring=jmonitoring, tracing=jtracing, tracker=jtracker,
                slotbudget=jslotbudget, deadline=jdeadline, types=jtypes,
                background=jbackground, dispatch=jdispatch,
                verify=jverify, sigagg=jsigagg, api=japi),
    "port": dict(monitoring=tmonitoring, tracing=ttracing, tracker=ttracker,
                 slotbudget=tslotbudget, deadline=tdeadline, types=ttypes,
                 background=tbackground, dispatch=tdispatch,
                 verify=tverify, sigagg=tsigagg, api=tapi),
}


def both(fn):
    """fn(module dict) on each package → (jax result, port result)."""
    return fn(MODS["jax"]), fn(MODS["port"])


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# -- the registry ------------------------------------------------------------

def registry_sequence(m) -> str:
    reg = m["monitoring"].Registry(const_labels={"cluster": "c\"1",
                                                 "node": "n0"})
    reg.inc("core_x_total")
    reg.inc("core_x_total", 2.5, labels={"duty": "attester"})
    reg.inc("core_x_total", labels={"duty": 'we"ird\\\nlabel'})
    reg.set_gauge("core_y", 3.0)
    reg.set_gauge("core_y", -1.25, labels={"peer": "2"})
    reg.set_buckets("core_count_msgs", (8, 1, 2, 4))
    for v in (0, 1, 3, 3, 9, 100):
        reg.observe("core_count_msgs", float(v))
    for v in (0.0005, 0.02, 0.3, 7.0, 50.0):
        reg.observe("core_lat_seconds", v, labels={"phase": "fetcher"})
    reg.observe("core_lat_seconds", 0.004, labels={"phase": "bcast"})
    m["monitoring"].set_readiness(reg, "syncing")
    m["monitoring"].set_readiness(reg, "weird_reason")
    return reg.render()


def test_registry_renders_byte_equal_to_the_jax_registry():
    want, got = both(registry_sequence)
    assert got == want
    assert '# TYPE core_lat_seconds histogram' in got
    assert 'le="+Inf"' in got and 'le="8"' in got


def test_registry_thread_safe_under_concurrent_writers():
    """Writes from several threads while another renders: no lost
    increments, no error from a dict growing mid-render (the dispatch
    stages write from the loop while a scrape renders)."""
    reg = tmonitoring.Registry()
    n, t = 500, 4
    errors = []

    def writer(w):
        for k in range(n):
            reg.inc("app_rt_total")
            reg.observe("app_rt_seconds", 0.001 * k, labels={"w": str(w)})

    def renderer():
        for _ in range(50):
            try:
                reg.render()
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)
                return

    threads = ([threading.Thread(target=writer, args=(w,))
                for w in range(t)] + [threading.Thread(target=renderer)])
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not errors, errors
    assert reg._counters[reg._key("app_rt_total", None)] == n * t
    assert sum(reg._hist[reg._key("app_rt_seconds", {"w": str(w)})].count
               for w in range(t)) == n * t


# -- the tracer --------------------------------------------------------------

def tracer_sequence(m):
    tracing = m["tracing"]
    reg = m["monitoring"].Registry()
    tr = tracing.Tracer(reg, max_spans=3)
    seen = []
    tr.add_sink(lambda span: seen.append(span.name))

    def broken(span):
        raise OSError("disk full")

    duty = m["types"].Duty(3, m["types"].DutyType.ATTESTER)
    with tr.start_span("outer", trace_id=tracing.duty_trace_id(duty)):
        with tr.start_span("inner", k=1) as inner:
            inner.attrs["x"] = 2
    tr.add_sink(broken)
    for k in range(3):
        with tr.start_span(f"wrap{k}"):
            pass
    with pytest.raises(ValueError):
        with tr.start_span("fails"):
            raise ValueError("boom")
    lone = tr.start_span("lone", trace_id="ab" * 16).span
    tr.end_span(lone, decided=False, rounds=2)
    ring = [(s.name, s.trace_id, s.span_id, s.parent_id, s.attrs)
            for s in tr.spans]
    text = [ln for ln in reg.render().splitlines()
            if "_bucket{" not in ln and "_sum" not in ln.split(" ")[0]]
    return dict(ring=ring, dropped=tr.dropped, sink_errors=tr.sink_errors,
                seen=seen, trace=[s.name for s in tr.trace("ab" * 16)],
                tid=tracing.duty_trace_id(duty), metrics=text)


def test_tracer_ring_wrap_drops_and_failing_sink_equal_the_jax_tracer():
    want, got = both(tracer_sequence)
    assert got == want
    assert got["dropped"] == 4 and got["sink_errors"] == 5
    assert [r[0] for r in got["ring"]] == ["wrap2", "fails", "lone"]
    assert got["ring"][1][4]["error"] == "ValueError('boom')"
    assert "charon_tpu_tracer_dropped_spans_total 4.0" in got["metrics"]


def wire_sequence(m):
    """`with_tracing` wraps every duty edge in a ``core/<edge>`` span on
    the duty's trace."""
    tracing = m["tracing"]
    tr = tracing.Tracer(max_spans=64)
    edges = ["fetcher_fetch", "consensus_propose", "dutydb_store",
             "parsigdb_store_internal", "parsigdb_store_external",
             "parsigex_broadcast", "sigagg_aggregate", "aggsigdb_store",
             "broadcaster_broadcast"]
    calls = []
    w = {}
    for e in edges:
        async def fn(duty, *args, e=e):
            calls.append((e, str(duty), args))
            return e
        w[e] = fn
    tracing.with_tracing(tr)(w)
    duty = m["types"].Duty(12, m["types"].DutyType.SYNC_MESSAGE)

    async def main():
        return [await w[e](duty, 1, "x") for e in edges]

    out = asyncio.run(main())
    return out, calls, [(s.name, s.trace_id, s.attrs) for s in tr.spans]


def test_with_tracing_equals_the_jax_wire_option():
    want, got = both(wire_sequence)
    assert got == want
    assert len(got[2]) == 9 and got[2][0][0] == "core/fetcher_fetch"


# -- tracker, slot budget, deadliner -----------------------------------------

def _psd(m, idx: int, sig: bytes = b"\x01" * 96):
    t = m["types"]
    return t.ParSignedData(data=t.SignedRandao(epoch=0, signature=sig),
                           share_idx=idx)


def tracker_sequence(m):
    t = m["types"]
    clock = FakeClock(100.0)
    reg = m["monitoring"].Registry(const_labels={"node": "1"})
    tr = m["tracker"].Tracker(num_peers=4, threshold=3, registry=reg,
                              slot_start_fn=lambda slot: 100.0 + 12 * slot,
                              clock=clock)
    subs = []

    async def sub(report):
        subs.append(str(report.duty))

    tr.subscribe(sub)
    att, prop = t.Duty(1, t.DutyType.ATTESTER), t.Duty(2, t.DutyType.PROPOSER)
    randao, sync = t.Duty(2, t.DutyType.RANDAO), t.Duty(3,
                                                        t.DutyType.SYNC_MESSAGE)
    stray = t.Duty(9, t.DutyType.ATTESTER)

    async def main():
        clock.t = 112.5
        await tr.on_duty_scheduled(att, {})
        await tr.on_fetched(att, {})
        await tr.on_consensus(att, {})
        await tr.on_parsig_internal(att, {"pk1": _psd(m, 1)})
        for i in (2, 3, 4):
            await tr.on_parsig_external(att, {"pk1": _psd(m, i)})
        await tr.on_threshold(att, "pk1", [])
        clock.t = 117.25
        await tr.on_aggregated(att, "pk1", None)
        clock.t = 118.0
        await tr.on_aggregated(att, "pk1", None)     # first one counts
        await tr.on_duty_scheduled(prop, {})
        await tr.on_fetched(prop, {})                # consensus never ends
        await tr.on_parsig_internal(randao, {"pk1": _psd(m, 1)})
        await tr.on_parsig_external(randao, {"pk1": _psd(m, 2)})
        await tr.on_threshold(randao, "pk1", [])
        await tr.on_aggregated(randao, "pk1", None)
        await tr.on_parsig_internal(sync, {"pk2": _psd(m, 1)})
        await tr.on_parsig_external(sync, {"pk2": _psd(m, 3)})
        await tr.on_parsig_external(stray, {"pk3": _psd(m, 4)})
        unexpected = sorted(tr.unexpected_participants(stray))
        reports = [await tr.analyse(d) for d in (att, prop, randao, sync)]
        return unexpected, reports

    unexpected, reports = asyncio.run(main())
    return dict(
        unexpected=unexpected, subs=subs,
        expected={int(dt): [int(s) for s in m["tracker"].expected_steps(dt)]
                  for dt in t.DutyType},
        reports=[(str(r.duty), r.success,
                  None if r.failed_step is None else r.failed_step.name,
                  r.reason, r.participation) for r in reports],
        counts=dict(tr.participation_counts), total=tr.duty_total,
        render=reg.render())


def test_tracker_reports_and_families_equal_the_jax_tracker():
    want, got = both(tracker_sequence)
    assert got == want
    ok = [r for r in got["reports"] if r[1]]
    assert [r[0] for r in ok] == ["1/attester", "2/randao"]
    assert got["reports"][1][2] == "CONSENSUS"
    assert got["unexpected"] == [4]
    assert "charon_tpu_tracker_inclusion_delay_sum" in got["render"]


def slotbudget_sequence(m):
    t = m["types"]
    clock = FakeClock()
    reg = m["monitoring"].Registry()
    sb = m["slotbudget"].SlotBudget(registry=reg,
                                    slot_start_fn=lambda slot: 12.0 * slot,
                                    budget_seconds=12.0, clock=clock)
    late = []
    sb.subscribe_late(lambda duty, phase: late.append((str(duty), phase)))

    def boom(duty, phase):
        raise RuntimeError("hook failure is swallowed")

    sb.subscribe_late(boom)
    on_time = t.Duty(1, t.DutyType.ATTESTER)
    slow = t.Duty(2, t.DutyType.ATTESTER)
    stuck = t.Duty(3, t.DutyType.SYNC_MESSAGE)
    randao = t.Duty(3, t.DutyType.RANDAO)

    async def main():
        for duty, marks in (
                (on_time, [("sched", 16.0), ("fetch", 16.5), ("cons", 18.0),
                           ("thr", 18.25), ("agg", 18.75), ("bc", 19.0)]),
                (slow, [("sched", 28.0), ("fetch", 28.5), ("cons", 39.0),
                        ("thr", 39.5), ("agg", 40.0), ("bc", 40.5)]),
                (stuck, [("thr", 37.0)]),
                (randao, [("thr", 36.5), ("agg", 36.75)])):
            hooks = {
                "sched": lambda: sb.on_duty_scheduled(duty, {}),
                "fetch": lambda: sb.on_fetched(duty, {}),
                "cons": lambda: sb.on_consensus(duty, {}),
                "thr": lambda: sb.on_threshold(duty, "pk", []),
                "agg": lambda: sb.on_aggregated(duty, "pk", None),
                "bc": lambda: sb.on_broadcast(duty, "pk", None),
            }
            for name, at in marks:
                clock.t = at
                await hooks[name]()

    asyncio.run(main())
    phases = [sb.finalize(d) for d in (on_time, slow, stuck, randao)]
    return dict(phases=phases, late=late, late_duties=sb.late_duties,
                again=sb.finalize(on_time),
                expected={int(dt): m["slotbudget"].expected_phases(dt)
                          for dt in t.DutyType},
                render=reg.render())


def test_slot_budget_phases_and_late_verdicts_equal_the_jax_budget():
    want, got = both(slotbudget_sequence)
    assert got == want
    assert got["phases"][0] == {"scheduler": 4.0, "fetcher": 0.5,
                                "consensus": 1.5, "parsig_ex": 0.25,
                                "sigagg": 0.5, "bcast": 0.25}
    assert got["late"] == [("2/attester", "consensus"),
                           ("3/sync_message", "sigagg")]
    assert got["again"] is None


def deadline_sequence(m):
    t = m["types"]
    clock = FakeClock(0.0)
    dl_fn = (lambda d: m["deadline"].duty_deadline(d, genesis_time=0.0,
                                                   slot_duration=1.0))

    async def main():
        dl = m["deadline"].Deadliner(dl_fn, clock=clock)
        dl.start()
        added = [dl.add(t.Duty(s, ty)) for s, ty in (
            (3, t.DutyType.ATTESTER), (1, t.DutyType.SYNC_MESSAGE),
            (2, t.DutyType.PROPOSER), (1, t.DutyType.SYNC_MESSAGE),
            (0, t.DutyType.EXIT), (1, t.DutyType.ATTESTER))]
        got = []

        async def drain():
            async for duty in dl.expired():
                got.append((clock.t, str(duty)))

        task = asyncio.get_running_loop().create_task(drain())
        for now in (5.5, 6.0, 7.0, 9.0, 1e6):
            clock.t = now
            dl.poke()
            for _ in range(5):
                await asyncio.sleep(0)
        late = dl.add(t.Duty(1, t.DutyType.PROPOSER))   # already past
        dl.stop()
        task.cancel()
        return added, late, got

    added, late, got = asyncio.run(main())
    return dict(added=added, late=late, expired=got,
                exit=m["deadline"].duty_deadline(
                    t.Duty(0, t.DutyType.EXIT), 0.0, 12.0))


def test_deadliner_order_under_an_injected_clock_equals_the_jax_one():
    want, got = both(deadline_sequence)
    assert got == want
    assert [d for _, d in got["expired"]] == [
        "1/sync_message", "1/attester", "2/proposer", "3/attester"]
    assert got["late"] is False and got["exit"] == float("inf")


def background_sequence(m):
    reg = m["monitoring"].Registry()
    m["dispatch"].add_metrics_registry(reg)
    try:
        async def fails():
            raise RuntimeError("flusher died")

        async def ok():
            return 1

        async def main():
            tasks = [m["background"].spawn(fails(), name="test-flush"),
                     m["background"].spawn(ok(), name="test-ok")]
            await asyncio.gather(*tasks, return_exceptions=True)
            await asyncio.sleep(0)
            return m["background"].pending_count()

        pending = asyncio.run(main())
    finally:
        m["dispatch"].remove_metrics_registry(reg)
    return pending, dict(reg._counters), reg in m["dispatch"].metrics_registries()


def test_background_error_counter_equals_the_jax_one():
    want, got = both(background_sequence)
    assert got == want
    assert got[1] == {("app_background_task_errors_total",
                       (("task", "test-flush"),)): 1.0}


# -- monitoring probes -------------------------------------------------------

def test_device_memory_sampler_reads_the_card_or_counts_its_failure(
        monkeypatch):
    reg = tmonitoring.Registry()
    # a backend on the CPU has no device memory: nothing is written
    assert tmonitoring.sample_hbm_live_bytes(reg, torch.device("cpu")) is None
    assert tmonitoring.sample_hbm_live_bytes(reg) is None
    assert "charon_tpu_hbm_live_bytes" not in reg.render()
    seen = []

    def allocated(dev):
        seen.append(dev)
        return 123456

    monkeypatch.setattr(torch.cuda, "memory_allocated", allocated)
    card = torch.device("cuda", 0)
    assert tmonitoring.sample_hbm_live_bytes(reg, card) == 123456
    assert seen == [card]
    assert reg._gauges[("charon_tpu_hbm_live_bytes", ())] == 123456

    def broken(dev):
        raise RuntimeError("CUDA error: device lost")

    monkeypatch.setattr(torch.cuda, "memory_allocated", broken)
    with pytest.raises(RuntimeError):
        tmonitoring.sample_hbm_live_bytes(reg, card)
    # the failed read is counted, and the last good sample stays
    assert reg._counters[("charon_tpu_hbm_sample_errors_total", ())] == 1.0
    assert reg._gauges[("charon_tpu_hbm_live_bytes", ())] == 123456

    async def loop_once():
        task = asyncio.get_running_loop().create_task(
            tmonitoring.hbm_sample_loop(reg, interval=10.0, device=card))
        await asyncio.sleep(0.1)
        task.cancel()

    asyncio.run(loop_once())      # the loop survives a failing read
    assert reg._counters[("charon_tpu_hbm_sample_errors_total", ())] == 2.0


def test_loop_lag_probe_exports_lag_depth_and_overlap():
    reg = tmonitoring.Registry()
    pipe = tdispatch.DispatchPipeline()
    breaches = []

    async def main():
        task = asyncio.get_running_loop().create_task(
            tmonitoring.loop_lag_probe(reg, interval=0.005, dispatcher=pipe,
                                       lag_slo=0.0,
                                       on_breach=breaches.append))
        loop = asyncio.get_running_loop()
        t_end = loop.time() + 10.0
        hist = ("app_event_loop_lag_seconds", ())
        while loop.time() < t_end and (
                hist not in reg._hist or reg._hist[hist].count < 25):
            await asyncio.sleep(0.02)
        task.cancel()

    try:
        asyncio.run(main())
    finally:
        pipe.shutdown()
    key = ("app_event_loop_lag_seconds", ())
    assert reg._hist[key].count >= 20
    assert reg._hist[key].bounds == tmonitoring.LOOP_LAG_BUCKETS
    assert reg._gauges[("app_dispatch_queue_depth", ())] == 0
    assert reg._gauges[("core_dispatch_overlap_efficiency", ())] == 0.0
    assert breaches and set(breaches) == {"loop_lag"}


# -- the dispatch stages and the cuda/* spans --------------------------------

@pytest.fixture
def port_backend(monkeypatch):
    """The port's "cuda" backend on the CPU, validators padded to 8."""
    monkeypatch.setattr(backend_cuda, "ROW_TILE", 8)
    monkeypatch.setattr(tapi, "_BACKENDS", dict(tapi._BACKENDS))
    monkeypatch.setattr(tapi, "_current_name", tapi._current_name)
    be = backend_cuda.CUDABackend(device="cpu")
    tapi.register_backend("cuda", be)
    tapi.set_backend("cuda")
    tapi.set_scheme("bls")
    yield be


def flush_and_combine(m, entries, sig_sets, threshold: int):
    """One verify flush and one combine through the package's pipeline,
    each spanned, with a fresh registry on the fan-out → (verdicts,
    combined, spans, registry, the pipeline's stage_stats)."""
    reg = m["monitoring"].Registry()
    tr = m["tracing"].Tracer(reg)
    pipe = m["dispatch"].DispatchPipeline()
    m["dispatch"].add_metrics_registry(reg)
    t = m["types"]
    out = {}
    try:
        async def main():
            verifier = m["verify"].BatchVerifier(tracer=tr, dispatcher=pipe)
            oks = await verifier.verify_many(entries)
            agg = m["sigagg"].SigAgg(threshold, tracer=tr, dispatcher=pipe)

            async def sub(duty, pk, signed):
                out[pk] = signed.signature

            agg.subscribe(sub)
            await asyncio.gather(*[
                agg.aggregate(t.Duty(3, t.DutyType.RANDAO), f"0x{v:096x}",
                              [t.ParSignedData(t.SignedRandao(1, s), i)
                               for i, s in sigs.items()])
                for v, sigs in enumerate(sig_sets)])
            return oks

        oks = asyncio.run(main())
    finally:
        m["dispatch"].remove_metrics_registry(reg)
        stats = pipe.stage_stats()
        pipe.shutdown()
    combined = [out[f"0x{v:096x}"] for v in range(len(sig_sets))]
    spans = {s.name: s.attrs for s in tr.spans}
    return oks, combined, spans, reg, stats


def stage_labels(reg) -> dict:
    return {dict(k[1])["op"] + "/" + dict(k[1])["stage"]: h.count
            for k, h in reg._hist.items()
            if k[0] == "core_dispatch_stage_seconds"}


def test_cpu_flush_and_combine_record_stages_and_spans(port_backend):
    """A 2-entry verify flush and a 1-validator 2-of-3 combine on the
    port's backend, on the CPU, through `DispatchPipeline`."""
    tss, shares = tapi.generate_tss(2, 3, seed=b"telemetry")
    msg = b"charon-tpu-torch telemetry"
    sigs = {i: tapi.sign(shares[i], msg) for i in (1, 3)}
    entries = [(tss.public_share(i), msg, sigs[i]) for i in (1, 3)]
    oks, combined, spans, reg, stats = flush_and_combine(
        MODS["port"], entries, [sigs], 2)
    assert oks == [True, True]
    assert combined == [tapi.aggregate(sigs)]

    # every stage of both ops in the histograms, once each (1 tile each)
    assert stage_labels(reg) == {f"{op}/{st}": 1 for op in ("verify",
                                                            "combine")
                                 for st in tdispatch.STAGES}
    assert reg._hist[("core_dispatch_stage_seconds",
                      (("op", "verify"), ("stage", "device_exec")))].sum > 0
    # the CPU route captures no graph: the family's buckets are set, no
    # sample taken
    assert ("app_cuda_graph_capture_seconds", ()) not in reg._hist
    assert (reg._buckets["app_cuda_graph_capture_seconds"]
            == tdispatch.GRAPH_CAPTURE_BUCKETS)
    assert stats["launches"] == 2 and stats["tiles"] == 2
    assert stats["verify_rows"] == 2 and stats["queue_depth"] == 0
    assert set(stats["stage_seconds"]) == {
        f"{op}/{st}" for op in ("verify", "combine") for st in tdispatch.STAGES}

    v = spans["cuda/batch_verify"]
    assert (v["batch"], v["path"], v["padded_rows"], v["coalesced_calls"],
            v["tiles"], v["queue_depth"]) == (
        2, tapi.verify_path(2), tapi.verify_padded_rows(2), 1, 1, 0)
    c = spans["cuda/threshold_combine"]
    assert (c["batch"], c["t"], c["path"], c["padded_rows"]) == (
        1, 2, tapi.combine_path(), tapi.combine_padded_rows(1, 2))
    for attrs in (v, c):
        assert {f"{st}_s" for st in tdispatch.STAGES} <= set(attrs)
        assert attrs["device_exec_s"] > 0

    # the scrape-time exports read the backend without creating one
    tmonitoring.export_devcache_metrics(reg)
    tmonitoring.export_dispatch_metrics(reg)
    g = reg._gauges
    assert g[("charon_tpu_devcache_resident", ())] == 0.0
    assert g[("charon_tpu_devcache_misses_total", (("cache", "pk"),))] == 2
    assert g[("charon_tpu_devcache_rows", (("cache", "hm"),))] == 1
    assert ("app_cuda_graphs_total", ()) in g


@pytest.fixture
def insecure_scheme():
    tapi.set_scheme("insecure-test")
    japi.set_scheme("insecure-test")
    yield
    tapi.set_scheme("bls")
    japi.set_scheme("bls")


def test_stage_families_and_span_attrs_match_the_jax_names(insecure_scheme):
    """The same flush and combine under the insecure-test scheme on both
    packages: the same stage labels and counts, and span attributes of
    the same names on the renamed spans (``tpu/*`` → ``cuda/*``)."""
    res = {}
    for label, m in MODS.items():
        api = m["api"]
        sks = [5, 7, 11]
        msg = b"stage names"
        entries = [(api._InsecureScheme.sk_to_pk(sk), msg,
                    api._InsecureScheme.sign(sk, msg)) for sk in sks]
        sigs = {i: api._InsecureScheme.sign(sks[i - 1], msg) for i in (1, 2)}
        oks, combined, spans, reg, _ = flush_and_combine(m, entries, [sigs],
                                                         2)
        res[label] = (oks, combined, stage_labels(reg),
                      {name.split("/")[1]: sorted(attrs)
                       for name, attrs in spans.items()},
                      sorted(spans))
    assert res["port"][:4] == res["jax"][:4]
    assert res["jax"][4] == ["tpu/batch_verify", "tpu/threshold_combine"]
    assert res["port"][4] == ["cuda/batch_verify", "cuda/threshold_combine"]
