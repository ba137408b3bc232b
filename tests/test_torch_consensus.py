"""The port's consensus component (`core/consensus.QBFTConsensus` over a
`ConsensusMemNetwork`, with its registry, tracer and `app/qbftdebug`
sniffer) against the JAX package's, on the same `UnsignedDataSet`s.

Each case runs once on each package.  Compared: the decision (by each
validator's hash tree root), `duty_leader`, the sniffer's entries (rule,
round, message type and source, decided, trace and span IDs; not the wall
times), the rendered registry's counters and gauges exactly, and its
histograms by labels and count (their sums and buckets are durations,
which differ between runs).  The undecided case — an instance trimmed
before it decides — must close its span undecided on both.  Plus the
parsigex counters, the equivocation counter and the round-change path.
"""

import asyncio
import json

import numpy as np
import pytest

from charon_tpu.app import monitoring as jmonitoring
from charon_tpu.app import qbftdebug as jqbftdebug
from charon_tpu.app import tracing as jtracing
from charon_tpu.core import consensus as jconsensus
from charon_tpu.core import types as jtypes
from charon_tpu.eth2util import spec as jspec
from charon_tpu_torch.app import monitoring as tmonitoring
from charon_tpu_torch.app import qbftdebug as tqbftdebug
from charon_tpu_torch.app import tracing as ttracing
from charon_tpu_torch.core import consensus as tconsensus
from charon_tpu_torch.core import parsigex as tparsigex
from charon_tpu_torch.core import types as ttypes
from charon_tpu_torch.eth2util import spec as tspec

N = 4

MODS = {
    "jax": dict(monitoring=jmonitoring, qbftdebug=jqbftdebug,
                tracing=jtracing, consensus=jconsensus, types=jtypes,
                spec=jspec),
    "port": dict(monitoring=tmonitoring, qbftdebug=tqbftdebug,
                 tracing=ttracing, consensus=tconsensus, types=ttypes,
                 spec=tspec),
}


def unsigned_sets(m, seed: int, slot: int, nvals: int = 3) -> list[dict]:
    """One UnsignedDataSet a node: the same validators, a block root of
    each node's own (so the decision names its proposer), from `seed`."""
    rng = np.random.default_rng(seed)
    pks = ["0x" + rng.bytes(48).hex() for _ in range(nvals)]
    roots = [rng.bytes(32) for _ in range(N)]
    src = m["spec"].Checkpoint(epoch=slot // 4, root=rng.bytes(32))
    out = []
    for node in range(N):
        uds = {}
        for vi, pk in enumerate(pks):
            data = m["spec"].AttestationData(
                slot=slot, index=vi, beacon_block_root=roots[node],
                source=src, target=m["spec"].Checkpoint(epoch=slot // 4 + 1,
                                                        root=roots[0]))
            defn = m["types"].AttesterDefinition(
                pubkey=pk, slot=slot, validator_index=vi, committee_index=vi,
                committee_length=1, committees_at_slot=nvals,
                validator_committee_index=0)
            uds[pk] = m["types"].AttestationDataUD(data=data, duty=defn)
        out.append(uds)
    return out


def roots_of(unsigned: dict) -> dict:
    return {pk: ud.hash_tree_root() for pk, ud in unsigned.items()}


def render_without_durations(reg) -> list[str]:
    """The registry's Prometheus text with each histogram's bucket and sum
    lines dropped: counters, gauges, TYPE lines and `_count` lines."""
    return [line for line in reg.render().splitlines()
            if "_bucket{" not in line and "_sum" not in line.split(" ")[0]]


def sniffed(sniffer) -> list[dict]:
    doc = json.loads(sniffer.render_json())
    for inst in doc["instances"]:
        inst.pop("started")
        for msg in inst["msgs"]:
            msg.pop("at")
    return doc["instances"]


def decide_case(m, slot: int = 7, dtype: int = 2, seed: int = 5):
    """4 nodes propose their own sets; every node decides; then trim."""
    cons, tracing, mon = m["consensus"], m["tracing"], m["monitoring"]
    duty = m["types"].Duty(slot, m["types"].DutyType(dtype))
    regs = [mon.Registry(const_labels={"node": str(i)}) for i in range(N)]
    tracers = [tracing.Tracer(r) for r in regs]
    sniffers = [m["qbftdebug"].QBFTSniffer() for _ in range(N)]
    sets = unsigned_sets(m, seed, slot)
    decided: dict = {}

    async def main():
        net = cons.ConsensusMemNetwork()
        nodes = [cons.QBFTConsensus(net, i, N, round_timeout_base=5.0,
                                    registry=regs[i], tracer=tracers[i],
                                    sniffer=sniffers[i],
                                    trace_id_fn=tracing.duty_trace_id)
                 for i in range(N)]
        done = [asyncio.Event() for _ in range(N)]
        for i, node in enumerate(nodes):
            async def on_decide(d, unsigned, i=i):
                decided[i] = (str(d), roots_of(unsigned))
                done[i].set()
            node.subscribe(on_decide)
        for i, node in enumerate(nodes):
            await node.propose(duty, sets[i])
        await asyncio.wait_for(asyncio.gather(*(e.wait() for e in done)),
                               10.0)
        await asyncio.sleep(0.05)
        for node in nodes:
            node.trim(duty)
        await asyncio.sleep(0)

    asyncio.run(main())
    spans = [[(s.name, s.trace_id, s.span_id, s.end is not None,
               s.attrs["decided"], s.attrs["rounds"], s.attrs["duty"],
               s.attrs["slot"], s.attrs["nodes"])
              for s in tr.spans if s.name.startswith("consensus/qbft/")]
             for tr in tracers]
    return dict(
        decided=decided,
        leader=[cons.duty_leader(duty, r, N) for r in range(1, 6)],
        proposer_roots=[roots_of(s) for s in sets],
        sniffed=[sniffed(s) for s in sniffers],
        spans=spans,
        trace_id=tracing.duty_trace_id(duty),
        metrics=[render_without_durations(r) for r in regs])


@pytest.mark.parametrize("slot,dtype", [(7, 2), (10, 10)])
def test_decision_sniffer_and_registry_equal_the_jax_consensus(slot, dtype):
    want = decide_case(MODS["jax"], slot, dtype)
    got = decide_case(MODS["port"], slot, dtype)
    assert got == want
    # the decision is the round-1 leader's own set, on every node
    leader = got["leader"][0]
    assert len(got["decided"]) == N
    assert all(roots == got["proposer_roots"][leader]
               for _, roots in got["decided"].values())
    for node_spans in got["spans"]:
        [(name, tid, _, ended, decided, rounds, *_)] = node_spans
        assert (name, tid, ended, decided, rounds) == (
            f"consensus/qbft/{slot}", got["trace_id"], True, True, 1)
    for inst in got["sniffed"]:
        [one] = inst
        assert one["decided"] and one["trace_id"] == got["trace_id"]
    text = "\n".join(got["metrics"][0])
    for family in ("core_qbft_decided_total", "core_qbft_current_round",
                   "core_qbft_leader", "core_qbft_round_duration_seconds",
                   "app_span_duration_seconds"):
        assert family in text, family


def undecided_case(m):
    """One node of 4 proposes and is trimmed before any round times out:
    the span closes undecided after one round, nothing else fires."""
    cons, tracing, mon = m["consensus"], m["tracing"], m["monitoring"]
    duty = m["types"].Duty(9, m["types"].DutyType.PROPOSER)
    reg = mon.Registry()
    tr = tracing.Tracer(reg)

    async def main():
        net = cons.ConsensusMemNetwork()
        node = cons.QBFTConsensus(net, 0, N, round_timeout_base=30.0,
                                  registry=reg, tracer=tr,
                                  trace_id_fn=tracing.duty_trace_id)
        await node.propose(duty, unsigned_sets(m, 3, 9)[0])
        await asyncio.sleep(0.05)
        node.trim(duty)
        # a straggler and a late propose for the trimmed duty are dropped
        await node.propose(duty, unsigned_sets(m, 3, 9)[0])
        await asyncio.sleep(0)
        return sorted(str(d) for d in node._tasks)

    tasks = asyncio.run(main())
    [span] = [(s.name, s.trace_id, s.end is not None, s.attrs["decided"],
               s.attrs["rounds"]) for s in tr.spans]
    return dict(span=span, tasks=tasks,
                metrics=render_without_durations(reg))


def test_trimmed_instance_ends_its_span_undecided_as_the_jax_one():
    want = undecided_case(MODS["jax"])
    got = undecided_case(MODS["port"])
    assert got == want
    assert got["span"][2:] == (True, False, 1) and got["tasks"] == []


def timeout_case(m):
    """A quorumless instance (one live node of 3) times out round after
    round until it is trimmed."""
    cons, tracing, mon = m["consensus"], m["tracing"], m["monitoring"]
    duty = m["types"].Duty(9, m["types"].DutyType.PROPOSER)
    reg = mon.Registry()
    tr = tracing.Tracer(reg)

    async def main():
        net = cons.ConsensusMemNetwork()
        node = cons.QBFTConsensus(net, 0, 3, round_timeout_base=0.05,
                                  round_timeout_inc=0.01, registry=reg,
                                  tracer=tr,
                                  trace_id_fn=tracing.duty_trace_id)
        await node.propose(duty, unsigned_sets(m, 4, 9)[0])
        await asyncio.sleep(0.4)
        node.trim(duty)
        await asyncio.sleep(0)

    asyncio.run(main())
    dl = (("duty", "proposer"),)
    [span] = [s for s in tr.spans]
    return dict(
        families=sorted({(k[0], k[1]) for k in reg._counters}
                        | {(k[0], k[1]) for k in reg._gauges}
                        | {(k[0], k[1]) for k in reg._hist}),
        timeouts=reg._counters[("core_qbft_timeouts_total", dl)],
        changes=reg._counters[("core_qbft_round_changes_total", dl)],
        round=reg._gauges[("core_qbft_current_round", dl)],
        span=(span.end is not None, span.attrs["decided"],
              span.attrs["rounds"]))


def test_round_timeouts_count_as_in_the_jax_consensus():
    """Timer-driven, so the counts depend on the host's timing: both
    packages count ≥ 2 timeouts and as many round changes, into the same
    label sets, and close the span undecided at the round reached."""
    want = timeout_case(MODS["jax"])
    got = timeout_case(MODS["port"])
    assert got["families"] == want["families"]
    for res in (want, got):
        assert res["timeouts"] >= 2 and res["changes"] == res["timeouts"]
        assert res["round"] == 1 + res["timeouts"]
        assert res["span"] == (True, False, res["round"])


def test_leader_rotation_equals_the_jax_duty_leader():
    for slot in range(0, 40, 3):
        for dtype in (1, 2, 10, 13):
            for rnd in range(1, 6):
                for n in (3, 4, 7):
                    jd = jtypes.Duty(slot, jtypes.DutyType(dtype))
                    td = ttypes.Duty(slot, ttypes.DutyType(dtype))
                    assert (tconsensus.duty_leader(td, rnd, n)
                            == jconsensus.duty_leader(jd, rnd, n))


def test_parsigex_counters_and_equivocations():
    """The port's in-memory parsigex counts outbound, inbound and
    equivocating partials per duty type and sender share, with the JAX
    package's names (its per-peer wire-byte families wait for the p2p
    slice)."""
    regs = [tmonitoring.Registry(), tmonitoring.Registry()]
    duty = ttypes.Duty(5, ttypes.DutyType.RANDAO)

    def psd(idx, sig):
        return ttypes.ParSignedData(
            data=ttypes.SignedRandao(epoch=0, signature=sig), share_idx=idx)

    async def main():
        net = tparsigex.MemParSigExNetwork()
        a = net.join(registry=regs[0])
        b = net.join(registry=regs[1])
        got = []

        async def sink(d, p):
            got.append(p)

        b.subscribe(sink)
        await a.broadcast(duty, {"pk": psd(1, b"\x01" * 96)})
        await a.broadcast(duty, {"pk": psd(1, b"\x02" * 96)})
        return got

    assert len(asyncio.run(main())) == 2
    assert regs[0]._counters[
        ("core_parsigex_outbound_total", (("duty", "randao"),))] == 2.0
    assert regs[1]._counters[
        ("core_parsigex_inbound_total", (("duty", "randao"),))] == 2.0
    assert regs[1]._counters[
        ("core_parsigex_equivocations_total", (("peer", "1"),))] == 1.0
    assert not any(k[0].startswith("app_p2p") for k in regs[0]._counters)


def test_round_change_justification_histogram():
    """The round-1 leader stays silent: the others time out, round-change,
    and round 2's PRE-PREPARE carries a quorum-of-ROUND-CHANGEs
    justification, on both packages."""
    out = {}
    for label, m in MODS.items():
        cons, mon = m["consensus"], m["monitoring"]
        reg = mon.Registry()
        duty = m["types"].Duty(11, m["types"].DutyType.ATTESTER)

        async def main():
            net = cons.ConsensusMemNetwork()
            nodes = [cons.QBFTConsensus(net, i, 3, round_timeout_base=0.05,
                                        registry=reg if i == 0 else None)
                     for i in range(3)]
            decided = asyncio.Event()

            async def on_decide(d, unsigned):
                decided.set()

            nodes[0].subscribe(on_decide)
            assert cons.duty_leader(duty, 1, 3) == 2
            for node in nodes[:2]:
                await node.propose(duty, unsigned_sets(m, 6, 11)[0])
            await asyncio.wait_for(decided.wait(), 10.0)
            for node in nodes:
                node.trim(duty)

        asyncio.run(main())
        out[label] = (reg._hist[("core_qbft_justification_msgs", ())].count
                      >= 1,
                      reg._hist[("core_qbft_justification_msgs", ())].bounds,
                      reg._counters[("core_qbft_round_changes_total",
                                     (("duty", "attester"),))] >= 1)
    assert out["port"] == out["jax"] == (
        True, (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0), True)
