"""The port's duty-workflow components against the JAX package's, one
component at a time, on the same inputs: the scheduler's resolved duty
definitions and fired duties over two epochs of a `BeaconMock`, `leader()`,
parsigdb's threshold emission and `EquivocationError`, dutydb's blocking
queries and unique indexes, aggsigdb's write-once store, the fetcher's
per-committee attestation data, validatorapi rejecting a bad partial
through the `BatchVerifier` (real BLS; the port on
`CUDABackend(device="cpu")`), the parsigex equivocation detector and
`wire()`'s edge table.
"""

import asyncio
import dataclasses

import pytest
import torch

torch.set_num_threads(1)

from charon_tpu.core import aggsigdb as jaggsigdb
from charon_tpu.core import dutydb as jdutydb
from charon_tpu.core import fetcher as jfetcher
from charon_tpu.core import interfaces as jinterfaces
from charon_tpu.core import leadercast as jleadercast
from charon_tpu.core import parsigdb as jparsigdb
from charon_tpu.core import parsigex as jparsigex
from charon_tpu.core import scheduler as jscheduler
from charon_tpu.core import types as jtypes
from charon_tpu.core import validatorapi as jvalidatorapi
from charon_tpu.core import verify as jverify
from charon_tpu.eth2util import signing as jsigning
from charon_tpu.eth2util import spec as jspec
from charon_tpu.eth2util import ssz as jssz
from charon_tpu.tbls import api as japi
from charon_tpu.testutil import beaconmock as jbeaconmock
from charon_tpu_torch.core import aggsigdb as paggsigdb
from charon_tpu_torch.core import dutydb as pdutydb
from charon_tpu_torch.core import fetcher as pfetcher
from charon_tpu_torch.core import interfaces as pinterfaces
from charon_tpu_torch.core import leadercast as pleadercast
from charon_tpu_torch.core import parsigdb as pparsigdb
from charon_tpu_torch.core import parsigex as pparsigex
from charon_tpu_torch.core import scheduler as pscheduler
from charon_tpu_torch.core import types as ptypes
from charon_tpu_torch.core import validatorapi as pvalidatorapi
from charon_tpu_torch.core import verify as pverify
from charon_tpu_torch.eth2util import signing as psigning
from charon_tpu_torch.eth2util import spec as pspec
from charon_tpu_torch.eth2util import ssz as pssz
from charon_tpu_torch.tbls import api as tbls
from charon_tpu_torch.tbls import backend_cuda
from charon_tpu_torch.testutil import beaconmock as pbeaconmock

SPE = 4
PUBKEYS = ["0x" + bytes([0xA0 + k]).hex() * 48 for k in range(6)]

#: each side's modules under one set of names
J = dict(types=jtypes, scheduler=jscheduler, beaconmock=jbeaconmock,
         parsigdb=jparsigdb, dutydb=jdutydb, aggsigdb=jaggsigdb,
         fetcher=jfetcher, parsigex=jparsigex, spec=jspec, ssz=jssz)
P = dict(types=ptypes, scheduler=pscheduler, beaconmock=pbeaconmock,
         parsigdb=pparsigdb, dutydb=pdutydb, aggsigdb=paggsigdb,
         fetcher=pfetcher, parsigex=pparsigex, spec=pspec, ssz=pssz)


def _plain(defset: dict) -> dict:
    return {pk: (type(d).__name__, dataclasses.astuple(d))
            for pk, d in defset.items()}


def _key(duty) -> tuple:
    return duty.slot, int(duty.type)


# -- scheduler -----------------------------------------------------------------

def scheduled(m: dict) -> tuple[dict, list]:
    """Two epochs of a BeaconMock through one scheduler: the resolved
    definitions and the duties fired at each slot's tick (fake clock)."""
    bmock = m["beaconmock"].BeaconMock(slot_duration=12.0,
                                       slots_per_epoch=SPE, genesis_time=0.0)
    for pk in PUBKEYS:
        bmock.add_validator(pk)
    fired = []

    async def no_sleep(_):
        return None

    sched = m["scheduler"].Scheduler(bmock, PUBKEYS, clock=lambda: 0.0,
                                     sleep=no_sleep)

    async def on_duty(duty, defset):
        fired.append((_key(duty), _plain(defset)))

    sched.subscribe_duties(on_duty)

    async def run():
        for slot in range(2 * SPE):
            tick = m["types"].SlotTick(slot, 12.0 * slot, 12.0, SPE)
            await sched._resolve_epoch_if_needed(tick)
            sched._schedule_slot_duties(tick)
        await asyncio.gather(*sched._tasks)
        # a duty the epochs did not produce resolves empty
        none = await sched.get_duty_definition(
            m["types"].Duty(2 * SPE - 1, m["types"].DutyType.EXIT))
        return none

    assert asyncio.run(run()) == {}
    defs = {_key(d): _plain(s) for d, s in sched._defs.items()}
    return defs, sorted(fired)


def test_scheduler_resolves_and_fires_as_jax():
    want_defs, want_fired = scheduled(J)
    got_defs, got_fired = scheduled(P)
    assert got_defs == want_defs
    assert got_fired == want_fired
    kinds = {k[1] for k in got_defs}
    assert {int(ptypes.DutyType.ATTESTER), int(ptypes.DutyType.PROPOSER),
            int(ptypes.DutyType.SYNC_MESSAGE)} <= kinds
    assert len(got_fired) >= 2 * SPE      # a proposer a slot at least


def test_scheduler_waits_for_genesis():
    """With the genesis ahead, the port's ticker fires slot 0 at the
    genesis, not at once (the JAX ticker fires it at boot, so a node's VC
    signed slot 0 before its peers were up), and slot 1 a slot later."""
    import time

    genesis = time.time() + 0.5
    bmock = pbeaconmock.BeaconMock(slot_duration=0.25, slots_per_epoch=SPE,
                                   genesis_time=genesis)
    for pk in PUBKEYS:
        bmock.add_validator(pk)
    sched = pscheduler.Scheduler(bmock, PUBKEYS)
    ticks = []

    async def on_slot(tick):
        ticks.append((tick.slot, time.time()))
        if len(ticks) == 2:
            sched.stop()

    sched.subscribe_slots(on_slot)
    asyncio.run(asyncio.wait_for(sched.run(), 10.0))
    assert [s for s, _ in ticks] == [0, 1]
    assert ticks[0][1] >= genesis
    assert ticks[1][1] >= genesis + 0.25


@pytest.mark.parametrize("nodes", [1, 3, 4, 7, 10])
def test_leader_equals_jax(nodes):
    for slot in range(64):
        for dt in ptypes.DutyType:
            got = pleadercast.leader(ptypes.Duty(slot, dt), nodes)
            want = jleadercast.leader(jtypes.Duty(slot, jtypes.DutyType(dt)),
                                      nodes)
            assert got == want


# -- parsigdb ------------------------------------------------------------------

def parsigdb_trace(m: dict) -> list:
    """One sequence of stores into a 3-threshold parsigdb → the events:
    internal fan-outs, threshold emissions (share indices), errors."""
    t = m["types"]
    db = m["parsigdb"].MemParSigDB(3)
    events = []

    async def on_internal(duty, pset):
        events.append(("internal", _key(duty), sorted(pset)))

    async def on_threshold(duty, pk, psigs):
        events.append(("threshold", _key(duty), pk,
                       sorted(p.share_idx for p in psigs),
                       sorted({p.data.epoch for p in psigs})))

    db.subscribe_internal(on_internal)
    db.subscribe_threshold(on_threshold)
    duty = t.Duty(5, t.DutyType.RANDAO)

    def psig(share, epoch=1, sig=None):
        return t.ParSignedData(
            t.SignedRandao(epoch=epoch,
                           signature=sig or bytes([share]) * 96), share)

    steps = [
        ("internal", {PUBKEYS[0]: psig(1), PUBKEYS[1]: psig(1)}),
        ("external", {PUBKEYS[0]: psig(2)}),
        ("external", {PUBKEYS[0]: psig(2)}),                 # duplicate
        ("external", {PUBKEYS[0]: psig(4, epoch=2)}),        # other root
        ("external", {PUBKEYS[1]: psig(3), PUBKEYS[0]: psig(3)}),
        ("external", {PUBKEYS[0]: psig(5)}),                 # past threshold
        ("external", {PUBKEYS[1]: psig(2)}),
        ("external", {PUBKEYS[1]: psig(3, sig=b"\x77" * 96)}),  # equivocates
    ]

    async def run():
        for kind, pset in steps:
            fn = db.store_internal if kind == "internal" else db.store_external
            try:
                await fn(duty, pset)
            except m["parsigdb"].EquivocationError as exc:
                events.append(("equivocation", str(exc)))
        db.trim(duty)
        await db.store_external(duty, {PUBKEYS[0]: psig(6)})

    asyncio.run(run())
    return events


def test_parsigdb_threshold_and_equivocation_equal_jax():
    got, want = parsigdb_trace(P), parsigdb_trace(J)
    assert got == want
    assert sum(e[0] == "threshold" for e in got) == 2
    assert got[-1][0] == "equivocation"


# -- dutydb --------------------------------------------------------------------

def dutydb_trace(m: dict) -> list:
    t, spec, ssz = m["types"], m["spec"], m["ssz"]
    db = m["dutydb"].MemDutyDB()
    out = []
    att_def = t.AttesterDefinition(PUBKEYS[0], 9, 3, 2, 64, 4, 17)
    data = spec.AttestationData(slot=9, index=2, beacon_block_root=b"\x11" * 32,
                                source=spec.Checkpoint(1, b"\x22" * 32),
                                target=spec.Checkpoint(2, b"\x33" * 32))
    block = spec.BeaconBlock(slot=9, proposer_index=3,
                             body_root=b"\x44" * 32)
    agg = spec.Attestation(aggregation_bits=ssz.Bitlist.from_bools([True] * 8),
                           data=data)
    contrib = spec.SyncCommitteeContribution(slot=9,
                                             beacon_block_root=b"\x55" * 32,
                                             subcommittee_index=1)

    async def run():
        waits = [asyncio.ensure_future(c) for c in (
            db.await_attestation(9, 2), db.await_beacon_block(9),
            db.await_agg_attestation(9, data.hash_tree_root()),
            db.await_sync_contribution(9, 1, b"\x55" * 32))]
        await asyncio.sleep(0)
        out.append([w.done() for w in waits])
        await db.store(t.Duty(9, t.DutyType.ATTESTER),
                       {PUBKEYS[0]: t.AttestationDataUD(data, att_def)})
        await db.store(t.Duty(9, t.DutyType.PROPOSER),
                       {PUBKEYS[0]: t.VersionedBeaconBlockUD(block)})
        await db.store(t.Duty(9, t.DutyType.AGGREGATOR),
                       {PUBKEYS[0]: t.AggregatedAttestationUD(agg)})
        await db.store(t.Duty(9, t.DutyType.SYNC_CONTRIBUTION),
                       {PUBKEYS[0]: t.SyncContributionUD(contrib)})
        res = await asyncio.gather(*waits)
        out.append([r.hash_tree_root() for r in res])
        out.append(await db.pubkey_by_attestation(9, 2, 17))
        # a clash for the same slot/committee, a different block, an
        # unsupported duty type: each raises
        for duty, ud in (
                (t.Duty(9, t.DutyType.ATTESTER),
                 t.AttestationDataUD(data.replace(beacon_block_root=bytes(32)),
                                     att_def)),
                (t.Duty(9, t.DutyType.PROPOSER),
                 t.VersionedBeaconBlockUD(block.replace(proposer_index=4))),
                (t.Duty(9, t.DutyType.EXIT), None)):
            try:
                await db.store(duty, {PUBKEYS[0]: ud})
                out.append("stored")
            except m["dutydb"].DutyDBError as exc:
                out.append(str(exc))
        db.trim(t.Duty(9, t.DutyType.ATTESTER))
        try:
            await db.pubkey_by_attestation(9, 2, 17)
        except m["dutydb"].DutyDBError as exc:
            out.append(str(exc))

    asyncio.run(run())
    return out


def test_dutydb_await_store_and_clash_equal_jax():
    got, want = dutydb_trace(P), dutydb_trace(J)
    assert got == want
    assert got[0] == [False] * 4 and got[2] == PUBKEYS[0]


def test_aggsigdb_write_once_and_await_equal_jax():
    def trace(m):
        t = m["types"]
        db = m["aggsigdb"].MemAggSigDB()
        duty = t.Duty(3, t.DutyType.RANDAO)
        out = []

        async def run():
            w = asyncio.ensure_future(db.await_(duty, PUBKEYS[0]))
            await asyncio.sleep(0)
            out.append(w.done())
            await db.store(duty, PUBKEYS[0], t.SignedRandao(0, b"\x01" * 96))
            out.append((await w).signature)
            await db.store(duty, PUBKEYS[0], t.SignedRandao(0, b"\x01" * 96))
            try:
                await db.store(duty, PUBKEYS[0],
                               t.SignedRandao(0, b"\x02" * 96))
            except m["aggsigdb"].AggSigDBError as exc:
                out.append(str(exc))
            db.trim(duty)
            w = asyncio.ensure_future(db.await_(duty, PUBKEYS[0]))
            await asyncio.sleep(0)
            out.append(w.done())
            w.cancel()

        asyncio.run(run())
        return out

    assert trace(P) == trace(J)


def test_fetcher_attestation_data_per_committee_equals_jax():
    def trace(m):
        t = m["types"]
        bmock = m["beaconmock"].BeaconMock(slots_per_epoch=SPE,
                                           genesis_time=0.0)
        queries = []
        real = bmock.attestation_data

        async def counted(slot, comm):
            queries.append((slot, comm))
            return await real(slot, comm)

        bmock.attestation_data = counted
        f = m["fetcher"].Fetcher(bmock)
        got = []

        async def sub(duty, unsigned):
            got.append((_key(duty), {pk: (ud.data.hash_tree_root(),
                                          ud.duty.validator_index)
                                     for pk, ud in unsigned.items()}))

        f.subscribe(sub)
        defset = {pk: t.AttesterDefinition(pk, 6, k, k % 2, 64, 4, k)
                  for k, pk in enumerate(PUBKEYS)}
        asyncio.run(f.fetch(t.Duty(6, t.DutyType.ATTESTER), defset))
        return queries, got

    got, want = trace(P), trace(J)
    assert got == want
    assert got[0] == [(6, 0), (6, 1)]     # one query a committee


# -- validatorapi through the BatchVerifier --------------------------------------

def vapi_trace(side: str, verifier, cluster) -> list:
    """A good and a bad attestation partial submitted in one tick through
    one ValidatorAPI wired to `verifier`: what was pushed and what was
    raised."""
    t, spec, ssz, sig_mod, api, vmod = (
        (ptypes, pspec, pssz, psigning, tbls, pvalidatorapi) if side == "port"
        else (jtypes, jspec, jssz, jsigning, japi, jvalidatorapi))
    gpk, shares, pubshares = cluster
    vapi = vmod.ValidatorAPI(share_idx=1, pubshare_by_group={gpk: pubshares[1]},
                             fork_version=bytes(4), slots_per_epoch=SPE,
                             verifier=verifier)
    pushed, out = [], []

    async def by_att(slot, comm, pos):
        return gpk

    async def sub(duty, pset):
        pushed.append((_key(duty), sorted(pset),
                       [p.share_idx for p in pset.values()]))

    vapi.register_pubkey_by_attestation(by_att)
    vapi.subscribe(sub)
    data = spec.AttestationData(slot=7, index=1, beacon_block_root=b"\x66" * 32,
                                target=spec.Checkpoint(1, b"\x66" * 32))
    root = sig_mod.signing_root(sig_mod.DomainName.BEACON_ATTESTER,
                                data.hash_tree_root(), bytes(4))
    bits = ssz.Bitlist.from_bools([False, False, True, False])
    good = spec.Attestation(bits, data, api.sign(shares[1], root))
    bad = spec.Attestation(bits, data, api.sign(shares[2], root))

    async def run():
        res = await asyncio.gather(vapi.submit_attestations([good]),
                                   vapi.submit_attestations([bad]),
                                   return_exceptions=True)
        out.extend(type(r).__name__ if r is not None else None for r in res)

    asyncio.run(run())
    return out + pushed


def test_validatorapi_rejects_a_bad_partial_through_the_batch_verifier():
    japi.set_scheme("bls")
    tss, shares = japi.generate_tss(2, 2, seed=b"charon-tpu-torch vapi")
    cluster = ("0x" + tss.group_pubkey.hex(), shares,
               {i: tss.public_share(i) for i in shares})
    want = vapi_trace("jax", jverify.BatchVerifier(), cluster)
    be = backend_cuda.CUDABackend(device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbls, "_BACKENDS", dict(tbls._BACKENDS))
        mp.setattr(tbls, "_current_name", tbls._current_name)
        tbls.register_backend("cuda", be)
        tbls.set_backend("cuda")
        verifier = pverify.BatchVerifier()
        got = vapi_trace("port", verifier, cluster)
        path = tbls.verify_path(2)
    assert got == want
    assert got[:2] == [None, "VapiError"]
    assert got[2:] == [((7, int(ptypes.DutyType.ATTESTER)), [cluster[0]], [1])]
    # both partials went through ONE flush of the port's cuda route
    assert verifier.launches == 1 and verifier.max_batch == 2
    assert verifier.paths == {path: 1} and path.startswith("cuda")


# -- parsigex ------------------------------------------------------------------

def equivocation_trace(m: dict) -> list:
    t = m["types"]
    det = m["parsigex"].EquivocationDetector(max_duties=2)
    out = []

    def pset(share, sig, pk=PUBKEYS[0]):
        return {pk: t.ParSignedData(t.SignedRandao(1, sig), share)}

    d1, d2, d3 = (t.Duty(s, t.DutyType.RANDAO) for s in (1, 2, 3))
    for duty, ps in (
            (d1, pset(1, b"\x01" * 96)), (d1, pset(1, b"\x01" * 96)),
            (d1, pset(1, b"\x02" * 96)), (d1, pset(2, b"\x02" * 96)),
            (d1, pset(2, b"\x03" * 96, PUBKEYS[1])),
            (d2, pset(1, b"\x09" * 96)), (d3, pset(1, b"\x09" * 96)),
            # d1 was evicted (max 2 duties): its pin is gone
            (d1, pset(1, b"\x05" * 96)), (d1, pset(1, b"\x06" * 96))):
        out.append(det.check(duty, ps))
    det.trim(d1)
    out.append(det.check(d1, pset(1, b"\x07" * 96)))
    out.append(det.equivocations)
    return out


def test_parsigex_equivocation_detector_equals_jax():
    got, want = equivocation_trace(P), equivocation_trace(J)
    assert got == want
    assert got[-1] == 2


def test_parsigex_inbound_runs_verify_before_subscribers():
    """A raising verify hook stops delivery; the detector pins only what
    passed (the JAX package's order)."""
    def trace(m):
        t = m["types"]
        net = m["parsigex"].MemParSigExNetwork()
        seen = []

        async def verify(duty, pset):
            if any(p.share_idx == 9 for p in pset.values()):
                raise ValueError("bad partial")

        a, b = net.join(), net.join(verify_fn=verify)

        async def sub(duty, pset):
            seen.append(sorted(p.share_idx for p in pset.values()))

        b.subscribe(sub)
        duty = t.Duty(1, t.DutyType.RANDAO)

        async def run():
            await a.broadcast(duty, {PUBKEYS[0]: t.ParSignedData(
                t.SignedRandao(1, b"\x01" * 96), 1)})
            try:
                await a.broadcast(duty, {PUBKEYS[0]: t.ParSignedData(
                    t.SignedRandao(1, b"\x02" * 96), 9)})
            except ValueError as exc:
                seen.append(str(exc))

        asyncio.run(run())
        return seen, b._equiv.equivocations

    assert trace(P) == trace(J) == ([[1], "bad partial"], 0)


# -- wire ----------------------------------------------------------------------

class _Stub:
    """Records every hook registration: (this.method, that.method)."""

    def __init__(self, name: str, edges: list):
        self._name, self._edges = name, edges

    def __getattr__(self, method: str):
        if method.startswith("_"):
            raise AttributeError(method)
        name, edges = self._name, self._edges

        def hook(fn=None, *rest):
            if fn is not None:
                edges.append((f"{name}.{method}", fn.__qualname__))
        hook.__qualname__ = f"{name}.{method}"
        return hook


def wire_edges(mod) -> tuple[list, list]:
    edges, keys = [], []
    names = ("sched", "fetch", "cons", "dutydb", "vapi", "parsigdb",
             "parsigex", "sigagg", "aggsigdb", "bcast")
    mod.wire(*(_Stub(n, edges) for n in names),
             lambda w: keys.extend(w))
    return keys, edges


def test_wire_edge_table_equals_jax():
    got_keys, got_edges = wire_edges(pinterfaces)
    want_keys, want_edges = wire_edges(jinterfaces)
    assert got_keys == want_keys and len(got_keys) == 33
    assert got_edges == want_edges and len(got_edges) == 18
