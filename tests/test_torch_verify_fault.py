"""A verify flush that raises while it holds two partials of one validator
from two peers, in both packages (ROADMAP §C-2).

A 4-node, 3-of-4 in-process cluster (insecure-test scheme, leadercast,
attester duties only), built from the same seed for the JAX `Node` and the
port's.  Node 4's `BatchVerifier` runs its flushes through a pipeline that
holds each flush 50 ms (so peers' parsigex messages pack into one flush)
and raises once, on the first flush with partials of one validator from
two different peers.  Node 4 is the last of the in-memory fan-out, so the
raise reaches no other node's delivery.

Both packages behave alike: every message in the failed flush is dropped
(no retry), node 4 is left with its own partial and at most one peer's for
that duty, below the threshold, so it broadcasts no aggregate for those
validators there; the other three nodes broadcast them, and node 4's later
duties are whole.
"""

import asyncio

import pytest
import torch

torch.set_num_threads(1)

from charon_tpu.tbls import api as japi
from charon_tpu.tbls import dispatch as jdispatch
from charon_tpu_torch.core.types import DutyType
from charon_tpu_torch.tbls import api as tbls
from charon_tpu_torch.tbls import dispatch as pdispatch
from tests.test_torch_simnet import FORK, JAX, PORT, SPE

N, T, V = 4, 3, 3
SLOT = 0.25
FAULTY = N          # share index of the node whose flush raises


@pytest.fixture
def insecure_scheme():
    tbls.set_scheme("insecure-test")
    japi.set_scheme("insecure-test")
    yield
    tbls.set_scheme("bls")
    japi.set_scheme("bls")


class FaultyPipeline:
    """The default pipeline, each flush held 50 ms; the first flush of
    inbound attester partials only (no local VC submission) with two
    peers' partials of one validator raises instead."""

    def __init__(self, inner, rows: dict):
        self.inner = inner
        self.rows = rows              # sig → (duty, group pk, sender)
        self.failed: list = []        # the raising flush's entries

    def plan_verify(self, n: int):
        return self.inner.plan_verify(n)

    @property
    def queue_depth(self):
        return self.inner.queue_depth

    async def batch_verify(self, entries, stats=None):
        await asyncio.sleep(0.05)
        rows = [self.rows.get(sig) for _, _, sig in entries]
        senders: dict = {}
        for row in rows:
            if row is not None:
                senders.setdefault((row[0], row[1]), set()).add(row[2])
        inbound = all(row is not None and row[0].type == DutyType.ATTESTER
                      for row in rows)
        if not self.failed and inbound and any(
                len(s) >= 2 for s in senders.values()):
            self.failed = list(entries)
            raise RuntimeError("injected verify flush failure")
        return await self.inner.batch_verify(entries, stats=stats)


def run_cluster(mods, dispatch_mod) -> tuple[dict, list, dict]:
    """→ ({share idx: {(slot, group pk)} broadcast}, the failed flush's
    (duty, group pk, sender) rows, {sig: (duty, group pk, sender)})."""
    cluster = mods["new_cluster_for_test"](T, N, V, seed=b"c2-verify-fault")
    bmock = mods["BeaconMock"](slot_duration=SLOT, slots_per_epoch=SPE)
    for v in cluster.validators:
        bmock.add_validator(v.group_pubkey)
    pubshares = {i: cluster.pubshare_map(i) for i in range(1, N + 1)}
    psx, lc = mods["MemParSigExNetwork"](), mods["MemTransportNetwork"]()
    nodes = []
    for idx in range(1, N + 1):
        cfg = mods["NodeConfig"](share_idx=idx, threshold=T,
                                 pubshares_by_peer=pubshares,
                                 fork_version=FORK)
        node = mods["Node"](cfg, bmock,
                            consensus=mods["LeaderCast"](lc, idx - 1, N),
                            parsigex=psx.join(), slots_per_epoch=SPE,
                            genesis_time=bmock.genesis, slot_duration=SLOT,
                            fetched_types=(DutyType.ATTESTER,))
        vmock = mods["ValidatorMock"](node.vapi,
                                      cluster.share_privkey_map(idx), FORK,
                                      slots_per_epoch=SPE, eth2cl=bmock)
        node.scheduler.subscribe_slots(vmock.on_slot)
        nodes.append(node)

    faulty = nodes[FAULTY - 1]
    by_sig: dict = {}
    pipe = FaultyPipeline(dispatch_mod.default_pipeline(), by_sig)
    faulty.verifier._dispatcher = pipe
    verify_fn = faulty.parsigex._verify_fn

    async def record_and_verify(duty, pset):
        for gpk, psig in pset.items():
            by_sig[psig.signature] = (duty, gpk, psig.share_idx)
        await verify_fn(duty, pset)

    faulty.parsigex._verify_fn = record_and_verify
    sent: dict = {i: set() for i in range(1, N + 1)}

    def recorder(idx: int):
        async def record(duty, pubkey, data):
            if duty.type == DutyType.ATTESTER:
                sent[idx].add((duty.slot, pubkey))
        return record

    for idx, node in enumerate(nodes, 1):
        node.bcast.subscribe(recorder(idx))

    async def main():
        for n in nodes:
            n.start()
        try:
            for _ in range(200):
                await asyncio.sleep(0.1)
                if pipe.failed:
                    fail_slot = max(by_sig[s][0].slot
                                    for _, _, s in pipe.failed)
                    if all(len({s for s, _ in sent[i] if s > fail_slot + 1})
                           >= 2 for i in sent):
                        break
        finally:
            for n in nodes:
                n.stop()
            await asyncio.sleep(0)

    asyncio.run(main())
    return sent, [by_sig[s] for _, _, s in pipe.failed], by_sig


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_a_raising_flush_with_two_peers_partials_loses_the_aggregate(
        insecure_scheme, pkg):
    mods, dispatch_mod = ((PORT, pdispatch) if pkg == "port"
                          else (JAX, jdispatch))
    sent, failed, by_sig = run_cluster(mods, dispatch_mod)
    assert failed, "no flush held two peers' partials of one validator"
    # every failed row is an inbound partial of an attester duty
    assert all(duty.type == DutyType.ATTESTER and sender != FAULTY
               for duty, _, sender in failed)
    assert len(failed) == len({(d, g, s) for d, g, s in failed})
    lost = set()
    for duty, gpk, _ in failed:
        senders = {s for (d, g, s) in by_sig.values()
                   if d == duty and g == gpk}
        got = senders - {s for d, g, s in failed if d == duty and g == gpk}
        # node 4's own partial and the peers' outside the failed flush
        if 1 + len(got) < T:
            lost.add((duty.slot, gpk))
    assert lost, failed
    for key in lost:
        assert key not in sent[FAULTY], key
        for idx in range(1, N + 1):
            if idx != FAULTY:
                assert key in sent[idx], (idx, key)
    # the verifier recovered: node 4 broadcast every later duty the other
    # nodes broadcast, up to the last slot all of them finished
    last = min(max(s for s, _ in sent[i]) for i in sent) - 1
    fail_slot = max(s for s, _ in lost)
    later = {k for k in sent[1] if fail_slot < k[0] <= last}
    assert later and later <= sent[FAULTY]
