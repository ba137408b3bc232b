"""The duty workflow as a whole on the port: n `charon_tpu_torch` nodes in
one process (scheduler → fetcher → leadercast → dutydb → validatorapi →
parsigdb → parsigex → sigagg → aggsigdb → bcast), an in-memory parsigex
and leadercast, one `BeaconMock` and a `ValidatorMock` per node.

(i)   the four cases of the JAX package's tests/test_core_simnet.py on the
      port (insecure-test scheme, 3 nodes, 2-of-3, 0.25 s slots), the QBFT
      case on the port's own `QBFTConsensus`.
(ii)  one cluster seed through the JAX `Node` and the port's `Node`, on
      leadercast and on QBFT (each package's own): the broadcast (duty,
      group pubkey) → signature maps are equal wherever both runs produced
      the duty.
(iii) real BLS, `BASELINE.json` config 1 (1 validator, 4-of-4) on
      `CUDABackend(device="cpu")`: one attestation duty whose group
      signature equals the JAX package's `ref.bls.sign` with the group
      secret, byte for byte, every verify flush on the port's cuda route.
      Each verify flush runs the kernels' plain versions on the CPU
      (≈ 13 s a flush, most of it the plain Miller program), so this case
      alone takes minutes; the run stops as soon as `BeaconMock` holds the
      attestation.
(iv)  a registry-enabled cluster (4 nodes, 3-of-4, QBFT, a registry,
      tracer, tracker and slot budget a node): every duty the trackers
      analyse is a success with full participation, and the registries
      hold the workflow's families.
"""

import asyncio
import time

import pytest
import torch

# one intra-op thread: the suite runs several workers on the same cores
torch.set_num_threads(1)

from charon_tpu.app import node as jnode
from charon_tpu.core import consensus as jconsensus
from charon_tpu.core import leadercast as jleadercast
from charon_tpu.core import parsigex as jparsigex
from charon_tpu.tbls import api as japi
from charon_tpu.tbls.ref import bls as jbls
from charon_tpu.tbls.ref import curve as jcurve
from charon_tpu.testutil import beaconmock as jbeaconmock
from charon_tpu.testutil import cluster as jcluster
from charon_tpu.testutil import validatormock as jvalidatormock
from charon_tpu_torch.app.monitoring import Registry
from charon_tpu_torch.app.node import Node, NodeConfig
from charon_tpu_torch.app.tracing import Tracer, duty_trace_id
from charon_tpu_torch.core.consensus import ConsensusMemNetwork, QBFTConsensus
from charon_tpu_torch.core.leadercast import LeaderCast, MemTransportNetwork
from charon_tpu_torch.core.parsigex import MemParSigExNetwork
from charon_tpu_torch.core.types import DutyType
from charon_tpu_torch.eth2util.signing import DomainName, signing_root
from charon_tpu_torch.tbls import api as tbls
from charon_tpu_torch.tbls import backend_cuda, dispatch
from charon_tpu_torch.testutil.beaconmock import BeaconMock
from charon_tpu_torch.testutil.cluster import new_cluster_for_test
from charon_tpu_torch.testutil.validatormock import ValidatorMock

N_NODES = 3
THRESHOLD = 2
N_VALS = 2
SLOT_DUR = 0.25
SPE = 4
FORK = bytes.fromhex("00000000")

#: the port's modules and the JAX package's, for one cluster builder
PORT = dict(Node=Node, NodeConfig=NodeConfig, LeaderCast=LeaderCast,
            MemTransportNetwork=MemTransportNetwork,
            QBFTConsensus=QBFTConsensus,
            ConsensusMemNetwork=ConsensusMemNetwork,
            MemParSigExNetwork=MemParSigExNetwork, BeaconMock=BeaconMock,
            new_cluster_for_test=new_cluster_for_test,
            ValidatorMock=ValidatorMock)
JAX = dict(Node=jnode.Node, NodeConfig=jnode.NodeConfig,
           LeaderCast=jleadercast.LeaderCast,
           MemTransportNetwork=jleadercast.MemTransportNetwork,
           QBFTConsensus=jconsensus.QBFTConsensus,
           ConsensusMemNetwork=jconsensus.ConsensusMemNetwork,
           MemParSigExNetwork=jparsigex.MemParSigExNetwork,
           BeaconMock=jbeaconmock.BeaconMock,
           new_cluster_for_test=jcluster.new_cluster_for_test,
           ValidatorMock=jvalidatormock.ValidatorMock)


@pytest.fixture
def insecure_scheme():
    tbls.set_scheme("insecure-test")
    japi.set_scheme("insecure-test")
    yield
    tbls.set_scheme("bls")
    japi.set_scheme("bls")


def build_cluster(mods=PORT, consensus_factory=None, seed=b"charon-tpu-test"):
    cluster = mods["new_cluster_for_test"](THRESHOLD, N_NODES, N_VALS,
                                           seed=seed)
    bmock = mods["BeaconMock"](slot_duration=SLOT_DUR, slots_per_epoch=SPE)
    for v in cluster.validators:
        bmock.add_validator(v.group_pubkey)

    pubshares_by_peer = {
        idx: cluster.pubshare_map(idx) for idx in range(1, N_NODES + 1)}

    psx_net = mods["MemParSigExNetwork"]()
    lc_net = mods["MemTransportNetwork"]()
    if consensus_factory is None:
        def consensus_factory(idx):
            return mods["LeaderCast"](lc_net, idx - 1, N_NODES)
    nodes = []
    for idx in range(1, N_NODES + 1):
        cfg = mods["NodeConfig"](share_idx=idx, threshold=THRESHOLD,
                                 pubshares_by_peer=pubshares_by_peer,
                                 fork_version=FORK)
        node = mods["Node"](cfg, bmock, consensus=consensus_factory(idx),
                            parsigex=psx_net.join(), slots_per_epoch=SPE,
                            genesis_time=bmock.genesis,
                            slot_duration=SLOT_DUR)
        vmock = mods["ValidatorMock"](node.vapi,
                                      cluster.share_privkey_map(idx), FORK,
                                      slots_per_epoch=SPE, eth2cl=bmock)
        node.scheduler.subscribe_slots(vmock.on_slot)
        nodes.append(node)
    return cluster, bmock, nodes


async def run_slots(nodes, bmock, num_slots: int, done=None):
    """Run until `done()` (default: attestations and blocks both reached
    the BN), then one more slot to settle; at most `num_slots` slots."""
    done = done or (lambda: bmock.attestations and bmock.blocks)
    for n in nodes:
        n.start()
    deadline = time.time() + num_slots * SLOT_DUR + 2.0
    try:
        while time.time() < deadline:
            await asyncio.sleep(0.1)
            if done():
                await asyncio.sleep(SLOT_DUR)
                break
    finally:
        for n in nodes:
            n.stop()
        await asyncio.sleep(0)


def group_signed(cluster, domain: DomainName, root: bytes, sig: bytes):
    """True when `sig` verifies under one of the cluster's group keys."""
    root = signing_root(domain, root, FORK)
    return any(tbls.verify(v.tss.group_pubkey, root, sig)
               for v in cluster.validators)


# -- (i) the JAX package's four simnet cases, on the port --------------------

def test_simnet_attestation_and_proposal(insecure_scheme):
    cluster, bmock, nodes = build_cluster()

    asyncio.run(run_slots(nodes, bmock, num_slots=3 * SPE))

    assert bmock.attestations, "no attestations broadcast"
    for att in bmock.attestations:
        assert group_signed(cluster, DomainName.BEACON_ATTESTER,
                            att.data.hash_tree_root(), att.signature)
    assert bmock.blocks, "no blocks broadcast"
    for blk in bmock.blocks:
        assert group_signed(cluster, DomainName.BEACON_PROPOSER,
                            blk.message.hash_tree_root(), blk.signature)


def test_simnet_sync_committee_family(insecure_scheme):
    """SYNC_MESSAGE + SYNC_CONTRIBUTION end to end: messages and signed
    contributions reach the BN with valid group signatures."""
    cluster, bmock, nodes = build_cluster()

    asyncio.run(run_slots(nodes, bmock, num_slots=4 * SPE + 12,
                          done=lambda: bmock.sync_contributions))

    assert bmock.sync_messages, "no sync-committee messages broadcast"
    for msg in bmock.sync_messages:
        assert group_signed(cluster, DomainName.SYNC_COMMITTEE,
                            msg.beacon_block_root, msg.signature)
    assert bmock.sync_contributions, "no sync contributions broadcast"
    for c in bmock.sync_contributions:
        assert group_signed(cluster, DomainName.CONTRIBUTION_AND_PROOF,
                            c.message.hash_tree_root(), c.signature)


def test_simnet_with_qbft_consensus(insecure_scheme):
    """The attestation flow over the port's QBFT instead of leadercast."""
    qnet = ConsensusMemNetwork()
    cluster, bmock, nodes = build_cluster(
        consensus_factory=lambda idx: QBFTConsensus(
            qnet, idx - 1, N_NODES, round_timeout_base=0.3))

    asyncio.run(run_slots(nodes, bmock, num_slots=3 * SPE))

    assert bmock.attestations, "no attestations with QBFT consensus"
    for att in bmock.attestations:
        assert group_signed(cluster, DomainName.BEACON_ATTESTER,
                            att.data.hash_tree_root(), att.signature)


def test_simnet_tolerates_one_node_down(insecure_scheme):
    """t-of-n: with n = 3, t = 2, one node that never starts must not stop
    duties."""
    cluster, bmock, nodes = build_cluster()

    asyncio.run(run_slots(nodes[:-1], bmock, num_slots=3 * SPE))

    assert bmock.attestations, "cluster stalled with one node down"
    for att in bmock.attestations:
        assert group_signed(cluster, DomainName.BEACON_ATTESTER,
                            att.data.hash_tree_root(), att.signature)


# -- (ii) the same seed through the JAX node and the port's node -------------

def qbft_factory(mods):
    """Each node a `QBFTConsensus` of `mods`' package on one network."""
    qnet = mods["ConsensusMemNetwork"]()
    return lambda idx: mods["QBFTConsensus"](qnet, idx - 1, N_NODES,
                                             round_timeout_base=0.3)


def broadcast_map(mods, seed: bytes, qbft: bool = False) -> dict:
    """(slot, duty type, group pubkey) → the set of signatures the nodes
    broadcast, from genesis until every broadcast family (attestation,
    block, sync message, contribution) has reached the BN."""
    _, bmock, nodes = build_cluster(
        mods, consensus_factory=qbft_factory(mods) if qbft else None,
        seed=seed)
    out: dict = {}

    async def record(duty, pubkey, data):
        out.setdefault((duty.slot, int(duty.type), pubkey),
                       set()).add(data.signature)

    for n in nodes:
        n.bcast.subscribe(record)
    asyncio.run(run_slots(
        nodes, bmock, num_slots=4 * SPE + 12,
        done=lambda: (bmock.attestations and bmock.blocks
                      and bmock.sync_messages and bmock.sync_contributions)))
    return out


def check_broadcasts_equal(qbft: bool) -> None:
    seed = b"charon-tpu-torch simnet"
    want = broadcast_map(JAX, seed, qbft)
    got = broadcast_map(PORT, seed, qbft)
    both = sorted(set(want) & set(got))
    kinds = {DutyType(k[1]) for k in both}
    assert {DutyType.ATTESTER, DutyType.PROPOSER, DutyType.SYNC_MESSAGE,
            DutyType.SYNC_CONTRIBUTION} <= kinds, kinds
    for key in both:
        assert len(got[key]) == 1, key        # every node the same bytes
        assert got[key] == want[key], key


def test_port_node_broadcasts_what_the_jax_node_broadcasts(insecure_scheme):
    check_broadcasts_equal(qbft=False)


def test_port_node_broadcasts_what_the_jax_node_broadcasts_on_qbft(
        insecure_scheme):
    """The same on each package's own `QBFTConsensus`."""
    check_broadcasts_equal(qbft=True)


# -- (iv) a registry on every node: tracker, slot budget, spans -------------

def test_registry_cluster_tracks_every_duty_as_a_success(insecure_scheme):
    """4 nodes, 3-of-4, QBFT, attestations only, a registry (and with it a
    tracer, tracker, deadliner and slot budget) on every node.  The run
    goes until each tracker has analysed 3 attester duties at their
    deadline (5 slots after the slot's start); every report is then a
    success with all 4 peers taking part."""
    n, t = 4, 3
    cluster = new_cluster_for_test(t, n, N_VALS, seed=b"telemetry simnet")
    bmock = BeaconMock(slot_duration=SLOT_DUR, slots_per_epoch=SPE)
    for v in cluster.validators:
        bmock.add_validator(v.group_pubkey)

    async def no_proposals(*_):
        return []

    bmock.overrides["proposer_duties"] = no_proposals
    pubshares_by_peer = {i: cluster.pubshare_map(i) for i in range(1, n + 1)}
    psx_net, qnet = MemParSigExNetwork(), ConsensusMemNetwork()
    nodes = []
    for idx in range(1, n + 1):
        reg = Registry(const_labels={"node": f"node{idx - 1}"})
        tracer = Tracer(reg)
        cons = QBFTConsensus(qnet, idx - 1, n, round_timeout_base=0.3,
                             registry=reg, tracer=tracer,
                             trace_id_fn=duty_trace_id)
        cfg = NodeConfig(share_idx=idx, threshold=t,
                         pubshares_by_peer=pubshares_by_peer,
                         fork_version=FORK)
        node = Node(cfg, bmock, consensus=cons,
                    parsigex=psx_net.join(registry=reg),
                    slots_per_epoch=SPE, genesis_time=bmock.genesis,
                    slot_duration=SLOT_DUR, registry=reg, tracer=tracer,
                    fetched_types=(DutyType.ATTESTER,))
        vmock = ValidatorMock(node.vapi, cluster.share_privkey_map(idx),
                              FORK, slots_per_epoch=SPE)
        node.scheduler.subscribe_slots(vmock.on_slot)
        nodes.append(node)
    reported: list = []
    nodes[0].tracker.subscribe(
        lambda r: asyncio.sleep(0, reported.append(r.duty)))

    def done():
        return all(len(nd.tracker.reports) >= 3 for nd in nodes)

    asyncio.run(run_slots(nodes, bmock, num_slots=6 * SPE, done=done))

    assert done(), [len(nd.tracker.reports) for nd in nodes]
    for nd in nodes:
        for r in nd.tracker.reports:
            assert r.duty.type == DutyType.ATTESTER, r
            assert r.success, (r.duty, r.failed_step, r.reason)
            assert r.participation == {i: True for i in range(1, n + 1)}
        text = nd.registry.render()
        for family in ("core_qbft_decided_total", "core_slot_phase_seconds",
                       "core_bcast_delay_seconds",
                       "core_parsigex_inbound_total",
                       "charon_tpu_tracker_participation",
                       "charon_tpu_tracker_inclusion_delay",
                       "core_dispatch_stage_seconds",
                       "app_event_loop_lag_seconds",
                       'span="cuda/batch_verify"',
                       'span="cuda/threshold_combine"',
                       'span="consensus/qbft/'):
            assert family in text, family
        assert not any(k[0] == "core_slot_late_duties_total"
                       for k in nd.registry._counters)
        spans = {s.name for s in nd.tracer.spans}
        assert {"core/consensus_propose", "cuda/batch_verify",
                "cuda/threshold_combine"} <= spans
    # every node left the process-global fan-out at stop
    assert not any(nd.registry in dispatch.metrics_registries()
                   for nd in nodes)
    assert reported == [r.duty for r in nodes[0].tracker.reports]


# -- (iii) real BLS, BASELINE config 1, on the port's backend ----------------

#: long enough that the CPU's plain kernels never make the duty late enough
#: to matter; the run starts a second before the attester duty fires
REAL_SLOT = 3600.0


def test_real_bls_4_of_4_attestation_on_the_port_backend():
    n, t = 4, 4
    be = backend_cuda.CUDABackend(device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbls, "_BACKENDS", dict(tbls._BACKENDS))
        mp.setattr(tbls, "_current_name", tbls._current_name)
        mp.setattr(backend_cuda, "ROW_TILE", 8)
        tbls.register_backend("cuda", be)
        tbls.set_backend("cuda")
        tbls.set_scheme("bls")

        cluster = new_cluster_for_test(t, n, 1)
        [val] = cluster.validators
        # the validator's attester slot in epoch 0; genesis puts "now" one
        # second before that slot's one-third mark, when the duty fires
        probe = BeaconMock(slot_duration=REAL_SLOT, slots_per_epoch=SPE)
        probe.add_validator(val.group_pubkey)
        [duty] = asyncio.run(probe.attester_duties(0, [0]))
        genesis = time.time() - duty.slot * REAL_SLOT - REAL_SLOT / 3 + 1.0
        bmock = BeaconMock(slot_duration=REAL_SLOT, slots_per_epoch=SPE,
                           genesis_time=genesis)
        bmock.add_validator(val.group_pubkey)

        async def no_proposals(*_):
            return []

        # config 1 is the attestation duty alone
        bmock.overrides["proposer_duties"] = no_proposals
        pubshares_by_peer = {
            idx: cluster.pubshare_map(idx) for idx in range(1, n + 1)}
        psx_net, lc_net = MemParSigExNetwork(), MemTransportNetwork()
        nodes = []
        for idx in range(1, n + 1):
            cfg = NodeConfig(share_idx=idx, threshold=t,
                             pubshares_by_peer=pubshares_by_peer,
                             fork_version=FORK)
            node = Node(cfg, bmock, consensus=LeaderCast(lc_net, idx - 1, n),
                        parsigex=psx_net.join(), slots_per_epoch=SPE,
                        genesis_time=genesis, slot_duration=REAL_SLOT,
                        fetched_types=(DutyType.ATTESTER,))
            vmock = ValidatorMock(node.vapi, cluster.share_privkey_map(idx),
                                  FORK, slots_per_epoch=SPE)
            node.scheduler.subscribe_slots(vmock.on_slot)
            nodes.append(node)

        async def run():
            for node in nodes:
                node.start()
            deadline = time.time() + 600
            try:
                while not bmock.attestations and time.time() < deadline:
                    await asyncio.sleep(0.1)
            finally:
                for node in nodes:
                    node.stop()
            # the pipeline's stages are FIFO: a no-op on each, awaited,
            # means no launch of this run is still running
            pipe = dispatch.default_pipeline()
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(pipe._prep_pool, lambda: None)
            await loop.run_in_executor(pipe._launch_pool, lambda: None)

        asyncio.run(run())
        path = tbls.verify_path(1)

    assert bmock.attestations, "no attestation within the run's deadline"
    att = bmock.attestations[0]
    assert att.data.slot == duty.slot
    root = signing_root(DomainName.BEACON_ATTESTER, att.data.hash_tree_root(),
                        FORK)
    group_sk = japi.privkey_to_int(japi.combine_shares(val.share_privkeys))
    assert att.signature == jcurve.g2_to_bytes(jbls.sign(group_sk, root))
    paths = {p for node in nodes for p in node.verifier.paths}
    assert path.startswith("cuda") and paths == {path}, paths
