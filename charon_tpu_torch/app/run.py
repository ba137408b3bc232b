"""app.run — the full node assembly (reference: app/app.go:127-488).

Everything the reference's `app.Run` wires is assembled here from cluster
material on disk:

    lock file → peers/identity → TCP mesh (authenticated-encrypted)
    beacon URLs → MultiBeaconClient (first-success fan-out) behind the
        serving layer's CachingBeaconClient (coalesced, slot/epoch-scoped
        cached duty fetches, bounded retries)
    core workflow components + core.wire() with async-retry wrapped edges
    Deadliner → duty-expiry GC for dutydb/parsigdb/aggsigdb/consensus/
        scheduler + post-deadline tracker analysis
    tracker, peerinfo gossip loop, ping loop, monitoring API (/readyz =
        quorum-peers AND BN-synced, app/monitoringapi.go:100-176),
    OTLP span sinks and the Loki log sink from the environment, the
        SLO-triggered auto-profiler (late duties, loop-lag breaches),
    validator-API HTTP router with reverse proxy,
    priority/infosync exchange triggered at the last slot of each epoch,
    ordered start/stop via lifecycle.Manager.

A copy of the JAX package's app/run.py.  VCs reach the node through
`VapiRouter` at ``RunConfig.vapi_host:vapi_port``; the in-process
validator mock (`RunConfig.simnet_vmock`) signs beside them when asked,
for the duty flows it is given.  The auto-profiler's capture is the
port's `torch.profiler` trace (`app/autoprofile.py`), taken on a worker
thread, with the profiler's set-up paid once at boot after the prewarm.

The node's verifies and combines run on the tbls backend the process
chose — the card's ``cuda`` backend unless the caller set ``cpu`` or the
``insecure-test`` scheme — through the process's one
`tbls.dispatch.DispatchPipeline`; nothing falls back to the CPU when the
card fails.  `boot_seconds` times the lock's verification, the
prewarm and the auto-profiler's set-up (``profiler``), and /metrics
serves them as ``app_boot_seconds{phase}``.
"""

from __future__ import annotations

import asyncio
import logging
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field

from ..cluster.definition import Lock, load_json, lock_from_json
from ..core import interfaces
from ..core.aggsigdb import MemAggSigDB
from ..core.bcast import Broadcaster, Recaster
from ..core.consensus import QBFTConsensus
from ..core.deadline import Deadliner, duty_deadline
from ..core.dutydb import MemDutyDB
from ..core.fetcher import Fetcher
from ..core.parsigdb import MemParSigDB
from ..core.priority import InfoSync, Prioritiser
from ..core.scheduler import Scheduler
from ..core.sigagg import SigAgg
from ..core.slotbudget import SlotBudget
from ..core.tracker import Tracker
from ..core.types import (Duty, DutyType, ParSignedDataSet, PubKey,
                          pubkey_from_bytes)
from ..core.validatorapi import ValidatorAPI
from ..core.verify import BatchVerifier
from ..eth2util.beacon_client import MultiBeaconClient
from ..eth2util.signing import signing_root
from ..p2p import identity as ident
from ..p2p.protocols import (P2PConsensusTransport, P2PParSigEx,
                             P2PPriorityExchange)
from ..p2p.transport import TCPMesh, mesh_params_from_definition
from ..tbls import api as tbls
from ..tbls import dispatch
from . import autoprofile, featureset, log as applog, otlp, tracing
from .lifecycle import Manager, StartOrder, StopOrder
from .monitoring import (MonitoringAPI, Registry, hbm_sample_loop,
                         loop_lag_probe, set_readiness)
from .peerinfo import PeerInfo
from .qbftdebug import QBFTSniffer
from .retry import Retryer, with_async_retry
from .router import VapiRouter
from .serving import CachingBeaconClient
from .tracing import Tracer, with_tracing

log = logging.getLogger(__name__)

VERSION = "charon-tpu/0.3.0"
SUPPORTED_PROTOCOLS = ["/charon_tpu/consensus/qbft/1.0.0",
                       "/charon_tpu/leadercast/1.0.0"]


#: the duty types the scheduler fetches for each validator-mock flow (the
#: sync committee's messages are the VC's alone: nothing to fetch)
_FETCHED_BY_FLOW = {
    "attester": (DutyType.ATTESTER,),
    "proposer": (DutyType.PROPOSER, DutyType.BUILDER_PROPOSER),
    "sync_contribution": (DutyType.SYNC_CONTRIBUTION,),
}


def simnet_flows(duties: tuple[str, ...]
                 ) -> tuple[tuple[str, ...], tuple[str, ...] | None]:
    """`RunConfig.simnet_duties` → the flows the scheduler fetches and
    the flows the simnet validator mock signs (None: every flow).  A flow
    marked ``:vc`` (``attester:vc``) is fetched, but signed by the VCs on
    the validator API, not by the mock."""
    if not duties:
        return (), None
    names = []
    for duty in duties:
        name, _, signer = duty.partition(":")
        if signer not in ("", "vc"):
            raise ValueError(f"simnet duty {duty!r}: only ':vc' may mark "
                             f"a flow")
        names.append(name)
    return tuple(names), tuple(d for d in duties if ":" not in d)


@dataclass
class RunConfig:
    """reference: app.Config (app/app.go:60-97)."""

    lock_file: str
    identity_key_file: str
    beacon_urls: list[str]
    monitoring_host: str = "127.0.0.1"
    monitoring_port: int = 0
    vapi_host: str = "127.0.0.1"
    vapi_port: int = 0
    builder_api: bool = False
    no_verify_lock: bool = False
    simnet_vmock: bool = False
    keystore_dir: str = ""          # share-key keystores for the vmock
    features_enabled: list[str] = field(default_factory=list)
    features_disabled: list[str] = field(default_factory=list)
    ping_interval: float = 5.0
    peerinfo_interval: float = 10.0
    # the duty mix the scheduler fetches and the simnet validator mock
    # signs (testutil/validatormock.FLOWS; empty = all); a flow marked
    # ":vc" is fetched but left to the VCs on the validator API
    simnet_duties: tuple[str, ...] = ()
    # OTLP trace export (empty = fall back to CHARON_TPU_TRACE_FILE /
    # CHARON_TPU_TRACE_ENDPOINT env vars; "{node}" in the file path
    # expands to this node's name)
    trace_file: str = ""
    trace_endpoint: str = ""


class App:
    """A fully-wired running node; also the TestConfig-style handle tests
    use to reach into components (reference: app/app.go:99-122)."""

    def __init__(self, cfg: RunConfig):
        self.cfg = cfg
        self.life = Manager()
        self.lock: Lock | None = None
        self.mesh: TCPMesh | None = None
        self.monitoring: MonitoringAPI | None = None
        self.router: VapiRouter | None = None
        self.tracker: Tracker | None = None
        self.registry = Registry()
        self.boot_seconds: dict[str, float] = {}
        self._stop = asyncio.Event()

    def _boot_phase(self, phase: str, seconds: float) -> None:
        self.boot_seconds[phase] = seconds
        self.registry.set_gauge("app_boot_seconds", seconds,
                                labels={"phase": phase})

    # -- assembly -----------------------------------------------------------

    async def setup(self) -> None:
        cfg = self.cfg
        featureset.init(featureset.Status.BETA,
                        enabled=cfg.features_enabled,
                        disabled=cfg.features_disabled)

        # 1. cluster material (reference: app/app.go:150 loadLock): one
        #    tbls.verify a validator, on the backend the process chose
        t0 = time.perf_counter()
        self.lock = await asyncio.to_thread(
            lambda: lock_from_json(load_json(cfg.lock_file),
                                   verify=not cfg.no_verify_lock))
        definition = self.lock.definition
        n = definition.num_operators
        threshold = definition.threshold
        cluster_hash = self.lock.lock_hash
        self.boot_seconds["verify_lock"] = time.perf_counter() - t0

        # 2. identity + self index from the lock ENRs (app/app.go:162-178)
        with open(cfg.identity_key_file) as f:
            identity = ident.NodeIdentity.from_bytes(
                bytes.fromhex(f.read().strip()))
        peers, pubs = mesh_params_from_definition(definition)
        self_index = next((i for i, pub in pubs.items()
                           if pub == identity.pubkey), None)
        if self_index is None:
            raise ValueError("identity key does not match any operator ENR")
        self.self_index = self_index
        share_idx = self_index + 1

        # 3. transports (per-peer byte/frame/latency/reconnect counters
        #    ride the registry; reference: p2p/sender.go:53-110)
        self.mesh = TCPMesh(self_index, peers, identity, pubs,
                            cluster_hash=cluster_hash,
                            registry=self.registry)
        self.mesh.enable_ping_responder()

        # 4. beacon client + chain parameters: the multi-client fan-out
        #    exports per-node request metrics, and the serving-layer
        #    cache wraps it so scheduler/fetcher duty fetches are
        #    coalesced and slot/epoch-scoped cached (with bounded
        #    retries absorbing a flapping upstream)
        multi = MultiBeaconClient.from_urls(cfg.beacon_urls)
        multi.bind_registry(self.registry)
        self.eth2cl = CachingBeaconClient(multi, registry=self.registry,
                                          retries=2)
        spec = await self.eth2cl.spec()
        self.slot_duration = spec["SECONDS_PER_SLOT"]
        self.slots_per_epoch = spec["SLOTS_PER_EPOCH"]
        self.genesis_time = await self.eth2cl.genesis_time()
        gvr = await self.eth2cl.genesis_validators_root()
        fork = definition.fork_version

        # 5. metrics registry with cluster identity labels (app/app.go:198)
        #    node identity rides the "node" key: per-series "peer" labels
        #    name the SUBJECT peer and must not overwrite it in the merge
        self.registry.const_labels.update({
            "cluster_hash": cluster_hash.hex()[:10],
            "cluster_name": definition.name,
            "node": f"node{self_index}",
        })
        for phase, seconds in list(self.boot_seconds.items()):
            self._boot_phase(phase, seconds)
        self.registry.set_gauge("app_peers", n)
        self.registry.set_gauge("app_threshold", threshold)
        self.registry.set_gauge("app_validators",
                                definition.num_validators)
        # inclusion delay spans whole slots; the default sub-second
        # latency buckets would clip it
        self.registry.set_buckets(
            "charon_tpu_tracker_inclusion_delay",
            (0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0))
        # per-stage dispatch attribution from the process-global fan-out:
        # core_dispatch_stage_seconds{stage,op} lands on OUR /metrics
        dispatch.add_metrics_registry(self.registry)

        # 5b. duty tracer + OTLP export sinks (reference: app/tracer/
        #     trace.go:40-151).  The tracer is created before the core
        #     components so the card boundary (BatchVerifier / SigAgg
        #     launches) can span into it.
        self.tracer_spans = Tracer(self.registry)
        node_name = f"node{self_index}"
        self._otlp_sinks = otlp.sinks_from_env(
            resource_attrs={"service.name": "charon_tpu",
                            "peer": node_name,
                            "cluster_hash": cluster_hash.hex()[:10]},
            registry=self.registry, node_name=node_name,
            environ={**os.environ,
                     **({"CHARON_TPU_TRACE_FILE": cfg.trace_file}
                        if cfg.trace_file else {}),
                     **({"CHARON_TPU_TRACE_ENDPOINT": cfg.trace_endpoint}
                        if cfg.trace_endpoint else {})})
        for sink in self._otlp_sinks:
            self.tracer_spans.add_sink(sink)
        tracing.set_global_tracer(self.tracer_spans)

        # 5c. Loki log push (reference: app/log/loki/client.go:49-190):
        #     CHARON_TPU_LOKI_ENDPOINT ships every structured log record;
        #     drops/failures are counted, never raised into log callers.
        self._loki_sink = applog.loki_sink_from_env(
            node_name=node_name, registry=self.registry,
            labels={"cluster_hash": cluster_hash.hex()[:10],
                    "cluster_name": definition.name})
        if self._loki_sink is not None:
            applog.add_sink(self._loki_sink)

        # 6. pubshare maps from the lock (app/app.go:327-376)
        pubshares_by_peer: dict[int, dict[PubKey, bytes]] = {
            i + 1: {pubkey_from_bytes(v.public_key): v.public_shares[i]
                    for v in self.lock.validators}
            for i in range(n)}
        pubshares = pubshares_by_peer[share_idx]
        self._pubshares_by_peer = pubshares_by_peer
        self._fork, self._gvr = fork, gvr

        # 7. core components
        sched_kwargs = {}
        fetched_flows, vmock_flows = simnet_flows(cfg.simnet_duties)
        if fetched_flows:
            sched_kwargs["fetched_types"] = tuple(
                t for flow in fetched_flows
                for t in _FETCHED_BY_FLOW.get(flow, ()))
        sched = Scheduler(self.eth2cl, list(pubshares),
                          builder_api=cfg.builder_api, **sched_kwargs)
        fetcher = Fetcher(self.eth2cl)
        self.qbft_sniffer = QBFTSniffer()
        # QBFT telemetry: round metrics on the registry, one
        # consensus/qbft/{slot} span per instance joining the duty's
        # deterministic trace, sniffer entries stamped with the same IDs
        consensus = QBFTConsensus(P2PConsensusTransport(self.mesh),
                                  self_index, n,
                                  sniffer=self.qbft_sniffer,
                                  registry=self.registry,
                                  tracer=self.tracer_spans,
                                  trace_id_fn=tracing.duty_trace_id)
        dutydb = MemDutyDB()
        # Off-loop dispatch pipeline: ALL device launches (verify +
        # combine) go through its host-prep/launch executor threads, so a
        # long verify batch never blocks the event loop
        self.dispatcher = dispatch.default_pipeline()
        # Shared micro-batching verifier: both partial-sig verify
        # call-sites — local-VC submissions (reference: core/validatorapi/
        # validatorapi.go:1052-1068) and inbound peer exchange (reference:
        # core/parsigex/parsigex.go:152-176) — coalesce into one
        # tbls.batch_verify flush per event-loop tick.
        self.verifier = BatchVerifier(on_launch=self._on_verify_launch,
                                      tracer=self.tracer_spans,
                                      dispatcher=self.dispatcher)
        vapi = ValidatorAPI(share_idx=share_idx,
                            pubshare_by_group=pubshares,
                            fork_version=fork,
                            genesis_validators_root=gvr,
                            slots_per_epoch=self.slots_per_epoch,
                            verifier=self.verifier)
        parsigdb = MemParSigDB(threshold)
        parsigex = P2PParSigEx(self.mesh, verify_fn=self._verify_external,
                               registry=self.registry)
        sigagg = SigAgg(threshold, tracer=self.tracer_spans,
                        dispatcher=self.dispatcher)
        aggsigdb = MemAggSigDB()
        bcast = Broadcaster(self.eth2cl, self.genesis_time,
                            self.slot_duration,
                            registry=self.registry)
        recaster = Recaster()

        deadline_fn = lambda duty: duty_deadline(  # noqa: E731
            duty, self.genesis_time, self.slot_duration)
        self.deadliner = Deadliner(deadline_fn)
        self.retryer = Retryer(deadline_fn)

        # 7b. slot-budget accountant: hand-off hooks subscribe BEFORE
        #     wire() so each timestamp lands before the downstream edge
        #     runs (the threshold→sigagg edge awaits the whole combine)
        self.slotbudget = SlotBudget(
            registry=self.registry,
            slot_start_fn=lambda slot: (self.genesis_time
                                        + slot * self.slot_duration),
            budget_seconds=self.slot_duration)
        sched.subscribe_duties(self.slotbudget.on_duty_scheduled)
        fetcher.subscribe(self.slotbudget.on_fetched)
        consensus.subscribe(self.slotbudget.on_consensus)
        parsigdb.subscribe_threshold(self.slotbudget.on_threshold)
        sigagg.subscribe(self.slotbudget.on_aggregated)
        bcast.subscribe(self.slotbudget.on_broadcast)

        # 7c. SLO-triggered auto-profiler: a late-duty watchdog trip or
        #     a loop-lag p99 breach captures a bounded, rate-limited
        #     torch.profiler trace stamped with the duty's trace ID — the
        #     operator gets the device timeline OF the slow slot, not a
        #     post-hoc guess (CHARON_TPU_AUTOPROFILE knobs).
        self.autoprofiler = autoprofile.from_env(
            registry=self.registry, node_name=node_name, default_on=True)
        if self.autoprofiler is not None:
            self.slotbudget.subscribe_late(self.autoprofiler.make_hook(
                "late_duty", trace_id_fn=tracing.duty_trace_id))

        interfaces.wire(sched, fetcher, consensus, dutydb, vapi, parsigdb,
                        parsigex, sigagg, aggsigdb, bcast,
                        with_tracing(self.tracer_spans),
                        with_async_retry(self.retryer))
        sigagg.subscribe(recaster.store)
        sched.subscribe_slots(recaster.slot_ticked)
        recaster.subscribe(bcast.broadcast)

        self.scheduler, self.dutydb, self.parsigdb = sched, dutydb, parsigdb
        self.aggsigdb, self.consensus, self.vapi = aggsigdb, consensus, vapi
        self.bcast, self.parsigex, self.sigagg = bcast, parsigex, sigagg

        # 8. tracker rides every edge as an extra subscriber
        #    (reference: app/app.go:450 wireTracker)
        self.tracker = Tracker(
            num_peers=n, threshold=threshold, registry=self.registry,
            slot_start_fn=lambda slot: (self.genesis_time
                                        + slot * self.slot_duration))
        sched.subscribe_duties(self.tracker.on_duty_scheduled)
        fetcher.subscribe(self.tracker.on_fetched)
        consensus.subscribe(self.tracker.on_consensus)
        parsigdb.subscribe_internal(self.tracker.on_parsig_internal)
        parsigex.subscribe(self.tracker.on_parsig_external)
        parsigdb.subscribe_threshold(self.tracker.on_threshold)
        sigagg.subscribe(self.tracker.on_aggregated)
        self.tracker.subscribe(self._on_duty_report)
        self.tracker.subscribe(self.slotbudget.on_report)

        # 9. deadliner feeds: every scheduled/inbound duty gets a deadline
        async def _register_deadline(duty: Duty, *_args) -> None:
            self.deadliner.add(duty)

        sched.subscribe_duties(_register_deadline)
        parsigex.subscribe(_register_deadline)
        consensus.subscribe(_register_deadline)

        # 10. priority / infosync over the mesh (app/app.go:515-524)
        self.priority_exchange = P2PPriorityExchange(self.mesh)
        prioritiser = Prioritiser(
            self_index, n, self.priority_exchange.exchange,
            consensus_propose=consensus.propose_priority,
            consensus_subscribe=consensus.subscribe_priority)
        self.infosync = InfoSync(prioritiser, versions=[VERSION],
                                 protocols=SUPPORTED_PROTOCOLS)
        self.priority_exchange.register_local(self.infosync.local_msg)
        if featureset.enabled("priority"):
            sched.subscribe_slots(self.infosync.on_slot)

        # 11. peerinfo + monitoring
        self.peerinfo = PeerInfo(self.mesh, VERSION, cluster_hash,
                                 interval=cfg.peerinfo_interval,
                                 registry=self.registry)
        self.monitoring = MonitoringAPI(
            self.registry, self._readyz, identity=identity.enr(),
            qbft_debug=self.qbft_sniffer.render_json,
            tracer=self.tracer_spans,
            memory_extra=self._memory_extra)

        # 12. validator-API HTTP router (reverse proxy → first beacon URL)
        self._index_to_pubkey: dict[int, PubKey] = {}
        self.router = VapiRouter(vapi, cfg.beacon_urls[0],
                                 pubkey_by_index=self._pubkey_by_index,
                                 host=cfg.vapi_host, port=cfg.vapi_port,
                                 registry=self.registry,
                                 tracer=self.tracer_spans)

        # 13. optional in-process validator mock (simnet,
        #     reference: app/vmock.go).  A BLS signature is ≈ 0.1–0.2 s of
        #     pure Python: the mock signs those in a process of its own
        #     (spawned: never a fork after CUDA is up), as a VC beside the
        #     node would, so the node's loop and interpreter lock stay free
        #     for QBFT's timers, the mesh and the flushes' host prep; the
        #     insecure-test scheme's microsecond signatures stay inline
        self.vmock = self._signer = None
        if cfg.simnet_vmock and vmock_flows != ():
            from ..testutil.validatormock import ValidatorMock

            keys = await asyncio.to_thread(
                self._load_vmock_keys, cfg.keystore_dir, pubshares)
            if tbls.scheme_name() == "bls":
                # left to the interpreter's exit to join: a flow still
                # signing at SIGTERM must not meet a shut pool
                self._signer = ProcessPoolExecutor(
                    max_workers=1,
                    mp_context=multiprocessing.get_context("spawn"))
            self.vmock = ValidatorMock(vapi, keys, fork,
                                       genesis_validators_root=gvr,
                                       slots_per_epoch=self.slots_per_epoch,
                                       eth2cl=self.eth2cl,
                                       flows=vmock_flows,
                                       signer=self._signer)
            sched.subscribe_slots(self.vmock.on_slot)

        self._register_lifecycle()

    # -- hooks --------------------------------------------------------------

    async def _verify_external(self, duty: Duty,
                               pset: ParSignedDataSet) -> None:
        """Inbound peer partial-sig verification against the SENDER's
        pubshare (reference: core/parsigex/parsigex.go:152-176).  All
        partials of the message verify as ONE verify_many unit, and the
        shared BatchVerifier further coalesces concurrent messages (and
        local-VC submissions) into a single flush per tick."""
        entries = []
        for group_pk, psig in pset.items():
            peer_shares = self._pubshares_by_peer.get(psig.share_idx)
            if peer_shares is None or group_pk not in peer_shares:
                raise ValueError(f"unknown sender share {psig.share_idx}")
            domain, _ = psig.data.signing_info(self.slots_per_epoch)
            root = signing_root(domain, psig.data.message_root(),
                                self._fork, self._gvr)
            entries.append((peer_shares[group_pk], root, psig.signature))
        if not all(await self.verifier.verify_many(entries)):
            raise ValueError("invalid external partial signature")

    def _on_verify_launch(self, v: BatchVerifier) -> None:
        self.registry.set_gauge("core_verify_launches_total", v.launches)
        self.registry.set_gauge("core_verify_entries_total", v.entries_total)
        self.registry.set_gauge("core_verify_max_batch", v.max_batch)
        for path, count in v.paths.items():
            # which verify route served the tiles (a resident card route
            # ends in "+res"; "cpu" or "insecure-test" only when asked)
            self.registry.set_gauge("core_verify_launches_by_path", count,
                                    labels={"path": path})

    async def _pubkey_by_index(self, index: int) -> PubKey:
        if not self._index_to_pubkey:
            pks = [pubkey_from_bytes(v.public_key)
                   for v in self.lock.validators]
            vals = await self.eth2cl.active_validators(pks)
            self._index_to_pubkey = {v.index: pk for pk, v in vals.items()}
        return self._index_to_pubkey[index]

    async def _on_duty_report(self, report) -> None:
        self.registry.inc("core_tracker_duty_total",
                          labels={"ok": str(report.success).lower()})
        if not report.success:
            logging.getLogger("charon_tpu_torch.tracker").warning(
                "duty %s failed at %s: %s", report.duty,
                report.failed_step, report.reason)

    def _memory_extra(self) -> dict:
        """App-specific /debug/memory rows beyond the device stats."""
        return {
            "aggsigdb_entries": len(getattr(self.aggsigdb, "_data", ())),
            "tracker_pending_duties": len(self.tracker._events),
            "verifier_launches": self.verifier.launches,
            "boot_seconds": self.boot_seconds,
        }

    def _readyz(self) -> tuple[bool, str]:
        """Quorum peers reachable AND beacon node synced
        (reference: app/monitoringapi.go:100-176).  Also exports the
        ``app_readiness{reason}`` enum gauge so not-ready is diagnosable
        from /metrics, and the /readyz body carries the reason."""
        reason, detail = self._readyz_reason()
        set_readiness(self.registry, reason)
        return reason == "ok", detail

    def _readyz_reason(self) -> tuple[str, str]:
        n = self.lock.definition.num_operators
        quorum = (2 * n) // 3 + 1
        fresh = 1 + sum(1 for p, t in self._ping_ok.items()
                        if time.time() - t < 3 * self.cfg.ping_interval)
        if fresh < quorum:
            return ("mesh_degraded",
                    f"only {fresh}/{quorum} quorum peers reachable")
        if self._bn_state == "bn_down":
            return "bn_down", "beacon node unreachable"
        if self._bn_state == "syncing":
            return "syncing", "beacon node not synced"
        return "ok", "ok"

    def _load_vmock_keys(self, keystore_dir: str,
                         pubshares: dict[PubKey, bytes]):
        """Map decrypted share keys to group pubkeys by matching pubshares
        (the keystores hold SHARE private keys, docs/dkg.md:62-69)."""
        from ..eth2util import keystore

        secrets = keystore.load_keys(keystore_dir)
        by_pubshare = {ps: gpk for gpk, ps in pubshares.items()}
        out = {}
        for sk in secrets:
            pk = tbls.privkey_to_pubkey(sk)
            gpk = by_pubshare.get(pk)
            if gpk is not None:
                out[gpk] = sk
        if len(out) != len(pubshares):
            raise ValueError(
                f"keystores cover {len(out)}/{len(pubshares)} validators")
        return out

    # -- background loops ---------------------------------------------------

    async def _gc_loop(self) -> None:
        """Duty-expiry GC: trim every stateful component + run the tracker's
        post-deadline analysis (reference: app wires Deadliner through
        dutydb/parsigdb/consensus; core/deadline.go:30-160)."""
        async for duty in self.deadliner.expired():
            self.dutydb.trim(duty)
            self.parsigdb.trim(duty)
            self.aggsigdb.trim(duty)
            self.consensus.trim(duty)
            self.parsigex.trim(duty)
            self.scheduler.trim(duty)
            await self.tracker.analyse(duty)

    async def _ping_loop(self) -> None:
        while True:
            for peer in list(self.mesh.peers):
                try:
                    rtt = await self.mesh.ping(peer)
                    self._ping_ok[peer] = time.time()
                    self.registry.observe("app_p2p_ping_rtt_seconds", rtt,
                                          labels={"peer": str(peer)})
                except Exception:
                    pass
            await asyncio.sleep(self.cfg.ping_interval)

    async def _loop_lag_probe(self) -> None:
        """Event-loop health self-probe: `app_event_loop_lag_seconds`,
        the dispatch queue-depth gauge and the overlap-efficiency gauge —
        plus the loop-lag SLO breach hook into the auto-profiler (its
        rate limit bounds capture frequency)."""
        breach = (self.autoprofiler.make_hook("loop_lag")
                  if self.autoprofiler is not None else None)
        await loop_lag_probe(self.registry, dispatcher=self.dispatcher,
                             on_breach=breach)

    async def _hbm_probe(self) -> None:
        """Device-memory growth witness: `charon_tpu_hbm_live_bytes`
        sampled on a lifecycle background task."""
        await hbm_sample_loop(self.registry)

    async def _dispatch_prewarm(self) -> None:
        """Boot-time prewarm: build the kernels, seed the pubkey cache with
        every peer's pubshares and run one verify tile (capturing its
        graph on the resident route) and one combine at this cluster's
        (V, T), on a thread of its own, so the first duty of the first
        slot pays none of it.  Backends without device programs (cpu,
        insecure-test) report a skip and cost nothing.  A failure is
        logged, never retried on another backend."""
        shares = sorted({ps for by_pk in self._pubshares_by_peer.values()
                         for ps in by_pk.values()})
        v = len(self.lock.validators)
        t = self.lock.definition.threshold
        t0 = time.perf_counter()
        try:
            report = await self.dispatcher.prewarm(shares, v, t)
        except Exception:  # noqa: BLE001 — the duties' launches will fail
            log.exception("dispatch prewarm failed")
            return
        finally:
            self._boot_phase("prewarm", time.perf_counter() - t0)
        if "total_s" in report:
            self.registry.set_gauge("app_dispatch_prewarm_seconds",
                                    report["total_s"])
        log.info("dispatch prewarm: %s", report)

    async def _boot_prewarm(self) -> None:
        """The dispatch prewarm, then the auto-profiler's (its set-up
        paid at boot, not on the first late slot; after the kernels' and
        graphs' prewarm, so no capture is open while a graph is
        captured)."""
        await self._dispatch_prewarm()
        if self.autoprofiler is not None:
            seconds = await self.autoprofiler.prewarm()
            if seconds is not None:
                self._boot_phase("profiler", seconds)

    async def _bn_sync_loop(self) -> None:
        while True:
            try:
                s = await self.eth2cl.node_syncing()
                self._bn_state = "syncing" if s["is_syncing"] else "ok"
            except Exception:
                # unreachable ≠ syncing: distinct readiness reasons
                self._bn_state = "bn_down"
            await asyncio.sleep(5.0)

    # -- lifecycle ----------------------------------------------------------

    def _register_lifecycle(self) -> None:
        life = self.life
        self._ping_ok: dict[int, float] = {}
        self._bn_state = "ok"

        life.register_start(StartOrder.TRACKER, "deadliner",
                            self._start_deadliner)
        life.register_start(StartOrder.P2P_ROUTERS, "p2p-mesh",
                            self.mesh.start)
        life.register_start(StartOrder.P2P_PING, "ping-loop",
                            self._ping_loop, background=True)
        life.register_start(StartOrder.P2P_PING, "bn-sync-loop",
                            self._bn_sync_loop, background=True)
        life.register_start(StartOrder.P2P_PING, "peerinfo",
                            self._start_peerinfo)
        life.register_start(StartOrder.MONITOR_API, "monitoring",
                            self._start_monitoring)
        life.register_start(StartOrder.MONITOR_API, "loop-lag-probe",
                            self._loop_lag_probe, background=True)
        life.register_start(StartOrder.MONITOR_API, "hbm-probe",
                            self._hbm_probe, background=True)
        # background, on a prewarm thread of its own (not the launch
        # pool — see DispatchPipeline.prewarm): first duties' launches are
        # never queued behind it
        life.register_start(StartOrder.MONITOR_API, "dispatch-prewarm",
                            self._boot_prewarm, background=True)
        life.register_start(StartOrder.VALIDATOR_API, "vapi-router",
                            self.router.start)
        life.register_start(StartOrder.SCHEDULER, "gc-loop", self._gc_loop,
                            background=True)
        life.register_start(StartOrder.SCHEDULER, "scheduler",
                            self.scheduler.run, background=True)

        life.register_stop(StopOrder.SCHEDULER, "scheduler",
                           self._stop_scheduler)
        life.register_stop(StopOrder.VALIDATOR_API, "vapi-router",
                           self.router.stop)
        life.register_stop(StopOrder.RETRYER, "retryer",
                           self.retryer.shutdown)
        life.register_stop(StopOrder.P2P, "p2p-mesh", self._stop_mesh)
        life.register_stop(StopOrder.P2P, "beacon-client",
                           self.eth2cl.close)
        life.register_stop(StopOrder.MONITOR_API, "monitoring",
                           self._stop_monitoring)

    async def _start_deadliner(self) -> None:
        self.deadliner.start()

    async def _start_peerinfo(self) -> None:
        self.peerinfo.start()

    async def _start_monitoring(self) -> None:
        await self.monitoring.start(self.cfg.monitoring_host,
                                    self.cfg.monitoring_port)

    async def _stop_mesh(self) -> None:
        self.peerinfo.stop()
        await self.mesh.stop()

    async def _stop_monitoring(self) -> None:
        await self.monitoring.stop()
        self.deadliner.stop()
        # detach from the dispatch metrics fan-out (other Apps in this
        # process keep theirs)
        dispatch.remove_metrics_registry(self.registry)
        for sink in self._otlp_sinks:
            # final drain: FileSink flushes sync, AsyncHTTPSink async
            if hasattr(sink, "aclose"):
                await sink.aclose()
            elif hasattr(sink, "close"):
                sink.close()
        if self._loki_sink is not None:
            # detach from the process-global sink list (other Apps in
            # this process keep theirs), then final-drain the queue
            applog.remove_sink(self._loki_sink)
            await self._loki_sink.aclose()

    async def _stop_scheduler(self) -> None:
        self.scheduler.stop()

    # -- public -------------------------------------------------------------

    async def run(self) -> None:
        """Assemble and run until stop() (reference: app/app.go:236)."""
        await self.setup()
        runner = asyncio.ensure_future(self.life.run())
        await self._stop.wait()
        self.life.stop()
        await runner

    def stop(self) -> None:
        self._stop.set()


async def run(cfg: RunConfig, started=None) -> None:
    """Run one node to completion.  `started` (optional asyncio.Event) is
    set once the monitoring API and the validator-API router listen —
    tests use it to gate."""
    app = App(cfg)
    await app.setup()
    runner = asyncio.ensure_future(app.life.run())
    if started is not None:
        while app.monitoring.port is None or not app.router.addr:
            await asyncio.sleep(0.01)
        started.set()
    await app._stop.wait()
    app.life.stop()
    await runner
