"""Node assembly — the reference's wireCoreWorkflow (app/app.go:321-488).

Builds one DV node from cluster material: scheduler → fetcher →
consensus → dutydb → validatorapi → parsigdb → parsigex → sigagg →
aggsigdb → bcast, stitched by core.wire().  Transports (consensus,
parsigex) are injected so tests run in-memory clusters
(reference: app/app.go:99-122 TestConfig injection points).

A copy of the JAX package's app/node.py, whole but for the SLO-triggered
auto-profiler (`app/autoprofile.py`: `jax.profiler` captures behind an
environment knob), whose counterpart waits for the serving slice: the
slot budget's late-duty hooks and the loop-lag probe's breach hook are
there, with nothing hung on them.  Every node gets a `Tracer` and the
`with_tracing` wire option; a metrics `registry` also wires the
`SlotBudget`, the `Tracker` with its `Deadliner` GC loop, the loop-lag and
device-memory probes, and the registry's place in the process-global
dispatch fan-out.  The node chooses no tbls backend: its verifies and
combines run on whatever backend is set, through the process's one
`tbls.dispatch.DispatchPipeline`.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass

from ..core import interfaces
from ..core.aggsigdb import MemAggSigDB
from ..core.bcast import Broadcaster, Recaster
from ..core.deadline import Deadliner, duty_deadline
from ..core.dutydb import MemDutyDB
from ..core.fetcher import Fetcher
from ..core.parsigdb import MemParSigDB
from ..core.scheduler import Scheduler
from ..core.sigagg import SigAgg
from ..core.slotbudget import SlotBudget
from ..core.tracker import Tracker
from ..core.types import Duty, ParSignedDataSet, PubKey
from ..core.validatorapi import ValidatorAPI
from ..core.verify import BatchVerifier
from ..eth2util.signing import signing_root
from ..tbls import dispatch
from .monitoring import hbm_sample_loop, loop_lag_probe
from .tracing import Tracer, with_tracing


@dataclass
class NodeConfig:
    share_idx: int                       # 1-based
    threshold: int
    pubshares_by_peer: dict[int, dict[PubKey, bytes]]  # peer idx -> {group pk -> pubshare}
    fork_version: bytes = bytes(4)
    genesis_validators_root: bytes = bytes(32)
    builder_api: bool = False


class Node:
    """One distributed-validator node (in-process)."""

    def __init__(self, cfg: NodeConfig, eth2cl, consensus, parsigex,
                 slots_per_epoch: int = 16, genesis_time: float = 0.0,
                 slot_duration: float = 1.0, registry=None, tracer=None,
                 clock=None, dutydb=None, aggsigdb=None, probes: bool = True,
                 fetched_types=None):
        """`clock` (default wall time) threads one injectable timebase
        through scheduler, deadliner, tracker, slot budget and
        broadcaster — the chaos simnet's determinism hook.  `dutydb` /
        `aggsigdb` accept pre-existing stores so a restarted node re-wires
        the previous incarnation's state (testutil/chaos.py node-restart
        faults).  `probes=False` skips the loop-lag/device-memory sampling
        background tasks (virtual-time soak runs don't want wall-clocked
        samplers).  `fetched_types` narrows the scheduler's triggered duty
        families."""
        self.cfg = cfg
        self.eth2cl = eth2cl
        clock = clock if clock is not None else time.time
        self._clock = clock
        self._probes = probes
        # Observability rides the in-memory simnet node exactly like the
        # full App: every node gets a Tracer (deterministic duty trace
        # IDs join across nodes), and passing a monitoring Registry also
        # wires a Tracker + Deadliner GC so per-peer participation and
        # inclusion delay reach /metrics without the TCP/crypto stack.
        self.registry = registry
        self.tracer = tracer if tracer is not None else Tracer(registry)

        pubshares = cfg.pubshares_by_peer[cfg.share_idx]
        sched_kwargs = {}
        if fetched_types is not None:
            sched_kwargs["fetched_types"] = tuple(fetched_types)
        self.scheduler = Scheduler(eth2cl, list(pubshares),
                                   builder_api=cfg.builder_api,
                                   clock=clock, **sched_kwargs)
        self.fetcher = Fetcher(eth2cl)
        self.consensus = consensus
        self.dutydb = dutydb if dutydb is not None else MemDutyDB()
        # Off-loop dispatch pipeline shared by verify + combine launches
        # (the process's one pipeline, shared by every in-process node).
        self.dispatcher = dispatch.default_pipeline()
        # Both verify call-sites (local VC submissions + inbound peer
        # partials) share one micro-batching verifier → one
        # tbls.batch_verify launch per event-loop tick (reference per-sig
        # call-sites: validatorapi.go:1052-1068, parsigex.go:152-176).
        self.verifier = BatchVerifier(tracer=self.tracer,
                                      dispatcher=self.dispatcher)
        self.vapi = ValidatorAPI(
            share_idx=cfg.share_idx,
            pubshare_by_group=pubshares,
            fork_version=cfg.fork_version,
            genesis_validators_root=cfg.genesis_validators_root,
            slots_per_epoch=slots_per_epoch,
            verifier=self.verifier)
        self.parsigdb = MemParSigDB(cfg.threshold)
        self.parsigex = parsigex
        # Autowire inbound-partial-sig verification on transports that
        # declare the hook but have none set.
        if getattr(parsigex, "_verify_fn", True) is None:
            parsigex._verify_fn = self._verify_external
        self.sigagg = SigAgg(cfg.threshold, tracer=self.tracer,
                             dispatcher=self.dispatcher)
        self.aggsigdb = aggsigdb if aggsigdb is not None else MemAggSigDB()
        self.bcast = Broadcaster(eth2cl, genesis_time, slot_duration,
                                 registry=registry, clock=clock)
        self.recaster = Recaster()
        self._spe = slots_per_epoch
        self._genesis_time = genesis_time
        self._slot_duration = slot_duration

        # Per-stage dispatch attribution: register this node's registry
        # with the process-global fan-out so the simnet serves the same
        # core_dispatch_stage_seconds{stage,op} /
        # app_cuda_graph_capture_seconds families as production (shared
        # pipeline → shared series, the accepted in-process multi-node
        # approximation).
        if registry is not None:
            dispatch.add_metrics_registry(registry)

        # Slot-budget accountant: hand-off hooks subscribe BEFORE wire()
        # so each timestamp is taken before the downstream edge runs
        # (the threshold→sigagg edge awaits the whole combine otherwise).
        self.slotbudget: SlotBudget | None = None
        if registry is not None:
            self.slotbudget = SlotBudget(
                registry=registry,
                slot_start_fn=lambda slot: (genesis_time
                                            + slot * slot_duration),
                budget_seconds=slot_duration, clock=clock)
            self.scheduler.subscribe_duties(self.slotbudget.on_duty_scheduled)
            self.fetcher.subscribe(self.slotbudget.on_fetched)
            if hasattr(consensus, "subscribe"):
                consensus.subscribe(self.slotbudget.on_consensus)
            self.parsigdb.subscribe_threshold(self.slotbudget.on_threshold)
            self.sigagg.subscribe(self.slotbudget.on_aggregated)
            self.bcast.subscribe(self.slotbudget.on_broadcast)

        interfaces.wire(self.scheduler, self.fetcher, self.consensus,
                        self.dutydb, self.vapi, self.parsigdb, self.parsigex,
                        self.sigagg, self.aggsigdb, self.bcast,
                        with_tracing(self.tracer))
        # recaster rides the sigagg + slot events (reference: app/app.go:462)
        self.sigagg.subscribe(self.recaster.store)
        self.scheduler.subscribe_slots(self.recaster.slot_ticked)
        self.recaster.subscribe(self.bcast.broadcast)

        self.tracker: Tracker | None = None
        self.deadliner: Deadliner | None = None
        if registry is not None:
            self.tracker = Tracker(
                num_peers=len(cfg.pubshares_by_peer),
                threshold=cfg.threshold, registry=registry,
                slot_start_fn=lambda slot: (genesis_time
                                            + slot * slot_duration),
                clock=clock)
            self.scheduler.subscribe_duties(self.tracker.on_duty_scheduled)
            self.fetcher.subscribe(self.tracker.on_fetched)
            if hasattr(consensus, "subscribe"):
                consensus.subscribe(self.tracker.on_consensus)
            self.parsigdb.subscribe_internal(self.tracker.on_parsig_internal)
            parsigex.subscribe(self.tracker.on_parsig_external)
            self.parsigdb.subscribe_threshold(self.tracker.on_threshold)
            self.sigagg.subscribe(self.tracker.on_aggregated)
            if self.slotbudget is not None:
                # post-deadline report drives the phase decomposition +
                # late-duty watchdog
                self.tracker.subscribe(self.slotbudget.on_report)

            async def _register_deadline(duty: Duty, *_args) -> None:
                if self.deadliner is not None:
                    self.deadliner.add(duty)

            self.scheduler.subscribe_duties(_register_deadline)
            parsigex.subscribe(_register_deadline)

        self._run_task: asyncio.Task | None = None
        self._gc_task: asyncio.Task | None = None
        self._lag_task: asyncio.Task | None = None
        self._hbm_task: asyncio.Task | None = None

    async def _verify_external(self, duty: Duty,
                               pset: ParSignedDataSet) -> None:
        """Verify inbound peer partial sigs against the SENDER's pubshare
        (reference: core/parsigex/parsigex.go:152-176) — the whole message
        as one verify_many unit through the shared BatchVerifier."""
        entries = []
        for group_pk, psig in pset.items():
            peer_shares = self.cfg.pubshares_by_peer.get(psig.share_idx)
            if peer_shares is None or group_pk not in peer_shares:
                raise ValueError(f"unknown sender share {psig.share_idx}")
            domain, _ = psig.data.signing_info(self._spe)
            root = signing_root(domain, psig.data.message_root(),
                                self.cfg.fork_version,
                                self.cfg.genesis_validators_root)
            entries.append((peer_shares[group_pk], root, psig.signature))
        if not all(await self.verifier.verify_many(entries)):
            raise ValueError("invalid external partial signature")

    async def _gc_loop(self) -> None:
        """Duty-expiry GC + post-deadline tracker analysis (the App's
        `_gc_loop`, scaled down to the in-memory node)."""
        async for duty in self.deadliner.expired():
            self.dutydb.trim(duty)
            self.parsigdb.trim(duty)
            self.aggsigdb.trim(duty)
            if hasattr(self.consensus, "trim"):
                self.consensus.trim(duty)
            if hasattr(self.parsigex, "trim"):
                self.parsigex.trim(duty)
            self.scheduler.trim(duty)
            await self.tracker.analyse(duty)

    def start(self) -> None:
        # get_running_loop: start() is always called from inside the
        # node's event loop, and get_event_loop would silently bind a
        # fresh never-run loop when that ever stops being true
        loop = asyncio.get_running_loop()
        self._run_task = loop.create_task(self.scheduler.run())
        if self.registry is not None and self._probes:
            # event-loop health: the simnet node exports the same
            # app_event_loop_lag_seconds / dispatch queue-depth /
            # overlap-efficiency families as the full App, so
            # loop-responsiveness tests run without the TCP/crypto stack
            self._lag_task = loop.create_task(
                loop_lag_probe(self.registry, dispatcher=self.dispatcher))
            # device-memory sampling (charon_tpu_hbm_live_bytes: the
            # backend device's torch.cuda.memory_allocated) — short
            # interval so short-lived simnet nodes serve the gauge too
            self._hbm_task = loop.create_task(
                hbm_sample_loop(self.registry, interval=5.0))
        if self.tracker is not None:
            self.deadliner = Deadliner(
                lambda d: duty_deadline(d, self._genesis_time,
                                        self._slot_duration),
                clock=self._clock)
            self.deadliner.start()
            self._gc_task = loop.create_task(self._gc_loop())

    def stop(self) -> None:
        self.scheduler.stop()
        if self._run_task is not None:
            self._run_task.cancel()
        if self.deadliner is not None:
            self.deadliner.stop()
        if self._gc_task is not None:
            self._gc_task.cancel()
        if self._lag_task is not None:
            self._lag_task.cancel()
        if self._hbm_task is not None:
            self._hbm_task.cancel()
        if self.registry is not None:
            dispatch.remove_metrics_registry(self.registry)
