"""Node assembly — the reference's wireCoreWorkflow (app/app.go:321-488).

Builds one DV node from cluster material: scheduler → fetcher →
consensus → dutydb → validatorapi → parsigdb → parsigex → sigagg →
aggsigdb → bcast, stitched by core.wire().  Transports (consensus,
parsigex) are injected so tests run in-memory clusters
(reference: app/app.go:99-122 TestConfig injection points).

A copy of the JAX package's app/node.py, trimmed of what belongs to the
telemetry slice: the `Tracer` and its `with_tracing` wire option, the
metrics `registry`, the `Tracker` with its `Deadliner` GC loop, the
`SlotBudget` accountant, the auto-profiler and the loop-lag / HBM probes.
The JAX node runs none of these without a registry either, so this node
behaves as the JAX node with ``registry=None``.  The node chooses no tbls
backend: its verifies and combines run on whatever backend is set, through
the process's one `tbls.dispatch.DispatchPipeline`.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass

from ..core import interfaces
from ..core.aggsigdb import MemAggSigDB
from ..core.bcast import Broadcaster, Recaster
from ..core.dutydb import MemDutyDB
from ..core.fetcher import Fetcher
from ..core.parsigdb import MemParSigDB
from ..core.scheduler import Scheduler
from ..core.sigagg import SigAgg
from ..core.types import Duty, ParSignedDataSet, PubKey
from ..core.validatorapi import ValidatorAPI
from ..core.verify import BatchVerifier
from ..eth2util.signing import signing_root


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
                 slot_duration: float = 1.0, clock=None, dutydb=None,
                 aggsigdb=None, fetched_types=None):
        """`clock` (default wall time) threads one injectable timebase
        through scheduler and broadcaster.  `dutydb` / `aggsigdb` accept
        pre-existing stores so a restarted node re-wires the previous
        incarnation's state.  `fetched_types` narrows the scheduler's
        triggered duty families."""
        self.cfg = cfg
        self.eth2cl = eth2cl
        clock = clock if clock is not None else time.time

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
        # Both verify call-sites (local VC submissions + inbound peer
        # partials) share one micro-batching verifier → one
        # tbls.batch_verify launch per event-loop tick (reference per-sig
        # call-sites: validatorapi.go:1052-1068, parsigex.go:152-176).
        # Its flushes and SigAgg's combines go through the process's one
        # `tbls.dispatch` pipeline, shared by every in-process node as in
        # the JAX package (the accepted in-process multi-node
        # approximation).
        self.verifier = BatchVerifier()
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
        self.sigagg = SigAgg(cfg.threshold)
        self.aggsigdb = aggsigdb if aggsigdb is not None else MemAggSigDB()
        self.bcast = Broadcaster(eth2cl, genesis_time, slot_duration,
                                 clock=clock)
        self.recaster = Recaster()
        self._spe = slots_per_epoch

        interfaces.wire(self.scheduler, self.fetcher, self.consensus,
                        self.dutydb, self.vapi, self.parsigdb, self.parsigex,
                        self.sigagg, self.aggsigdb, self.bcast)
        # recaster rides the sigagg + slot events (reference: app/app.go:462)
        self.sigagg.subscribe(self.recaster.store)
        self.scheduler.subscribe_slots(self.recaster.slot_ticked)
        self.recaster.subscribe(self.bcast.broadcast)

        self._run_task: asyncio.Task | None = None

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

    def start(self) -> None:
        # get_running_loop: start() is always called from inside the
        # node's event loop, and get_event_loop would silently bind a
        # fresh never-run loop when that ever stops being true
        loop = asyncio.get_running_loop()
        self._run_task = loop.create_task(self.scheduler.run())

    def stop(self) -> None:
        self.scheduler.stop()
        if self._run_task is not None:
            self._run_task.cancel()
