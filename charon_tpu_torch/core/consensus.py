"""Consensus component — adapts QBFT to the duty workflow.

Mirrors reference core/consensus/component.go:
- one QBFT instance per duty (component.go:240-309), created on local
  propose() or on the first inbound message for that duty,
- values are UnsignedDataSets in canonical hashable form (the reference
  hashes protos to [32]byte; frozen dataclasses make the set itself the
  comparable value),
- deterministic leader = (slot + type + round) % n (component.go:536-538),
- round timer 0.75s + 0.25s·round (component.go:540-548), configurable,
- per-duty buffered receive queues, GC'd when instances finish.

The transport is injected (in-memory `ConsensusMemNetwork` for simnet; the
p2p mesh version sits behind the same broadcast/subscribe pair).

Telemetry (reference: core/consensus/metrics.go) rides two optional
injections:

- ``registry`` (app.monitoring.Registry) exports per-duty-type round
  duration histograms, timeout/round-change/decided counters,
  justification-size stats, and current-round/leader gauges;
- ``tracer`` (app.tracing.Tracer) span-wraps each QBFT instance as
  ``consensus/qbft/{slot}`` from creation to decision (or GC), joining
  the duty's deterministic cross-cluster trace via ``trace_id_fn``
  (app.tracing.duty_trace_id, injected to keep core/ free of app/
  imports).  The qbftdebug sniffer entries are stamped with the same
  trace/span IDs so /debug/qbft links straight into the OTLP trace.

A copy of the JAX package's core/consensus.py, whole.  What waits for
later slices: the p2p mesh transport (the p2p slice; the in-memory
network is the transport here), the `/debug/qbft` endpoint that serves
the sniffer and the OTLP exporters (the serving slice), and the
priority protocol whose values `propose_priority` / `subscribe_priority`
carry (the `core/priority` slice).
"""

from __future__ import annotations

import asyncio
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any

from . import qbft
from .types import Duty, DutyType, UnsignedDataSet


def to_value(unsigned: UnsignedDataSet) -> tuple:
    """Canonical hashable value for consensus (sorted by pubkey)."""
    return tuple(sorted(unsigned.items(), key=lambda kv: kv[0]))


def from_value(value: tuple) -> UnsignedDataSet:
    return dict(value)


def duty_leader(duty: Duty, round_: int, nodes: int) -> int:
    """reference: component.go:536-538."""
    return (duty.slot + int(duty.type) + round_) % nodes


class ConsensusMemNetwork:
    """In-memory consensus transport: duty-scoped broadcast to all nodes,
    including the sender (QBFT requires self-delivery)."""

    def __init__(self) -> None:
        self._nodes: list[QBFTConsensus] = []

    def register(self, node: "QBFTConsensus") -> None:
        self._nodes.append(node)

    async def broadcast(self, duty: Duty, msg: qbft.Msg) -> None:
        for node in list(self._nodes):
            await node._deliver(duty, msg)


@dataclass
class _InstanceState:
    """Per-instance telemetry state (round transitions + the span)."""

    span: Any = None          # tracing.Span | None (detached, ended on decide)
    round: int = 1
    round_start: float = 0.0
    started: float = 0.0
    decided: bool = False


class QBFTConsensus:
    def __init__(self, transport: ConsensusMemNetwork, peer_idx: int,
                 nodes: int, round_timeout_base: float = 0.75,
                 round_timeout_inc: float = 0.25, sniffer=None,
                 registry=None, tracer=None, trace_id_fn=None,
                 clock=time.monotonic):
        self._net = transport
        self._peer_idx = peer_idx
        self._nodes = nodes
        self._base = round_timeout_base
        self._inc = round_timeout_inc
        self._sniffer = sniffer  # app.qbftdebug.QBFTSniffer (optional)
        self._registry = registry  # app.monitoring.Registry (optional)
        self._tracer = tracer      # app.tracing.Tracer (optional)
        self._trace_id_fn = trace_id_fn  # app.tracing.duty_trace_id
        self._clock = clock  # telemetry timebase (injectable for simnets)
        self._subs: list = []
        # Late-bindable per-duty input values: instances always read their
        # input through a holder lookup, so a local propose() landing
        # AFTER an inbound message created the instance still supplies the
        # value at the next proposal point (see qbft.run docstring).
        self._inputs: dict[Duty, Any] = {}
        self._prio_subs: list = []
        self._queues: dict[Duty, asyncio.Queue] = {}
        self._tasks: dict[Duty, asyncio.Task] = {}
        self._decided: set[Duty] = set()
        self._states: dict[Duty, _InstanceState] = {}
        self._trimmed: "OrderedDict[Duty, None]" = OrderedDict()
        if registry is not None:
            # justification quorums are message COUNTS, not latencies
            registry.set_buckets("core_qbft_justification_msgs",
                                 (1, 2, 4, 8, 16, 32, 64))
        transport.register(self)

    def subscribe(self, fn) -> None:
        self._subs.append(fn)

    def subscribe_priority(self, fn) -> None:
        """Decisions for INFO_SYNC duties (priority-protocol values) go to
        these subscribers instead of the duty pipeline
        (reference: core/consensus Component handles PriorityResult values,
        component.go:252-254)."""
        self._prio_subs.append(fn)

    # -- duty instance management ------------------------------------------

    def _queue(self, duty: Duty) -> asyncio.Queue:
        q = self._queues.get(duty)
        if q is None:
            q = asyncio.Queue()
            self._queues[duty] = q
        return q

    def _definition(self, duty: Duty) -> qbft.Definition:
        async def decide(instance: Any, value: Any, justification) -> None:
            if duty in self._decided:
                return
            self._decided.add(duty)
            if duty.type == DutyType.INFO_SYNC:
                for fn in self._prio_subs:
                    await fn(duty, value)
                return
            for fn in self._subs:
                await fn(duty, from_value(value))

        state = self._states.get(duty)
        sniffer_hook = None
        if self._sniffer is not None:
            trace_id = (self._trace_id_fn(duty)
                        if self._trace_id_fn is not None else "")
            span_id = (state.span.span_id
                       if state is not None and state.span is not None
                       else "")
            sniffer_hook = self._sniffer.on_rule(duty, trace_id=trace_id,
                                                 span_id=span_id)

        def on_rule(instance, process, round_, msg, rule) -> None:
            self._observe_rule(duty, round_, msg, rule)
            if sniffer_hook is not None:
                sniffer_hook(instance, process, round_, msg, rule)

        return qbft.Definition(
            is_leader=lambda inst, rnd, proc: duty_leader(
                duty, rnd, self._nodes) == proc,
            round_timeout=lambda rnd: self._base + self._inc * rnd,
            nodes=self._nodes,
            decide=decide,
            on_rule=on_rule,
        )

    def _ensure_instance(self, duty: Duty) -> None:
        if duty in self._tasks:
            return
        q = self._queue(duty)

        now = self._clock()
        state = _InstanceState(round=1, round_start=now, started=now)
        if self._tracer is not None:
            trace_id = (self._trace_id_fn(duty)
                        if self._trace_id_fn is not None else None)
            state.span = self._tracer.start_span(
                f"consensus/qbft/{duty.slot}", trace_id=trace_id,
                duty=str(duty), slot=duty.slot, nodes=self._nodes).span
        self._states[duty] = state
        self._export_round_gauges(duty, 1)

        async def bcast(msg: qbft.Msg) -> None:
            await self._net.broadcast(duty, msg)

        t = qbft.Transport(bcast, q)
        task = asyncio.get_running_loop().create_task(
            qbft.run(self._definition(duty), t, duty, self._peer_idx,
                     lambda: self._inputs.get(duty)))

        def _log_done(tk: asyncio.Task) -> None:
            if not tk.cancelled() and tk.exception() is not None:
                import logging

                logging.getLogger("charon_tpu_torch.consensus").error(
                    "qbft instance for %s died: %r", duty, tk.exception())

        task.add_done_callback(_log_done)
        self._tasks[duty] = task

    # -- telemetry (reference: core/consensus/metrics.go) -------------------

    def _export_round_gauges(self, duty: Duty, round_: int) -> None:
        reg = self._registry
        if reg is None:
            return
        dname = duty.type.name.lower()
        # per-duty-type gauges: concurrent instances of DIFFERENT duty
        # types cannot clobber each other; within a type the gauge shows
        # the most recently active instance
        reg.set_gauge("core_qbft_current_round", float(round_),
                      labels={"duty": dname})
        leader = duty_leader(duty, round_, self._nodes)
        for p in range(self._nodes):
            # subject peers ride the "peer" label (node identity stays on
            # the registry's const "node" label)
            reg.set_gauge("core_qbft_leader", 1.0 if p == leader else 0.0,
                          labels={"peer": str(p), "duty": dname})

    #: rules whose message names the round the instance is about to jump
    #: to — qbft.run fires on_rule BEFORE change_round on these paths, so
    #: the hook's `round_` argument is still the OLD round.
    _JUMP_RULES = (qbft.UponRule.JUSTIFIED_PRE_PREPARE,
                   qbft.UponRule.F_PLUS_1_ROUND_CHANGES,
                   qbft.UponRule.QUORUM_COMMITS,
                   qbft.UponRule.JUSTIFIED_DECIDED)

    def _observe_rule(self, duty: Duty, round_: int, msg, rule) -> None:
        """qbft.Definition.on_rule observer: round transitions, timeouts,
        justification sizes, decision."""
        reg = self._registry
        state = self._states.get(duty)
        if state is None or state.decided:
            return
        now = self._clock()
        dlabel = {"duty": duty.type.name.lower()}
        new_round = round_
        if msg is not None and rule in self._JUMP_RULES:
            new_round = max(round_, msg.round)
        round_observed = False
        if reg is not None:
            if rule == qbft.UponRule.ROUND_TIMEOUT:
                reg.inc("core_qbft_timeouts_total", labels=dlabel)
            if new_round > state.round:
                reg.observe("core_qbft_round_duration_seconds",
                            now - state.round_start, labels=dlabel)
                round_observed = True
                reg.inc("core_qbft_round_changes_total",
                        float(new_round - state.round), labels=dlabel)
                self._export_round_gauges(duty, new_round)
            if msg is not None and msg.justification:
                reg.observe("core_qbft_justification_msgs",
                            float(len(msg.justification)))
        if new_round > state.round:
            state.round = new_round
            state.round_start = now
        if rule in (qbft.UponRule.QUORUM_COMMITS,
                    qbft.UponRule.JUSTIFIED_DECIDED):
            state.decided = True
            if reg is not None:
                # a decide that also jumped rounds (laggard catching up
                # via JUSTIFIED_DECIDED) already observed the closing
                # round's duration above — a second sample here would be
                # a spurious ~0 s entry deflating the histogram
                if not round_observed:
                    reg.observe("core_qbft_round_duration_seconds",
                                now - state.round_start, labels=dlabel)
                reg.inc("core_qbft_decided_total", labels=dlabel)
            self._finish_span(state, now)

    def _finish_span(self, state: _InstanceState, now: float) -> None:
        if state.span is not None and self._tracer is not None:
            self._tracer.end_span(state.span, decided=state.decided,
                                  rounds=state.round,
                                  duration=now - state.started)
            state.span = None

    # -- interface ----------------------------------------------------------

    async def propose(self, duty: Duty, unsigned: UnsignedDataSet) -> None:
        """Start (or join) this duty's consensus with our proposed value.
        If an inbound message already created the instance, the value is
        late-bound: the running instance picks it up at its next proposal
        point (first write wins).  Proposals for GC'd duties are dropped
        like inbound stragglers (a retried propose landing post-deadline
        must not resurrect an instance that can never be trimmed again)."""
        if duty in self._trimmed:
            return
        self._inputs.setdefault(duty, to_value(unsigned))
        self._ensure_instance(duty)

    async def propose_priority(self, duty: Duty, value: Any) -> None:
        """Propose a raw hashable value (priority-protocol results) for an
        INFO_SYNC duty."""
        if duty in self._trimmed:
            return
        self._inputs.setdefault(duty, value)
        self._ensure_instance(duty)

    async def _deliver(self, duty: Duty, msg: qbft.Msg) -> None:
        # Stragglers for GC'd duties are dropped, not re-buffered.
        if duty in self._trimmed:
            return
        await self._queue(duty).put(msg)
        if duty not in self._tasks:
            # First contact for this duty came from a peer: start an
            # instance with no input yet so this node still follows the
            # cluster's decision even if its own fetch failed/lags.  A
            # later local propose() late-binds the value through the
            # holder (an early inbound frame must not permanently null
            # this node's input — that stalled whole duties when every
            # honest node saw a byzantine frame first).
            self._ensure_instance(duty)

    def trim(self, duty: Duty) -> None:
        """Deadliner GC (reference: component.go:376-408 deadline sweep)."""
        task = self._tasks.pop(duty, None)
        if task is not None:
            task.cancel()
        self._queues.pop(duty, None)
        self._inputs.pop(duty, None)
        self._decided.discard(duty)
        state = self._states.pop(duty, None)
        if state is not None:
            # an undecided instance reaching GC is a stuck consensus:
            # close its span so the timeline shows WHERE the slot died
            self._finish_span(state, self._clock())
        self._trimmed[duty] = None
        while len(self._trimmed) > 4096:  # bounded straggler-drop memory
            self._trimmed.popitem(last=False)
