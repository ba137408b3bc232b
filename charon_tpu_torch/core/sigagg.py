"""SigAgg — threshold aggregation, the device kernels' call site.

A copy of the JAX package's core/sigagg.py, wired to this package's
`tbls.dispatch`, with its span: each coalesced combine is a
``cuda/threshold_combine`` span (the JAX ``tpu/threshold_combine``)
carrying the batch, T, `tbls.combine_path()`, `tbls.combine_padded_rows`,
the pipeline's queue depth and its per-stage seconds.  Left out: the
inline mode and the flush window (environment knobs the port does not
take: it always dispatches off the loop, one loop tick after the first
call).

Reference behaviour (core/sigagg/sigagg.go:53-103): receive ≥t partial
signatures for one validator, Lagrange-combine them (tbls.Aggregate),
inject the group signature into the SignedData, fan out to AggSigDB and the
Broadcaster.

Device-first redesign: aggregate() calls are MICRO-BATCHED.  Calls landing on
the same event-loop tick (all validators whose threshold was crossed by one
parsigdb store — the whole validator set in the happy path) are coalesced
into ONE `tbls.threshold_combine` launch, turning m per-validator CPU
interpolations into a single [m, t]-shaped device MSM (BASELINE.md north
star), at a latency of one loop tick.

The combine launch runs OFF the event loop through
`tbls.dispatch.DispatchPipeline` (host byte-packing on the prep thread,
the MSM on the launch thread), so the paper's invariant — aggregation
never blocks the duty pipeline (core/sigagg/sigagg.go:75-77) — holds
even for multi-hundred-ms batches.
"""

from __future__ import annotations

import asyncio
import contextlib
from dataclasses import dataclass

from ..tbls import api as tbls
from ..tbls import dispatch
from . import background
from .types import Duty, ParSignedData, PubKey


@dataclass
class _Pending:
    duty: Duty
    pubkey: PubKey
    parsigs: list[ParSignedData]
    done: asyncio.Future


class SigAgg:
    def __init__(self, threshold: int, tracer=None, dispatcher=None):
        self._threshold = threshold
        self._subs: list = []
        self._queue: list[_Pending] = []
        # tbls.dispatch.DispatchPipeline running the combines; None = the
        # process default, resolved per flush
        self._dispatcher = dispatcher
        # app.tracing.Tracer: each coalesced combine becomes a
        # "cuda/threshold_combine" span (batch, T, path, padded rows)
        self._tracer = tracer

    def subscribe(self, fn) -> None:
        self._subs.append(fn)

    async def aggregate(self, duty: Duty, pubkey: PubKey,
                        parsigs: list[ParSignedData]) -> None:
        """Queue one validator's threshold sigs; resolves when the batched
        combine containing it completes."""
        if len(parsigs) < self._threshold:
            raise ValueError("insufficient partial signatures")
        # get_running_loop, not get_event_loop (deprecated in coroutines
        # on 3.12+, and wrong-loop-prone when called from a thread)
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._queue.append(_Pending(duty, pubkey, list(parsigs), fut))
        # Every call spawns a flusher; after the coalescing sleep the first
        # one to wake drains the whole queue and the rest no-op.  (A shared
        # "is a flusher running" flag would race: entries enqueued while a
        # flusher is mid-combine would never be picked up.)
        background.spawn(self._flush(), name="sigagg-flush")
        await fut

    async def _flush(self) -> None:
        # Let every aggregate() of the current tick enqueue before
        # launching one batched kernel.
        await asyncio.sleep(0)
        batch, self._queue = self._queue, []
        if not batch:
            return  # a sibling flusher already drained the queue
        sig_sets = [
            {p.share_idx: p.signature for p in item.parsigs}
            for item in batch
        ]
        t = max(len(s) for s in sig_sets)
        pipe = self._dispatcher
        if pipe is None:
            pipe = dispatch.default_pipeline()
        span = (self._tracer.start_span(
            "cuda/threshold_combine", batch=len(batch), t=t,
            path=tbls.combine_path(),
            padded_rows=tbls.combine_padded_rows(len(batch), t),
            queue_depth=pipe.queue_depth)
            if self._tracer is not None else contextlib.nullcontext())
        stage_stats: dict = {}
        try:
            with span as sp:
                # ONE coalesced launch, awaited off-loop
                combined = await pipe.threshold_combine(
                    sig_sets, stats=stage_stats)
                # queue-wait / host-prep / device-exec / fetch span attrs
                # (same decomposition as core_dispatch_stage_seconds)
                if sp is not None and stage_stats:
                    sp.attrs.update(dispatch.stage_span_attrs(stage_stats))
        except Exception as exc:
            for item in batch:
                if not item.done.done():
                    item.done.set_exception(exc)
            return
        for item, group_sig in zip(batch, combined):
            # Per-item isolation: one failing subscriber (e.g. a beacon-node
            # broadcast error) must not strand the other items' futures or
            # wedge the pipeline — resolve every future exactly once.
            try:
                signed = item.parsigs[0].data.set_signature(group_sig)
                for fn in self._subs:
                    await fn(item.duty, item.pubkey, signed)
            except Exception as exc:
                if not item.done.done():
                    item.done.set_exception(exc)
                continue
            if not item.done.done():
                item.done.set_result(None)
