"""SigAgg — threshold aggregation, the device kernels' call site.

A copy of the JAX package's core/sigagg.py, wired to this package's
`tbls.dispatch` (trimmed: no tracer, no inline mode, no flush window).

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
from dataclasses import dataclass

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
    def __init__(self, threshold: int):
        self._threshold = threshold
        self._subs: list = []
        self._queue: list[_Pending] = []

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
        try:
            # ONE coalesced launch, awaited off-loop
            combined = await dispatch.default_pipeline().threshold_combine(
                sig_sets)
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
