"""BatchVerifier — micro-batched BLS signature verification.

A copy of the JAX package's core/verify.py, wired to this package's
`tbls.dispatch`, with its span: each coalesced flush is a
``cuda/batch_verify`` span (the JAX ``tpu/batch_verify``) carrying the
batch size, the verify path, the padded rows, the coalesced calls, the
tiles, the pipeline's queue depth and the pipeline's per-stage seconds
(`dispatch.stage_span_attrs`).  Left out: the inline mode and the flush
window (environment knobs the port does not take: it always dispatches
off the loop, one loop tick after the first call), and the per-path
throughput and cross-duty packing counters, which the JAX run entry
exports (they come with the `app/run` slice).

The reference verifies partial signatures one at a time at two call
sites: the local-VC submission path (core/validatorapi/validatorapi.go:
1052-1068) and the inbound peer-exchange path (core/parsigex/parsigex.go:
152-176).  Here every `verify()` / `verify_many()` call landing on one
event-loop tick is coalesced into ONE `tbls.batch_verify` flush, and on
the cuda backend that flush is one random-linear-combination batch check
per tile — 2 Miller rows per entry and ONE final exponentiation per tile
— so a bigger tick batch is cheaper per signature, not merely
launch-amortised.

A single drainer per verifier runs the flushes: calls that queue while a
flush is in flight are packed into the next one.  Verdicts are demuxed
positionally.  The flush runs OFF the event loop, through
`tbls.dispatch.DispatchPipeline`, so a long batch never freezes timers
and duty hand-offs.  Counters: `launches`, `entries_total`, `max_batch`
and `paths` (tiles per verify implementation); `on_launch(self)` is
called after every flush.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
from dataclasses import dataclass

from ..tbls import api as tbls
from ..tbls import dispatch
from . import background

log = logging.getLogger(__name__)


@dataclass
class _Pending:
    entries: list[tuple[bytes, bytes, bytes]]
    done: asyncio.Future          # resolves to list[bool]


class BatchVerifier:
    def __init__(self, on_launch=None, tracer=None, dispatcher=None):
        self._queue: list[_Pending] = []
        self._on_launch = on_launch     # fn(self), after every flush
        # app.tracing.Tracer: each coalesced flush becomes a
        # "cuda/batch_verify" span
        self._tracer = tracer
        # tbls.dispatch.DispatchPipeline running the flushes; None = the
        # process default, resolved per flush
        self._dispatcher = dispatcher
        self.launches = 0
        self.entries_total = 0
        self.max_batch = 0
        self.paths: dict[str, int] = {}  # verify path → tiles launched
        self._draining = False

    async def verify(self, pubkey: bytes, msg: bytes, sig: bytes) -> bool:
        """Queue one (pubkey, msg, sig); resolves when the batched flush
        holding it completes."""
        [ok] = await self.verify_many([(pubkey, msg, sig)])
        return ok

    async def verify_many(
            self, entries: list[tuple[bytes, bytes, bytes]]) -> list[bool]:
        """Queue N entries as one unit (e.g. all partials of one inbound
        parsigex message); returns their verdicts in order."""
        if not entries:
            return []
        loop = asyncio.get_running_loop()
        item = _Pending(list(entries), loop.create_future())
        self._queue.append(item)
        # Every call spawns a flusher; after the coalescing sleep the first
        # to wake becomes THE drainer and loops until the queue is empty
        # (entries queued mid-flush go into its next flush); later
        # flushers see `_draining` and return.
        background.spawn(self._flush(), name="batch-verify-flush")
        return await item.done

    async def _flush(self) -> None:
        # let every verify call of the current tick enqueue first
        await asyncio.sleep(0)
        if self._draining:
            return
        self._draining = True
        try:
            while self._queue:
                batch, self._queue = self._queue, []
                await self._launch(batch)
        finally:
            # no await between the last empty-queue check and this clear,
            # so no entry can be stranded between drainer exit and the
            # next flusher
            self._draining = False

    async def _launch(self, batch: list[_Pending]) -> None:
        """One coalesced flush: span it, run it, demux verdicts, fire the
        hook."""
        flat = [e for item in batch for e in item.entries]
        pipe = self._dispatcher
        if pipe is None:
            pipe = dispatch.default_pipeline()
        # per-TILE attribution: the pipeline splits a large flush into
        # tiles, and each tile resolves its own path and padding
        sizes = pipe.plan_verify(len(flat))
        tile_paths = [tbls.verify_path(s) for s in sizes]
        path_label = "+".join(sorted(set(tile_paths)))
        span = (self._tracer.start_span(
            "cuda/batch_verify", batch=len(flat), path=path_label,
            padded_rows=sum(tbls.verify_padded_rows(s) for s in sizes),
            coalesced_calls=len(batch), tiles=len(sizes),
            queue_depth=pipe.queue_depth)
            if self._tracer is not None else contextlib.nullcontext())
        stage_stats: dict = {}
        try:
            with span as sp:
                oks = await pipe.batch_verify(flat, stats=stage_stats)
                # queue-wait / host-prep / device-exec / fetch, summed
                # over tiles, on the same span
                if sp is not None and stage_stats:
                    sp.attrs.update(dispatch.stage_span_attrs(stage_stats))
        except Exception as exc:
            for item in batch:
                if not item.done.done():
                    item.done.set_exception(exc)
            return
        self.launches += 1
        self.entries_total += len(flat)
        self.max_batch = max(self.max_batch, len(flat))
        for path in tile_paths:     # one count per tile
            self.paths[path] = self.paths.get(path, 0) + 1
        pos = 0
        for item in batch:
            n = len(item.entries)
            if not item.done.done():
                item.done.set_result(oks[pos:pos + n])
            pos += n
        # the hook fires after every future is resolved, and a failing
        # hook is an observer problem, never a verify failure
        if self._on_launch is not None:
            try:
                self._on_launch(self)
            except Exception:
                log.exception("BatchVerifier on_launch hook raised")
