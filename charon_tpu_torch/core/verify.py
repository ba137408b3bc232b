"""BatchVerifier — micro-batched BLS signature verification.

A copy of the JAX package's core/verify.py, wired to this package's
`tbls.dispatch` (trimmed: no tracer spans, inline mode, flush window,
per-path throughput gauges or packing counters).

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
    def __init__(self, on_launch=None):
        self._queue: list[_Pending] = []
        self._on_launch = on_launch     # fn(self), after every flush
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
        """One coalesced flush: run it, demux verdicts, fire the hook."""
        flat = [e for item in batch for e in item.entries]
        pipe = dispatch.default_pipeline()
        path = tbls.verify_path(len(flat))
        tiles = len(pipe.plan_verify(len(flat)))
        try:
            oks = await pipe.batch_verify(flat)
        except Exception as exc:
            for item in batch:
                if not item.done.done():
                    item.done.set_exception(exc)
            return
        self.launches += 1
        self.entries_total += len(flat)
        self.max_batch = max(self.max_batch, len(flat))
        self.paths[path] = self.paths.get(path, 0) + tiles
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
