"""Duty Deadliner — expiry of in-flight duty state.

Mirrors reference core/deadline.go:30-160: each duty gets a deadline of
`slot_start + late_factor·slot_duration` (late_factor = 5, min 30s in the
reference); DBs `Add()` duties and get an async stream of expired duties to
trim.  Uses an injectable clock for deterministic tests (the reference
threads clockwork the same way).

A copy of the JAX package's core/deadline.py, whole."""

from __future__ import annotations

import asyncio
import heapq
import time
from typing import AsyncIterator, Callable

from .types import Duty

LATE_FACTOR = 5  # slots (reference: core/deadline.go:30-35)


def duty_deadline(duty: Duty, genesis_time: float, slot_duration: float,
                  late_factor: int = LATE_FACTOR) -> float:
    """Absolute unix deadline for a duty.  EXIT/BUILDER_REGISTRATION never
    expire (reference: core/deadline.go dutyExpired special cases)."""
    from .types import DutyType

    if duty.type in (DutyType.EXIT, DutyType.BUILDER_REGISTRATION):
        return float("inf")
    start = genesis_time + duty.slot * slot_duration
    return start + late_factor * slot_duration


class Deadliner:
    """Async deadline manager: `add(duty)`, then iterate `expired()`.

    Single internal task orders deadlines in a heap; duplicate adds are
    deduped (reference: core/deadline.go:37-123 semantics).

    The `clock` is fully injectable (default ``time.time``): deadline
    comparisons never touch wall time directly, and `poke()` forces an
    immediate re-evaluation, so a fake clock that jumped forward can
    deterministically drive expiry without waiting out the poll cap —
    the contract the chaos simnet (testutil/chaos.py) and any fake-clock
    unit test rely on."""

    def __init__(self, deadline_fn: Callable[[Duty], float],
                 clock: Callable[[], float] = time.time):
        self._deadline_fn = deadline_fn
        self._clock = clock
        self._heap: list[tuple[float, int, Duty]] = []
        self._pending: set[Duty] = set()
        self._seq = 0
        self._wake = asyncio.Event()
        self._queue: asyncio.Queue[Duty] = asyncio.Queue()
        self._task: asyncio.Task | None = None
        self._closed = False

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._run())

    def add(self, duty: Duty) -> bool:
        """Register a duty; returns False iff its deadline already passed.
        Duplicate adds are deduped and return True."""
        if duty in self._pending:
            return True
        dl = self._deadline_fn(duty)
        if dl <= self._clock():
            return False
        self._pending.add(duty)
        self._seq += 1
        heapq.heappush(self._heap, (dl, self._seq, duty))
        self._wake.set()
        return True

    def poke(self) -> None:
        """Force the run loop to re-read the clock and expire anything
        due — the deterministic hand-crank for fake-clock tests (a jumped
        clock otherwise waits out the 1 s poll cap below)."""
        self._wake.set()

    async def expired(self) -> AsyncIterator[Duty]:
        """Async stream of duties whose deadline has passed."""
        while not self._closed:
            duty = await self._queue.get()
            yield duty

    async def _run(self) -> None:
        while not self._closed:
            if not self._heap:
                self._wake.clear()
                await self._wake.wait()
                continue
            dl, _, duty = self._heap[0]
            now = self._clock()
            if dl <= now:
                heapq.heappop(self._heap)
                self._pending.discard(duty)
                await self._queue.put(duty)
                continue
            self._wake.clear()
            try:
                await asyncio.wait_for(self._wake.wait(),
                                       timeout=min(dl - now, 1.0))
            except asyncio.TimeoutError:
                pass

    def stop(self) -> None:
        self._closed = True
        if self._task is not None:
            self._task.cancel()
