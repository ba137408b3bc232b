"""Deadline-bounded async retry with jittered exponential backoff.

Mirrors reference app/retry/retry.go:41-250 (Retryer bound to duty
deadlines, 5s shutdown grace) + app/expbackoff/expbackoff.go:27-205
(gRPC-style jittered exponential backoff).  `with_async_retry` is the
wire option wrapping fetch/propose/broadcast edges
(reference: core/retry.go:24-57).

A copy of the JAX package's app/retry.py.
"""

from __future__ import annotations

import asyncio
import random
import time
from typing import Awaitable, Callable

from ..core.types import Duty


def backoff_delays(base: float = 0.1, factor: float = 1.6,
                   jitter: float = 0.2, max_delay: float = 5.0, rng=None):
    """Infinite generator of jittered exponential delays
    (reference: expbackoff.go defaults).  `rng` takes any object with a
    `uniform(a, b)` method (e.g. a seeded ``random.Random``) so callers
    that need bit-identical replay — the chaos simnet, the TCP mesh's
    reconnect gate — can pin the jitter; default stays the process
    global RNG."""
    delay = base
    u = (rng or random).uniform
    while True:
        yield delay * (1 + u(-jitter, jitter))
        delay = min(delay * factor, max_delay)


class Retryer:
    """Retries duty edges until the duty deadline expires."""

    def __init__(self, deadline_fn: Callable[[Duty], float],
                 shutdown_grace: float = 5.0):
        self._deadline_fn = deadline_fn
        self._tasks: set[asyncio.Task] = set()
        self._shutdown = False
        self._grace = shutdown_grace

    def spawn(self, name: str, duty: Duty,
              fn: Callable[[], Awaitable]) -> None:
        """Run fn with retries in the background (the async part of the
        reference's WithAsyncRetry)."""
        task = asyncio.get_running_loop().create_task(
            self._retry(name, duty, fn), name=name)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _retry(self, name: str, duty: Duty, fn) -> None:
        deadline = self._deadline_fn(duty)
        delays = backoff_delays()
        while not self._shutdown:
            try:
                await fn()
                return
            except asyncio.CancelledError:
                raise
            except Exception:
                remaining = deadline - time.time()
                if remaining <= 0:
                    import logging
                    logging.getLogger("charon_tpu_torch.retry").warning(
                        "%s for %s abandoned at deadline", name, duty)
                    return
                await asyncio.sleep(min(next(delays), max(0.0, remaining)))

    async def shutdown(self) -> None:
        """Give in-flight retries a grace period, then cancel
        (reference: retry.go 5s shutdown grace)."""
        self._shutdown = True
        if self._tasks:
            _, pending = await asyncio.wait(self._tasks,
                                            timeout=self._grace)
            for t in pending:
                t.cancel()


def with_async_retry(retryer: Retryer):
    """Wire option: wraps the retry-able edges with async retry
    (reference: core/retry.go:28-55 wraps FetcherFetch, ConsensusPropose,
    ParSigExBroadcast, BroadcasterBroadcast)."""

    def option(w: dict) -> None:
        def wrap_duty_fn(name: str, fn):
            async def wrapped(duty, *args):
                retryer.spawn(name, duty,
                              lambda: fn(duty, *args))
            return wrapped

        w["fetcher_fetch"] = wrap_duty_fn("fetcher_fetch",
                                          w["fetcher_fetch"])
        w["consensus_propose"] = wrap_duty_fn("consensus_propose",
                                              w["consensus_propose"])
        w["parsigex_broadcast"] = wrap_duty_fn("parsigex_broadcast",
                                               w["parsigex_broadcast"])
        w["broadcaster_broadcast"] = wrap_duty_fn("broadcaster_broadcast",
                                                  w["broadcaster_broadcast"])

    return option
