"""Lifecycle manager — ordered start/stop hooks.

Mirrors reference app/lifecycle/manager.go:35-98 + order.go: hooks are
registered with explicit global order constants, started in order, and
stopped in order on shutdown.  Start hooks are either awaited inline
(sync) or spawned as background tasks (async), like the reference's
HookFunc kinds.

A copy of the JAX package's app/lifecycle.py.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from enum import IntEnum
from typing import Awaitable, Callable


class StartOrder(IntEnum):
    """reference: app/lifecycle/order.go:28-56."""

    TRACKER = 1
    AGG_SIG_DB = 2
    RELAY = 3
    P2P_PING = 4
    P2P_ROUTERS = 5
    MONITOR_API = 6
    VALIDATOR_API = 7
    SCHEDULER = 8
    SIM_VALIDATOR_MOCK = 9


class StopOrder(IntEnum):
    SCHEDULER = 1
    RETRYER = 2
    VALIDATOR_API = 3
    TRACKER = 4
    P2P = 5
    MONITOR_API = 6


@dataclass
class _Hook:
    order: int
    name: str
    fn: Callable[[], Awaitable]
    background: bool


class Manager:
    def __init__(self) -> None:
        self._start_hooks: list[_Hook] = []
        self._stop_hooks: list[_Hook] = []
        self._tasks: list[asyncio.Task] = []
        self._started = False
        self._stopped = asyncio.Event()

    def register_start(self, order: StartOrder, name: str, fn,
                       background: bool = False) -> None:
        assert not self._started, "cannot register after start"
        self._start_hooks.append(_Hook(int(order), name, fn, background))

    def register_stop(self, order: StopOrder, name: str, fn) -> None:
        assert not self._started
        self._stop_hooks.append(_Hook(int(order), name, fn, False))

    async def run(self) -> None:
        """Start everything in order, block until stop() is called, then
        stop everything in order (reference: manager.go:78-98)."""
        self._started = True
        for hook in sorted(self._start_hooks, key=lambda h: h.order):
            if hook.background:
                self._tasks.append(
                    asyncio.get_running_loop().create_task(hook.fn(),
                                                         name=hook.name))
            else:
                await hook.fn()
        await self._stopped.wait()
        for hook in sorted(self._stop_hooks, key=lambda h: h.order):
            try:
                await hook.fn()
            except Exception:
                import logging
                logging.getLogger("charon_tpu_torch.lifecycle").exception(
                    "stop hook %s failed", hook.name)
        for t in self._tasks:
            t.cancel()

    def stop(self) -> None:
        self._stopped.set()
