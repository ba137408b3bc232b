"""Fork-join concurrency utilities.

Mirrors reference app/forkjoin/forkjoin.go:37-262 (generic fork-join with
fail-fast) and the eth2wrap first-success fan-out
(reference: app/eth2wrap/eth2wrap.go:161-218).

A copy of the JAX package's app/forkjoin.py.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Iterable, TypeVar

T = TypeVar("T")
R = TypeVar("R")


async def forkjoin(inputs: Iterable[T], fn: Callable[[T], Awaitable[R]],
                   fail_fast: bool = True) -> list[R]:
    """Apply fn to all inputs concurrently.  fail_fast cancels siblings on
    the first exception (reference forkjoin's default)."""
    tasks = [asyncio.get_running_loop().create_task(fn(x)) for x in inputs]
    if fail_fast:
        try:
            return list(await asyncio.gather(*tasks))
        except BaseException:
            for t in tasks:
                t.cancel()
            raise
    results = await asyncio.gather(*tasks, return_exceptions=True)
    return list(results)


async def first_success(fns: list[Callable[[], Awaitable[R]]],
                        timeout: float | None = None) -> R:
    """Run all fns concurrently, return the first successful result and
    cancel the rest; raise the last error if all fail
    (reference: eth2wrap.go:161-218 provide/firstSuccess)."""
    if not fns:
        raise ValueError("no functions provided")
    tasks = [asyncio.get_running_loop().create_task(fn()) for fn in fns]
    last_exc: BaseException | None = None
    pending = set(tasks)
    try:
        while pending:
            done, pending = await asyncio.wait(
                pending, timeout=timeout,
                return_when=asyncio.FIRST_COMPLETED)
            if not done:  # timeout
                raise asyncio.TimeoutError("first_success timed out")
            for t in done:
                if t.exception() is None:
                    # async-ok: completed-task read (t is in the done set)
                    return t.result()
                last_exc = t.exception()
        raise last_exc  # all failed
    finally:
        for t in tasks:
            t.cancel()
