"""AggSigDB — store of final aggregate signatures with blocking Await.

Mirrors reference core/aggsigdb/memory.go:29-184: write-once semantics (a
second, different write for the same key errors), blocked queries parked
until a write resolves them.  The reference uses a single-writer goroutine
over command channels; asyncio's single-threaded loop gives the same
serialisation for free, so this is plain dict + futures.  A copy of the
JAX package's core/aggsigdb.py.
"""

from __future__ import annotations

import asyncio
from collections import defaultdict

from .types import Duty, PubKey, SignedData


class AggSigDBError(Exception):
    pass


class MemAggSigDB:
    def __init__(self) -> None:
        self._data: dict[tuple[Duty, PubKey], SignedData] = {}
        self._waiters: dict[tuple[Duty, PubKey], list[asyncio.Future]] = defaultdict(list)

    async def store(self, duty: Duty, pubkey: PubKey,
                    data: SignedData) -> None:
        key = (duty, pubkey)
        existing = self._data.get(key)
        if existing is not None:
            if existing != data:
                raise AggSigDBError(
                    f"mismatching aggregate signature write for {duty}/{pubkey}")
            return
        self._data[key] = data
        for fut in self._waiters.pop(key, []):
            if not fut.done():
                fut.set_result(data)

    async def await_(self, duty: Duty, pubkey: PubKey) -> SignedData:
        key = (duty, pubkey)
        if key in self._data:
            return self._data[key]
        fut = asyncio.get_running_loop().create_future()
        self._waiters[key].append(fut)
        return await fut

    def trim(self, duty: Duty) -> None:
        for key in [k for k in self._data if k[0] == duty]:
            del self._data[key]
