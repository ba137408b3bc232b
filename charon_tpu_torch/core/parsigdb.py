"""ParSigDB — in-memory partial-signature store with threshold trigger.

Mirrors reference core/parsigdb/memory.go:
- store_internal (local VC sigs) → fan out to internal subscribers
  (ParSigEx broadcast) AND the same threshold logic.
- store_external (peer sigs) → dedupe by share index, detect equivocation
  (memory.go:159-191).
- When exactly `threshold` signatures with MATCHING message roots exist for
  a (duty, pubkey), fire subscribe_threshold once (memory.go:93-137,
  194-221) → SigAgg.
- trim(duty) GC via Deadliner (memory.go:141-155).

A copy of the JAX package's core/parsigdb.py.
"""

from __future__ import annotations

from collections import defaultdict

from .types import Duty, ParSignedData, ParSignedDataSet, PubKey


class EquivocationError(Exception):
    """Same share index submitted two different signatures."""


class MemParSigDB:
    def __init__(self, threshold: int) -> None:
        self._threshold = threshold
        self._sigs: dict[tuple[Duty, PubKey], list[ParSignedData]] = defaultdict(list)
        self._fired: set[tuple[Duty, PubKey]] = set()
        self._internal_subs: list = []
        self._threshold_subs: list = []

    def subscribe_internal(self, fn) -> None:
        self._internal_subs.append(fn)

    def subscribe_threshold(self, fn) -> None:
        self._threshold_subs.append(fn)

    async def store_internal(self, duty: Duty, pset: ParSignedDataSet) -> None:
        await self._store(duty, pset)
        for fn in self._internal_subs:
            await fn(duty, pset)

    async def store_external(self, duty: Duty, pset: ParSignedDataSet) -> None:
        await self._store(duty, pset)

    async def _store(self, duty: Duty, pset: ParSignedDataSet) -> None:
        for pubkey, psig in pset.items():
            key = (duty, pubkey)
            existing = self._sigs[key]
            dup = False
            for prev in existing:
                if prev.share_idx == psig.share_idx:
                    if prev.signature != psig.signature:
                        raise EquivocationError(
                            f"equivocation by share {psig.share_idx} "
                            f"for {duty}/{pubkey}")
                    dup = True
                    break
            if dup:
                continue
            existing.append(psig)
            await self._maybe_fire(duty, pubkey, existing)

    async def _maybe_fire(self, duty: Duty, pubkey: PubKey,
                          sigs: list[ParSignedData]) -> None:
        """Fire threshold subscribers exactly once, with the first
        `threshold` sigs agreeing on the message root
        (reference: memory.go:194-221 matches roots, not just counts)."""
        key = (duty, pubkey)
        if key in self._fired:
            return
        by_root: dict[bytes, list[ParSignedData]] = defaultdict(list)
        for s in sigs:
            by_root[s.message_root()].append(s)
        for root, group in by_root.items():
            if len(group) == self._threshold:
                self._fired.add(key)
                for fn in self._threshold_subs:
                    await fn(duty, pubkey, list(group))
                return

    def trim(self, duty: Duty) -> None:
        for key in [k for k in self._sigs if k[0] == duty]:
            del self._sigs[key]
        self._fired = {k for k in self._fired if k[0] != duty}
