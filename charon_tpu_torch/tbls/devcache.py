"""Device-resident row caches of the verify path: decompressed pubkeys and
hashed messages kept on the card.

A copy of the JAX package's tbls/devcache.py with a torch store.  A
cache-hit row costs no host→device bytes: the prep stage looks up slot
indices on the host and gathers the hit rows on the card, and only the
miss rows are computed (on the card) and committed.

- The store is one int32 tensor ``[planes, 32, capacity]`` on the
  backend's device, limbs-major: the layout the port's kernels take (a G1
  pubkey is 3 planes, an affine G2 point ``[3, 2, 32]`` is 6), allocated
  at first use.  Slot *s* is column *s*.
- The keying, LRU order, free list and per-slot ``ok`` flags are host
  bookkeeping (an OrderedDict of key → slot), exactly the JAX module's, so
  the same key sequence gets the same slots and counters.
- Every store operation — the `commit` write (`index_copy_`) and the
  gather of a batch's rows (`index_select`) — runs under the cache's lock
  on ONE stream the cache owns: the prep, launch and prewarm threads all
  touch the store, and one stream orders their operations as the lock
  did.  Rows a caller hands in are computed on the caller's stream: the
  cache's stream waits for it, and the rows are marked as used there
  (`record_stream`) so the caching allocator cannot reuse them early.
  Gathered rows go back the other way: the caller's stream waits on an
  event recorded after the gather, and the rows are marked as used on it.
- `lookup_rows` gathers the hit rows under the same lock as the lookup,
  so no concurrent commit can evict a hit slot between the two.  Miss
  positions hold slot 0's row; the caller overwrites them with its own
  computed rows and commits those for FUTURE batches only.
- A commit that would have to evict a row inserted by the same commit
  returns −1 for the excess keys (overflow: counted, not cached).

On the CPU (tests) the store is a CPU tensor and there is no stream.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

#: capacity granularity, whole 128-row columns (the JAX store's lane tile)
LANES = 128
NLIMBS = 32
INT32 = 4

#: default device allowance of the two caches together, split pk 1/3 and
#: hm 2/3 (a pk row is half an hm row, so both get the same row count)
DEVCACHE_DEFAULT_MB = 96.0
PK_SHARE, HM_SHARE = 1 / 3, 2 / 3


def devcache_budget_bytes(mb: float = DEVCACHE_DEFAULT_MB) -> int:
    """Bytes of a budget of `mb` MiB; a non-positive budget is refused (a
    zero-capacity cache would evict every row at insert)."""
    if mb <= 0:
        raise ValueError(f"devcache budget {mb} MiB must be positive")
    return int(mb * 1024 * 1024)


def devcache_row_bytes(n_planes: int) -> int:
    """Device bytes one cached row holds: `n_planes` Fp limb planes."""
    return n_planes * NLIMBS * INT32


def devcache_capacity_rows(n_planes: int, share: float = 1.0,
                           budget: int | None = None) -> int:
    """Row capacity of one cache under its share of `budget` bytes,
    rounded down to whole `LANES` columns with a one-column floor."""
    if budget is None:
        budget = devcache_budget_bytes()
    rows = int(budget * share) // devcache_row_bytes(n_planes)
    return max(LANES, (rows // LANES) * LANES)


class DeviceRowCache:
    """Fixed-capacity device-resident LRU row cache (module docstring)."""

    def __init__(self, name: str, n_planes: int, capacity_rows: int,
                 device="cpu"):
        if capacity_rows < LANES or capacity_rows % LANES:
            raise ValueError(
                f"devcache {name!r}: capacity {capacity_rows} rows must be "
                f"a positive multiple of {LANES}")
        self.name = name
        self.n_planes = n_planes
        self.capacity_rows = capacity_rows
        self.device = torch.device(device)
        self._store: torch.Tensor | None = None   # lazy [P, 32, capacity]
        self._slots: OrderedDict[bytes, int] = OrderedDict()
        self._free = list(range(capacity_rows - 1, -1, -1))
        self._ok = np.ones(capacity_rows, bool)
        self._lock = threading.Lock()
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        # cumulative counters
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.inserts = 0
        self.overflows = 0

    # -- store plumbing (callers hold the lock) ------------------------------

    def _ensure_store(self) -> torch.Tensor:
        if self._store is None:
            self._store = torch.zeros(
                (self.n_planes, NLIMBS, self.capacity_rows),
                dtype=torch.int32, device=self.device)
        return self._store

    def _index(self, idx: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(idx, np.int64)).to(
            self.device)

    def _gather_locked(self, idx: np.ndarray) -> torch.Tensor:
        """Rows [P, 32, n] at slots `idx` (−1 read as slot 0), as a fresh
        tensor the caller's stream may use."""
        sel = np.maximum(idx, 0)
        if self._stream is None:
            return self._ensure_store().index_select(2, self._index(sel))
        caller = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(caller)
        with torch.cuda.stream(self._stream):
            rows = self._ensure_store().index_select(2, self._index(sel))
            done = torch.cuda.Event()
            done.record(self._stream)
        caller.wait_event(done)
        rows.record_stream(caller)
        return rows

    def _write_locked(self, slots: np.ndarray, rows: torch.Tensor) -> None:
        if self._stream is None:
            self._ensure_store().index_copy_(2, self._index(slots), rows)
            return
        caller = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(caller)
        rows.record_stream(self._stream)
        with torch.cuda.stream(self._stream):
            self._ensure_store().index_copy_(2, self._index(slots), rows)

    def row_bytes(self) -> int:
        return devcache_row_bytes(self.n_planes)

    # -- public --------------------------------------------------------------

    def _lookup_locked(self, keys) -> tuple[np.ndarray, np.ndarray, list]:
        idx = np.empty(len(keys), np.int32)
        ok = np.ones(len(keys), bool)
        missing: dict[bytes, None] = {}
        for k, key in enumerate(keys):
            slot = self._slots.get(key)
            if slot is None:
                idx[k] = -1
                missing[key] = None
            else:
                self._slots.move_to_end(key)
                idx[k] = slot
                ok[k] = self._ok[slot]
        n_miss = int((idx < 0).sum())
        self.hits += len(keys) - n_miss
        self.misses += n_miss
        return idx, ok, list(missing)

    def lookup(self, keys) -> tuple[np.ndarray, np.ndarray, list]:
        """→ (slot idx int32 [n], −1 for a miss; ok bool [n]; the
        deduplicated miss keys in first-seen order).  Hits become the most
        recently used.  Bookkeeping only: a batch that needs the rows takes
        `lookup_rows`."""
        with self._lock:
            return self._lookup_locked(keys)

    def lookup_rows(self, keys):
        """→ (idx, ok, missing, rows [P, 32, n]): the lookup and the gather
        of the hit rows under one lock acquisition, so no concurrent commit
        can evict a hit slot in between.  Miss positions hold slot 0's
        row."""
        with self._lock:
            idx, ok, missing = self._lookup_locked(keys)
            rows = self._gather_locked(idx)
        return idx, ok, missing, rows

    def commit(self, keys, rows: torch.Tensor, ok, protect=None
               ) -> np.ndarray:
        """Insert `rows` [P, 32, m] (on the cache's device) for `keys`,
        evicting least recently used rows as needed — for FUTURE batches:
        callers take the current batch's rows from `lookup_rows` and their
        own computed rows, never from the slots assigned here.  Slots
        allocated within this commit, and the caller's `protect` slots, are
        never evicted; a key with nothing left to evict gets −1 (overflow:
        counted, not cached)."""
        if not len(keys):
            return np.empty(0, np.int32)
        protected = {int(s) for s in (protect if protect is not None else ())
                     if int(s) >= 0}
        slots = np.empty(len(keys), np.int32)
        with self._lock:
            for j, key in enumerate(keys):
                slot = self._slots.get(key)
                if slot is not None:            # raced in by another thread
                    self._slots.move_to_end(key)
                elif self._free:
                    slot = self._free.pop()
                    self._slots[key] = slot
                    self.inserts += 1
                else:
                    slot = None
                    for old_key, old_slot in self._slots.items():
                        if old_slot not in protected:
                            slot = old_slot
                            break
                    if slot is None:            # everything belongs to this
                        slots[j] = -1           # commit: overflow
                        self.overflows += 1
                        continue
                    del self._slots[old_key]
                    self._slots[key] = slot
                    self.evictions += 1
                    self.inserts += 1
                protected.add(slot)
                self._ok[slot] = bool(ok[j])
                slots[j] = slot
            cached = np.flatnonzero(slots >= 0)
            if len(cached):
                if len(cached) < len(keys):
                    rows = rows.index_select(2, torch.from_numpy(
                        cached.astype(np.int64)).to(rows.device))
                self._write_locked(slots[cached], rows)
        return slots

    def gather(self, idx: np.ndarray) -> torch.Tensor:
        """Rows [P, 32, n] at slots `idx` (no −1: overflow positions are the
        caller's to patch) as a fresh tensor."""
        with self._lock:
            return self._gather_locked(np.asarray(idx))

    def clear(self) -> None:
        """Drop every resident row (tests, cold-cache reps); the counters
        stay cumulative and the store is released."""
        with self._lock:
            self._slots.clear()
            self._free = list(range(self.capacity_rows - 1, -1, -1))
            self._ok[:] = True
            self._store = None

    def stats(self) -> dict:
        with self._lock:
            rows = len(self._slots)
        return {
            "rows": rows,
            "capacity_rows": self.capacity_rows,
            "bytes": rows * self.row_bytes(),
            "capacity_bytes": self.capacity_rows * self.row_bytes(),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "inserts": self.inserts,
            "overflows": self.overflows,
        }
