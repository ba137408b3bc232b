"""Serving layer — request coalescing, slot-scoped duty-data caching and
admission control for the validator-API surface.

ROADMAP item 4: `app/router.py` + `core/validatorapi.py` +
`eth2util/beacon_client.py` served every VC request with a fresh upstream
round-trip.  At "millions of users" scale the duty data is massively
shared — N validator clients ask for the SAME attestation data per
(slot, committee), the SAME duties per epoch, the SAME spec/genesis —
so the serving layer collapses that fan-in three ways (reference:
app/eth2wrap/eth2wrap.go:161-218 multi-client fan-out + its success
cache; core/validatorapi/router.go:771-829 proxy):

- **single-flight coalescing** (`SingleFlightCache`): concurrent
  requesters of one key share ONE in-flight upstream fetch.  A failed
  fetch rejects every waiter and caches nothing — failures never
  poison the cache.
- **slot/epoch-scoped caching**: entries carry a deadline in the
  injected clock's domain — attestation data dies at its slot
  boundary, duties at their epoch boundary, spec/genesis are immortal
  — plus an LRU bound so the cache never grows without limit.
- **admission control** (`AdmissionController`): per-endpoint-class
  concurrency semaphores with a bounded wait queue; requests beyond
  the queue depth (or wait budget) are shed with `ShedError`, which
  the router turns into `503 + Retry-After`.

`CachingBeaconClient` applies the same cache in front of any
beacon-client duck-type (BeaconClient, MultiBeaconClient, BeaconMock)
so the scheduler/fetcher path benefits too, with optional bounded
retries absorbing a flapping upstream.

A copy of the JAX package's app/serving.py.  One deliberate difference:
the port speaks HTTP through its own `app/http1.py`, not aiohttp, so the
retryable set (`RETRYABLE_ERRORS`) names `http1.HTTPError` and `OSError`
(a refused or reset connection) where the JAX one names
``aiohttp.ClientError``.
"""

from __future__ import annotations

import asyncio
import time
from collections import OrderedDict, defaultdict
from dataclasses import dataclass, field

from ..eth2util.beacon_client import BeaconApiError
from .http1 import HTTPError
from .retry import backoff_delays


class ShedError(Exception):
    """Raised when admission control rejects a request (queue full)."""

    def __init__(self, endpoint: str, retry_after: float):
        super().__init__(f"serving capacity exceeded for {endpoint}")
        self.endpoint = endpoint
        self.retry_after = retry_after


def endpoint_class(method: str, path: str) -> str:
    """Bounded endpoint-class label for metrics/admission: every request
    maps into one of a FIXED set of classes (unbounded label values are
    a series factory — see metrics_lint's cardinality guard)."""
    if "/validator/attestation_data" in path:
        return "attestation_data"
    if "/validator/duties/" in path:
        return "duties"
    if "/validators" in path:
        return "validators"
    if "/blocks" in path or "/blinded_blocks" in path:
        return "block"
    if "/validator/aggregate" in path or "/validator/contribution" in path:
        return "aggregate"
    if method == "POST":
        return "submit"
    if path in ("/eth/v1/beacon/genesis", "/eth/v1/config/spec",
                "/eth/v1/config/fork_schedule",
                "/eth/v1/config/deposit_contract"):
        return "metadata"
    return "proxy"


class SingleFlightCache:
    """Coalescing cache: one in-flight fetch per key, shared by all
    concurrent requesters; results stored until a deadline (or forever)
    under an LRU bound.

    The clock is injectable so slot-boundary deadlines work under both
    wall time and the chaos simnet's virtual time, and so fake-clock
    tests can drive expiry deterministically."""

    def __init__(self, clock=time.monotonic, max_entries: int = 4096,
                 registry=None):
        self._clock = clock
        self._max = max_entries
        self._registry = registry
        #: key -> (value, deadline | None for immortal), LRU-ordered
        self._entries: OrderedDict = OrderedDict()
        self._inflight: dict = {}
        self.hits: dict = defaultdict(int)
        self.misses: dict = defaultdict(int)
        self.coalesced: dict = defaultdict(int)

    def stats(self) -> dict:
        """Per-endpoint counters (bench/test assertion point)."""
        eps = set(self.hits) | set(self.misses) | set(self.coalesced)
        return {ep: {"hits": self.hits[ep], "misses": self.misses[ep],
                     "coalesced": self.coalesced[ep]} for ep in sorted(eps)}

    def invalidate(self, endpoint: str | None = None) -> None:
        if endpoint is None:
            self._entries.clear()
            return
        for k in [k for k in self._entries if k[0] == endpoint]:
            del self._entries[k]

    async def get(self, endpoint: str, key, fetch, ttl: float | None = None,
                  deadline: float | None = None, cache_if=None):
        """Serve `(endpoint, key)` from cache, join the in-flight fetch,
        or start one.  `ttl` is seconds-from-now; `deadline` an absolute
        clock value (slot/epoch boundary) and wins over ttl; both None
        means immortal (LRU-bounded).  `cache_if(value)` can veto
        storing (e.g. only cache 200 responses) — waiters still share
        the uncached result."""
        k = (endpoint, key)
        ent = self._entries.get(k)
        if ent is not None:
            value, dl = ent
            if dl is None or self._clock() < dl:
                self._entries.move_to_end(k)
                self.hits[endpoint] += 1
                if self._registry is not None:
                    self._registry.inc("app_serving_cache_hits_total",
                                       labels={"endpoint": endpoint})
                return value
            del self._entries[k]
        task = self._inflight.get(k)
        if task is not None:
            self.coalesced[endpoint] += 1
            if self._registry is not None:
                self._registry.inc("app_serving_coalesced_total",
                                   labels={"endpoint": endpoint})
            # shield: a cancelled waiter must not kill the shared fetch
            return await asyncio.shield(task)
        self.misses[endpoint] += 1
        if self._registry is not None:
            self._registry.inc("app_serving_cache_misses_total",
                               labels={"endpoint": endpoint})
        if deadline is None and ttl is not None:
            deadline = self._clock() + ttl
        task = asyncio.get_running_loop().create_task(
            self._fill(k, fetch, deadline, cache_if))
        self._inflight[k] = task
        return await asyncio.shield(task)

    async def _fill(self, k, fetch, deadline, cache_if):
        try:
            value = await fetch()
        except BaseException:
            # reject every waiter, cache nothing: the next request
            # starts a fresh fetch instead of replaying the failure
            self._inflight.pop(k, None)
            raise
        if cache_if is None or cache_if(value):
            self._entries[k] = (value, deadline)
            self._entries.move_to_end(k)
            while len(self._entries) > self._max:
                self._entries.popitem(last=False)
        # store BEFORE dropping the in-flight marker: a request landing
        # in between must hit the cache, not start a duplicate fetch
        self._inflight.pop(k, None)
        return value


class AdmissionController:
    """Per-endpoint-class concurrency semaphores with a bounded wait
    queue (reference: the router.go proxy's implicit backpressure via
    Go's connection limits, made explicit).

    A request beyond `limit` concurrent peers waits; beyond `queue`
    waiters (or past `max_wait` seconds of queueing) it is shed with
    `ShedError` so the client backs off instead of piling latency."""

    def __init__(self, limits: dict | None = None, default_limit: int = 64,
                 default_queue: int = 128, max_wait: float | None = None,
                 retry_after: float = 1.0, registry=None):
        self._limits = dict(limits or {})  # endpoint -> (limit, queue)
        self._default = (default_limit, default_queue)
        self._max_wait = max_wait
        self.retry_after = retry_after
        self._registry = registry
        self._sems: dict = {}
        self._waiting: dict = defaultdict(int)
        self._inflight: dict = defaultdict(int)
        self.shed: dict = defaultdict(int)
        self.admitted: dict = defaultdict(int)

    def admit(self, endpoint: str) -> "_Admission":
        return _Admission(self, endpoint)

    def _limit_for(self, endpoint: str) -> tuple:
        return self._limits.get(endpoint, self._default)

    def _set_inflight(self, endpoint: str) -> None:
        if self._registry is not None:
            self._registry.set_gauge("app_vapi_inflight",
                                     float(self._inflight[endpoint]),
                                     labels={"endpoint": endpoint})

    def _shed(self, endpoint: str) -> None:
        self.shed[endpoint] += 1
        if self._registry is not None:
            self._registry.inc("app_vapi_shed_total",
                               labels={"endpoint": endpoint})
        raise ShedError(endpoint, self.retry_after)


class _Admission:
    """Async context manager for one admitted request."""

    def __init__(self, ctl: AdmissionController, endpoint: str):
        self._ctl = ctl
        self._ep = endpoint

    async def __aenter__(self):
        ctl, ep = self._ctl, self._ep
        limit, queue = ctl._limit_for(ep)
        sem = ctl._sems.get(ep)
        if sem is None:
            sem = ctl._sems[ep] = asyncio.Semaphore(limit)
        if sem.locked() and ctl._waiting[ep] >= queue:
            ctl._shed(ep)
        ctl._waiting[ep] += 1
        try:
            if ctl._max_wait is not None:
                try:
                    await asyncio.wait_for(sem.acquire(), ctl._max_wait)
                except asyncio.TimeoutError:
                    ctl._shed(ep)
            else:
                await sem.acquire()
        finally:
            ctl._waiting[ep] -= 1
        ctl.admitted[ep] += 1
        ctl._inflight[ep] += 1
        ctl._set_inflight(ep)
        return self

    async def __aexit__(self, exc_type, exc, tb) -> None:
        ctl, ep = self._ctl, self._ep
        ctl._inflight[ep] -= 1
        ctl._sems[ep].release()
        ctl._set_inflight(ep)


@dataclass
class ServingConfig:
    """Knobs for the router's serving layer (cache TTLs, upstream
    connection pool, admission bounds)."""

    max_entries: int = 4096
    #: TTL for mapped upstream duty fetches (duties are epoch-scoped but
    #: the router has no chain clock; epochs are 384 s on mainnet)
    duties_ttl: float = 384.0
    #: validators-snapshot TTL (balances/status drift within an epoch)
    validators_ttl: float = 12.0
    #: attestation-data TTL behind the vapi handler (keys carry the
    #: slot, so this only bounds residency, not freshness)
    att_data_ttl: float = 64.0
    pool_limit: int = 64
    admission_limits: dict = field(default_factory=dict)
    default_limit: int = 64
    default_queue: int = 128
    max_wait: float | None = None
    retry_after: float = 1.0


#: Transient upstream failures worth retrying (a flapping beacon node);
#: anything else propagates immediately.
RETRYABLE_ERRORS = (BeaconApiError, HTTPError, OSError,
                    asyncio.TimeoutError, ConnectionError)


class CachingBeaconClient:
    """Slot/epoch-scoped caching + single-flight + bounded-retry wrapper
    over a beacon-client duck-type, so the scheduler/fetcher duty path
    shares fetches exactly like the VC-facing surface.

    Learns chain timing (slot duration, slots/epoch, genesis) from the
    first spec/genesis responses unless given up front; deadlines are
    computed in the injected clock's domain, so the wrapper works under
    wall time and the chaos simnet's virtual time alike."""

    def __init__(self, inner, clock=time.time, registry=None,
                 retries: int = 0, retry_base: float = 0.05, sleep=None,
                 rng=None, slot_duration: float | None = None,
                 slots_per_epoch: int | None = None,
                 genesis_time: float | None = None,
                 max_entries: int = 4096):
        self.inner = inner
        self._clock = clock
        self.cache = SingleFlightCache(clock=clock, max_entries=max_entries,
                                       registry=registry)
        self._retries = retries
        self._retry_base = retry_base
        self._sleep = sleep if sleep is not None else asyncio.sleep
        self._rng = rng
        self._slot_duration = slot_duration
        self._spe = slots_per_epoch
        self._genesis = genesis_time

    def __getattr__(self, name: str):
        # submissions, aggregates, health checks, close() — pass through
        # uncached (mutations must reach the BN; health must stay live)
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    async def _call(self, fetch):
        """Bounded retry with jittered exponential backoff over the
        transient upstream failure set."""
        attempts = self._retries
        delays = backoff_delays(base=self._retry_base, rng=self._rng)
        while True:
            try:
                return await fetch()
            except RETRYABLE_ERRORS:
                if attempts <= 0:
                    raise
                attempts -= 1
                await self._sleep(next(delays))

    # -- deadline helpers ----------------------------------------------------

    def _slot_deadline(self, slot: int) -> float | None:
        if self._genesis is None or self._slot_duration is None:
            return None
        return self._genesis + (slot + 1) * self._slot_duration

    def _epoch_deadline(self, epoch: int) -> float | None:
        if (self._genesis is None or self._slot_duration is None
                or self._spe is None):
            return None
        return self._genesis + (epoch + 1) * self._spe * self._slot_duration

    # -- cached reads --------------------------------------------------------

    async def spec(self) -> dict:
        out = await self.cache.get(
            "beacon/spec", (), lambda: self._call(self.inner.spec))
        if isinstance(out, dict):
            if self._slot_duration is None and "SECONDS_PER_SLOT" in out:
                self._slot_duration = float(out["SECONDS_PER_SLOT"])
            if self._spe is None and "SLOTS_PER_EPOCH" in out:
                self._spe = int(out["SLOTS_PER_EPOCH"])
            return dict(out)
        return out

    async def genesis_time(self) -> float:
        out = await self.cache.get(
            "beacon/genesis", (),
            lambda: self._call(self.inner.genesis_time))
        if self._genesis is None:
            self._genesis = float(out)
        return out

    async def genesis_validators_root(self) -> bytes:
        return await self.cache.get(
            "beacon/genesis_validators_root", (),
            lambda: self._call(self.inner.genesis_validators_root))

    async def active_validators(self, pubkeys):
        key = tuple(sorted(str(pk) for pk in pubkeys))
        ttl = (self._spe * self._slot_duration
               if self._spe and self._slot_duration else 384.0)
        out = await self.cache.get(
            "beacon/validators", key,
            lambda: self._call(
                lambda: self.inner.active_validators(pubkeys)),
            ttl=ttl)
        return dict(out)

    async def attester_duties(self, epoch: int, indices):
        return list(await self._duties("attester_duties", epoch, indices))

    async def proposer_duties(self, epoch: int, indices):
        return list(await self._duties("proposer_duties", epoch, indices))

    async def sync_duties(self, epoch: int, indices):
        return list(await self._duties("sync_duties", epoch, indices))

    async def _duties(self, method: str, epoch: int, indices):
        fn = getattr(self.inner, method)
        ttl = None
        deadline = self._epoch_deadline(epoch)
        if deadline is None:
            ttl = (self._spe * self._slot_duration
                   if self._spe and self._slot_duration else 384.0)
        return await self.cache.get(
            "beacon/duties", (method, epoch, tuple(sorted(indices))),
            lambda: self._call(lambda: fn(epoch, list(indices))),
            ttl=ttl, deadline=deadline)

    async def attestation_data(self, slot: int, committee_index: int):
        deadline = self._slot_deadline(slot)
        ttl = None
        if deadline is None:
            ttl = self._slot_duration if self._slot_duration else 12.0
        return await self.cache.get(
            "beacon/attestation_data", (slot, committee_index),
            lambda: self._call(
                lambda: self.inner.attestation_data(slot, committee_index)),
            ttl=ttl, deadline=deadline)
