"""Deterministic race harness — the RUNTIME twin of the static
lock-discipline pass.

A copy of the JAX package's testutil/racecheck.py on this package's
modules.  Its static twin, `charon_tpu_torch.analysis.concurrency`,
proves lexically that every read-modify-write of a declared guarded
attribute sits inside ``with <lock>`` (its `SHARED_STATE_SPECS`); here
the guarded attributes are declared by each scenario.  A static pass cannot
see attributes mutated through aliases, `setattr`, or C-level code, and
it cannot observe lock-order inversions that only materialise across
call chains; this harness checks them at runtime:

- `InstrumentedLock` wraps a real ``threading.Lock``/``RLock``: it
  records per-thread acquisition order, builds the runtime lock-order
  graph, and reports an inversion the moment thread B acquires locks in
  the reverse order of an edge thread A already established.
- `RaceHarness.guard(obj, spec)` swaps the object's class for a
  generated subclass whose ``__setattr__`` checks — on every write to a
  declared guarded attribute — that the declared lock is held by the
  writing thread, and records which threads write each attribute
  (mutation-from-≥2-threads evidence for the report).

Scenarios are pure functions of their seed (mirroring the chaos.py
replay contract): every failure message embeds the replay command and
`RaceCheckResult.fingerprint()` digests everything the assertions look
at — violations, writer sets, and the deterministic final counters —
never wall-clock values, so a re-run from the printed seed is
bit-identical even though thread interleavings differ.

    python -m charon_tpu_torch.testutil.racecheck --scenario dispatch_stress

`dispatch_stress` drives concurrent scrape/prep/launch/prewarm/
devcache-commit traffic against ONE `DispatchPipeline` with every
pre-existing race fix instrumented (dispatch counters, devcache lookup,
Registry render, tracer ring) and must come back clean.  The port's
pipeline takes no tile (`dispatch.VERIFY_TILE` is a constant), and its
device store takes ``[planes, 32, m]`` row tensors on its own device.
With ``--tbls-scheme bls`` the verifies, the prewarm (its graph
captures included) and the store run on the card, through a fresh
`CUDABackend` registered for the run, whose ``_totals_lock`` and
``_cache_lock`` are instrumented too;
`unguarded_mutation` and `lock_inversion` are self-test fixtures that
must each report their planted bug (exact attribute + thread pair;
named cycle).

Detection is at ``__setattr__`` granularity: in-place container
mutations (``self.d[k] += 1``) rebind no attribute and are the static
pass's job; the harness covers the counter/scalar rebinding class of
race.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import random
import sys
import threading
from dataclasses import dataclass, field

# ---------------------------------------------------------------------------
# Harness
# ---------------------------------------------------------------------------


class InstrumentedLock:
    """Drop-in ``with``-able shim over a real lock.  Reentrant iff the
    wrapped lock is (wrap the object's own RLock to keep semantics)."""

    def __init__(self, harness: "RaceHarness", name: str, inner=None):
        self._h = harness
        self.name = name
        # lock-ok: delegate primitive; discipline is checked by the
        # harness itself, not declared in SharedStateSpec
        self._inner = inner if inner is not None else threading.Lock()
        self._depth = threading.local()

    def held_by_current_thread(self) -> bool:
        return getattr(self._depth, "n", 0) > 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            n = getattr(self._depth, "n", 0)
            if n == 0:
                self._h._note_acquire(self.name)
            self._depth.n = n + 1
        return got

    def release(self) -> None:
        n = getattr(self._depth, "n", 0)
        if n == 1:
            self._h._note_release(self.name)
        self._depth.n = max(0, n - 1)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class RaceHarness:
    """Shared recorder for one scenario run.

    Violations are kept as a SET of formatted strings: an unguarded
    write that fires N times (N varies with interleaving) is one
    deterministic finding, which is what keeps `fingerprint()`
    bit-identical across replays."""

    def __init__(self):
        self._tls = threading.local()
        # lock-ok: harness-internal bookkeeping, not subject to a spec
        self._meta = threading.Lock()
        self.order_edges: dict = {}    # (first, second) -> thread name
        self.violations: set = set()
        self.writers: dict = {}        # (scope, attr) -> set of threads
        self._locks: dict = {}         # name -> InstrumentedLock
        self._guards: dict = {}        # id(obj) -> (scope, {attr: lock})
        self._guard_classes: dict = {} # original class -> subclass

    # -- locks ---------------------------------------------------------------

    def make_lock(self, name: str, inner=None) -> InstrumentedLock:
        lk = InstrumentedLock(self, name, inner)
        with self._meta:
            self._locks[name] = lk
        return lk

    def instrument_attr_lock(self, obj, attr: str,
                             name: str) -> InstrumentedLock:
        """Swap ``obj.<attr>`` (a real lock) for an instrumented shim —
        every ``with self.<attr>`` site in the object's methods now
        reports into this harness."""
        lk = self.make_lock(name, inner=getattr(obj, attr))
        object.__setattr__(obj, attr, lk)
        return lk

    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _note_acquire(self, name: str) -> None:
        held = self._held()
        tname = threading.current_thread().name
        with self._meta:
            for h in held:
                if (name, h) in self.order_edges:
                    other = self.order_edges[(name, h)]
                    lo, hi = sorted((h, name))
                    self.violations.add(
                        f"lock-order inversion: cycle {lo} -> {hi} -> {lo} "
                        f"(thread '{tname}' acquired {name} while holding "
                        f"{h}; thread '{other}' established {name} -> {h})")
                self.order_edges.setdefault((h, name), tname)
        held.append(name)

    def _note_release(self, name: str) -> None:
        held = self._held()
        if name in held:
            held.remove(name)

    # -- guarded attributes --------------------------------------------------

    def guard(self, obj, scope: str, attr_locks: dict) -> None:
        """Enforce `attr_locks` (guarded attr -> InstrumentedLock name)
        on every future attribute REBIND of `obj`: the declared lock
        must be held by the writing thread.  Also records the writer
        thread set per attribute (the ≥2-threads evidence)."""
        cls = type(obj)
        sub = self._guard_classes.get(cls)
        if sub is None:
            harness = self

            def checked_setattr(s, attr, value):
                g = harness._guards.get(id(s))
                if g is not None:
                    g_scope, mapping = g
                    lock_name = mapping.get(attr)
                    if lock_name is not None:
                        tname = threading.current_thread().name
                        with harness._meta:
                            harness.writers.setdefault(
                                (g_scope, attr), set()).add(tname)
                        lk = harness._locks.get(lock_name)
                        if lk is None or not lk.held_by_current_thread():
                            with harness._meta:
                                harness.violations.add(
                                    f"unguarded write: {g_scope}.{attr} "
                                    f"rebound on thread '{tname}' without "
                                    f"{lock_name} held")
                object.__setattr__(s, attr, value)

            sub = type(cls.__name__ + "·racecheck", (cls,),
                       {"__setattr__": checked_setattr})
            self._guard_classes[cls] = sub
        with self._meta:
            self._guards[id(obj)] = (scope, dict(attr_locks))
        object.__setattr__(obj, "__class__", sub)

    def guard_from_spec(self, obj, spec, lock: InstrumentedLock) -> None:
        """Apply a shared-state declaration (an object with ``where`` and
        ``attrs``, `analysis.concurrency.SharedStateSpec`) at runtime:
        all of the spec's attrs guarded by the given instrumented lock."""
        self.guard(obj, spec.where,
                   {attr: lock.name for attr in spec.attrs})


# ---------------------------------------------------------------------------
# Results + replay contract
# ---------------------------------------------------------------------------


@dataclass
class RaceCheckResult:
    scenario: str
    seed: int
    violations: list                   # sorted, deduplicated
    counters: dict = field(default_factory=dict)
    writers: dict = field(default_factory=dict)  # "scope.attr" -> [threads]

    def fingerprint(self) -> str:
        """Digest of everything the assertions look at — two runs with
        the same seed must produce the same fingerprint (no wall-clock
        values, no interleaving-dependent counts)."""
        h = hashlib.sha256()
        h.update(repr((self.scenario, self.seed)).encode())
        for v in self.violations:
            h.update(v.encode())
        for key in sorted(self.counters):
            h.update(repr((key, self.counters[key])).encode())
        for key in sorted(self.writers):
            h.update(repr((key, sorted(self.writers[key]))).encode())
        return h.hexdigest()

    def to_dict(self) -> dict:
        return {"scenario": self.scenario, "seed": self.seed,
                "violations": self.violations, "counters": self.counters,
                "writers": {k: sorted(v) for k, v in self.writers.items()},
                "fingerprint": self.fingerprint()}


class RaceCheckFailure(AssertionError):
    """Expectation failure carrying the exact replay recipe."""

    def __init__(self, scenario: str, seed: int, message: str,
                 scheme: str = "insecure-test"):
        self.scenario = scenario
        self.seed = seed
        super().__init__(
            f"{message}\n"
            f"  replay: {replay_command(scenario, seed, scheme)}")


def replay_command(scenario: str, seed: int,
                   scheme: str = "insecure-test") -> str:
    flag = "" if scheme == "insecure-test" else f" --tbls-scheme {scheme}"
    return (f"python -m charon_tpu_torch.testutil.racecheck "
            f"--scenario {scenario} --seed {seed}{flag}")


def _result(h: RaceHarness, scenario: str, seed: int,
            counters: dict) -> RaceCheckResult:
    return RaceCheckResult(
        scenario=scenario, seed=seed,
        violations=sorted(h.violations), counters=counters,
        writers={f"{scope}.{attr}": set(ts)
                 for (scope, attr), ts in h.writers.items()})


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------


#: the stress's signing key and rounds
STRESS_SK = b"racecheck".ljust(32, b"\0")
STRESS_ROUNDS = 6


def stress_inputs(seed: int) -> tuple[list[list[bytes]], list[bytes]]:
    """`dispatch_stress`'s seeded inputs: each round's messages (signed
    with `STRESS_SK`) and the device store's commit keys."""
    rng = random.Random(seed)
    rounds = [[bytes([rng.randrange(256) for _ in range(8)])
               for _ in range(rng.randrange(1, 24))]
              for _ in range(STRESS_ROUNDS)]
    commit_keys = [bytes([rng.randrange(256) for _ in range(8)])
                   for _ in range(64)]
    return rounds, commit_keys


@functools.lru_cache(maxsize=None)
def _signed(scheme: str, sk: bytes, msg: bytes) -> bytes:
    """`tbls.sign` under `scheme`, memoised: a replay from the same seed
    signs the same messages (pure Python BLS signing is ≈ 0.2 s a
    signature)."""
    from ..tbls import api as tbls

    return tbls.sign(sk, msg)


@contextlib.contextmanager
def _registered_cuda_backend():
    """A fresh `CUDABackend` on the current CUDA device, registered as the
    ``cuda`` tbls backend for the block (raises with no card); the
    previous registration comes back after it."""
    from ..tbls import api as tbls
    from ..tbls.backend_cuda import CUDABackend

    backend = CUDABackend()
    prev, prev_name = tbls._BACKENDS.get("cuda"), tbls._current_name
    tbls.register_backend("cuda", backend)
    tbls.set_backend("cuda")
    try:
        yield backend
    finally:
        if prev is None:
            tbls._BACKENDS.pop("cuda", None)
        else:
            tbls.register_backend("cuda", prev)
        tbls._current_name = prev_name


def _scenario_dispatch_stress(seed: int,
                              scheme: str = "insecure-test"
                              ) -> RaceCheckResult:
    """Concurrent scrape/prep/launch/prewarm/devcache-commit against ONE
    pipeline, with every pre-existing race fix instrumented.  Expected
    CLEAN: the production locks exist precisely so this traffic is
    safe.  Under ``bls`` the verifies, the prewarm and the device store
    run on the card, through a fresh `CUDABackend` whose two locks are
    instrumented as well: ``_cache_lock`` over its LRU counters and its
    resident stores, ``_totals_lock`` over the verify totals, which the
    driving thread resets every round."""
    import asyncio

    import numpy as np
    import torch

    from ..app.monitoring import Registry
    from ..app.tracing import Tracer
    from ..tbls import api as tbls
    from ..tbls.devcache import NLIMBS, DeviceRowCache
    from ..tbls.dispatch import DispatchPipeline

    h = RaceHarness()
    old_scheme = tbls.scheme_name()
    tbls.set_scheme(scheme)
    with contextlib.ExitStack() as stack:
        stack.callback(tbls.set_scheme, old_scheme)
        backend = (stack.enter_context(_registered_cuda_backend())
                   if scheme == "bls" else None)
        device = backend.device if backend is not None else "cpu"
        pipe = DispatchPipeline()
        stack.callback(pipe.shutdown)
        registry = Registry()
        tracer = Tracer(registry=registry, max_spans=64)
        cache = DeviceRowCache("racecheck", n_planes=2, capacity_rows=256,
                               device=device)

        h.instrument_attr_lock(pipe, "_lock", "DispatchPipeline._lock")
        h.instrument_attr_lock(registry, "_lock", "Registry._lock")
        h.instrument_attr_lock(tracer, "_lock", "Tracer._lock")
        h.instrument_attr_lock(cache, "_lock", "DeviceRowCache._lock")
        h.guard(pipe, "DispatchPipeline",
                {a: "DispatchPipeline._lock"
                 for a in ("queue_depth", "prep_busy_s", "device_busy_s",
                           "launches", "tiles", "verify_rows")})
        h.guard(tracer, "Tracer",
                {a: "Tracer._lock" for a in ("dropped", "sink_errors",
                                             "_seq")})
        h.guard(cache, "DeviceRowCache",
                {a: "DeviceRowCache._lock"
                 for a in ("hits", "misses", "inserts", "evictions",
                           "overflows", "_store", "_free")})
        if backend is not None:
            h.instrument_attr_lock(backend, "_cache_lock",
                                   "CUDABackend._cache_lock")
            h.instrument_attr_lock(backend, "_totals_lock",
                                   "CUDABackend._totals_lock")
            h.guard(backend, "CUDABackend", {
                **{a: "CUDABackend._cache_lock"
                   for a in ("hm_cache_hits", "hm_cache_misses",
                             "hm_cache_evictions", "pk_cache_hits",
                             "pk_cache_misses", "pk_cache_evictions",
                             "_pk_dev", "_hm_dev")},
                **{a: "CUDABackend._totals_lock"
                   for a in ("verify_totals", "verify_launch_totals")}})

        pk = tbls.privkey_to_pubkey(STRESS_SK)
        rounds_msgs, commit_keys = stress_inputs(seed)
        batches = [[(pk, m, _signed(scheme, STRESS_SK, m)) for m in msgs]
                   for msgs in rounds_msgs]

        errors: list = []

        # fixed per-thread iteration counts (not run-until-stopped): the
        # set of attributes each thread writes — part of the replay
        # fingerprint — must not depend on scheduling
        def scrape() -> None:
            try:
                for _ in range(150):
                    pipe.stage_stats()
                    pipe.overlap_efficiency()
                    registry.render()
                    cache.stats()
                    if backend is not None:
                        backend.devcache_stats()
            except Exception as exc:  # pragma: no cover - surfaced below
                errors.append(exc)

        def devcache_commit() -> None:
            try:
                local = random.Random(seed ^ 0x5EED)
                for _ in range(60):
                    keys = [commit_keys[local.randrange(len(commit_keys))]
                            for _ in range(4)]
                    rows = torch.zeros((2, NLIMBS, len(keys)),
                                       dtype=torch.int32, device=device)
                    cache.commit(keys, rows, np.ones(len(keys), bool))
                    cache.lookup_rows(keys)
            except Exception as exc:  # pragma: no cover - surfaced below
                errors.append(exc)

        async def drive() -> None:
            # prewarm rides its own short-lived thread inside the
            # pipeline; insecure-test makes it a cheap skip that still
            # exercises the thread handoff, bls a prewarm on the card
            total = 0
            for batch in batches:
                if backend is not None:
                    backend.reset_verify_totals()
                with tracer.start_span("racecheck/round"):
                    oks = await pipe.batch_verify(list(batch))
                total += sum(1 for ok in oks if ok)
                await pipe.prewarm([pk], num_validators=2, threshold=2)
                registry.inc("app_racecheck_rounds_total")
            drive.total = total  # type: ignore[attr-defined]

        threads = [threading.Thread(target=scrape, name="scrape",
                                    daemon=True),
                   threading.Thread(target=devcache_commit,
                                    name="devcache-commit", daemon=True)]
        for t in threads:
            t.start()
        asyncio.run(drive())
        for t in threads:
            t.join(timeout=60)
        if errors:
            raise errors[0]

        counters = {
            "rounds": len(batches),
            "entries": sum(len(b) for b in batches),
            "verified_ok": drive.total,
            "pipeline_launches_min": int(pipe.launches > 0),
            "pipeline_verify_rows": pipe.verify_rows,
        }
        return _result(h, "dispatch_stress", seed, counters)


class _Tally:
    """Toy shared-state class for the self-test fixtures."""

    def __init__(self):
        self.total = 0
        # lock-ok: fixture-local, instrumented by the harness itself
        self._lock = threading.Lock()


def _scenario_unguarded_mutation(seed: int,
                                 scheme: str = "insecure-test"
                                 ) -> RaceCheckResult:
    """The deliberately-removed-lock fixture: writer-a honours the
    declared lock, writer-b rebinds the guarded attr bare.  The report
    must name the exact attribute and the offending thread, and the
    writer set must show the ≥2-thread evidence.  No crypto: `scheme`
    does not apply."""
    h = RaceHarness()
    tally = _Tally()
    lock = h.instrument_attr_lock(tally, "_lock", "_Tally._lock")
    h.guard(tally, "_Tally", {"total": "_Tally._lock"})
    rng = random.Random(seed)
    n = rng.randrange(50, 100)

    def writer_a() -> None:
        for _ in range(n):
            with lock:
                tally.total += 1

    def writer_b() -> None:       # the planted bug: no lock
        for _ in range(n):
            tally.total += 1

    ta = threading.Thread(target=writer_a, name="writer-a")
    tb = threading.Thread(target=writer_b, name="writer-b")
    ta.start(); tb.start(); ta.join(); tb.join()
    return _result(h, "unguarded_mutation", seed, {"writes_per_thread": n})


def _scenario_lock_inversion(seed: int,
                             scheme: str = "insecure-test"
                             ) -> RaceCheckResult:
    """Two threads take the same two locks in opposite orders —
    sequenced (t1 completes before t2 starts) so the inversion is
    DETECTED deterministically without ever deadlocking.  No crypto:
    `scheme` does not apply."""
    h = RaceHarness()
    alpha = h.make_lock("alpha")
    beta = h.make_lock("beta")

    def forward() -> None:
        with alpha:
            with beta:
                pass

    def backward() -> None:
        with beta:
            with alpha:
                pass

    t1 = threading.Thread(target=forward, name="forward")
    t1.start(); t1.join()
    t2 = threading.Thread(target=backward, name="backward")
    t2.start(); t2.join()
    return _result(h, "lock_inversion", seed,
                   {"edges": len(h.order_edges)})


#: name -> (scenario fn, expected-finding substring or None for clean)
SCENARIOS: dict = {
    "dispatch_stress": (_scenario_dispatch_stress, None),
    "unguarded_mutation": (_scenario_unguarded_mutation,
                           "unguarded write: _Tally.total"),
    "lock_inversion": (_scenario_lock_inversion,
                       "cycle alpha -> beta -> alpha"),
}


def run_scenario(name: str, seed: int = 0,
                 scheme: str = "insecure-test") -> RaceCheckResult:
    """Run one scenario; raises `RaceCheckFailure` (with the replay
    recipe) when its expectation is violated.  ``scheme="bls"`` runs
    `dispatch_stress` on the card (a RuntimeError with no card)."""
    if scheme not in ("bls", "insecure-test"):
        raise ValueError(f"unknown tbls scheme {scheme!r}")
    fn, expected = SCENARIOS[name]
    res = fn(seed, scheme=scheme)
    if expected is None:
        if res.violations:
            raise RaceCheckFailure(
                name, seed, "expected a clean run, got:\n  "
                + "\n  ".join(res.violations), scheme=scheme)
    elif not any(expected in v for v in res.violations):
        raise RaceCheckFailure(
            name, seed,
            f"expected a violation containing {expected!r}, got: "
            f"{res.violations!r}", scheme=scheme)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="deterministic concurrency race harness")
    p.add_argument("--scenario", choices=sorted(SCENARIOS), required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tbls-scheme", default="insecure-test",
                   choices=["insecure-test", "bls"],
                   help="bls runs dispatch_stress's verifies, prewarm and "
                        "device store on the card")
    args = p.parse_args(argv)
    try:
        res = run_scenario(args.scenario, seed=args.seed,
                           scheme=args.tbls_scheme)
    except RaceCheckFailure as exc:
        print(f"FAIL {exc}")
        return 1
    except RuntimeError as exc:
        # bls with no card: name the device, fall back to nothing
        print(f"error: racecheck: {exc}", file=sys.stderr)
        return 1
    import json

    print(json.dumps(res.to_dict(), indent=2))
    print(f"fingerprint {res.fingerprint()}  (replay: "
          f"{replay_command(args.scenario, args.seed, args.tbls_scheme)})")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
