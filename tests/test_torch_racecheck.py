"""Deterministic race-harness tests of the port
(charon_tpu_torch/testutil/racecheck).

The seven cases of the JAX package's tests/test_racecheck.py on the port's
modules, replay strings included:

- `dispatch_stress` drives concurrent scrape / batch-verify / prewarm /
  device-store-commit threads against a real DispatchPipeline,
  Registry, Tracer and DeviceRowCache with every pre-existing race fix
  instrumented, and must come back clean AND bit-identically
  reproducible from the printed seed.
- `unguarded_mutation` (a toy with its lock removed on one writer) must
  name the exact attribute and the offending thread, with both writer
  threads recorded.
- `lock_inversion` must name the cycle in canonical order.

Plus: the stress run's work counters equal the JAX harness's for the same
seed, and ``--tbls-scheme bls`` on a machine without a card exits 1
naming the device.  Everything here is CPU-only (insecure-test scheme).
"""

import os
import subprocess
import sys
import threading

import pytest
import torch

from charon_tpu.testutil import racecheck as jracecheck
from charon_tpu_torch.app.monitoring import Registry
from charon_tpu_torch.app.tracing import Tracer
from charon_tpu_torch.testutil.racecheck import (RaceCheckFailure, SCENARIOS,
                                                 run_scenario)


def test_dispatch_stress_clean():
    """The production locks exist precisely so this traffic is safe:
    instrumented stress over the real dispatch/serving objects reports
    zero violations and actually did the work."""
    res = run_scenario("dispatch_stress", seed=5)
    assert res.violations == []
    assert res.counters["rounds"] > 0
    assert res.counters["verified_ok"] == res.counters["entries"]
    assert res.counters["pipeline_launches_min"] >= 1
    # the scrape + devcache threads really ran against guarded state
    writers = set(res.writers)
    assert any(k.startswith("DispatchPipeline.") for k in writers)
    assert any(k.startswith("DeviceRowCache.") for k in writers)


def test_dispatch_stress_deterministic_replay():
    """Two runs from the same seed produce bit-identical fingerprints —
    the replay contract every failure message relies on."""
    a = run_scenario("dispatch_stress", seed=5)
    b = run_scenario("dispatch_stress", seed=5)
    assert a.fingerprint() == b.fingerprint()
    # and the fingerprint is seed-sensitive, not a constant
    c = run_scenario("dispatch_stress", seed=6)
    assert c.fingerprint() != a.fingerprint()


def test_dispatch_stress_counters_equal_jax():
    """The same seed draws the same batches in both packages: the stress
    run's work counters are the JAX harness's."""
    port = run_scenario("dispatch_stress", seed=5)
    jax = jracecheck.run_scenario("dispatch_stress", seed=5)
    assert port.counters == jax.counters
    assert port.violations == jax.violations == []


def test_unguarded_mutation_names_attr_and_threads():
    """Removing a lock from one writer is detected with the exact
    attribute and thread pair — the self-test the harness's guard()
    machinery is pinned by."""
    res = run_scenario("unguarded_mutation", seed=3)
    [violation] = res.violations
    assert "unguarded write: _Tally.total" in violation
    assert "thread 'writer-b'" in violation
    assert "without _Tally._lock held" in violation
    assert sorted(res.writers["_Tally.total"]) == ["writer-a", "writer-b"]


def test_lock_inversion_names_cycle():
    res = run_scenario("lock_inversion", seed=3)
    [violation] = res.violations
    assert "cycle alpha -> beta -> alpha" in violation
    assert "'backward'" in violation and "'forward'" in violation


def test_failure_embeds_replay_command():
    """A scenario whose expectation is violated raises RaceCheckFailure
    carrying the exact CLI replay recipe."""
    fn, _ = SCENARIOS["unguarded_mutation"]
    # the toy scenario run through a CLEAN expectation must fail
    SCENARIOS["_selftest"] = (fn, None)
    try:
        with pytest.raises(RaceCheckFailure) as exc:
            run_scenario("_selftest", seed=7)
    finally:
        del SCENARIOS["_selftest"]
    msg = str(exc.value)
    assert "unguarded write: _Tally.total" in msg
    assert ("replay: python -m charon_tpu_torch.testutil.racecheck "
            "--scenario _selftest --seed 7") in msg


def test_cli_clean_scenario_exits_zero():
    proc = subprocess.run(
        [sys.executable, "-m", "charon_tpu_torch.testutil.racecheck",
         "--scenario", "unguarded_mutation", "--seed", "1"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "fingerprint" in proc.stdout
    assert "python -m charon_tpu_torch.testutil.racecheck" in proc.stdout


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a machine with a card runs the bls stress")
def test_cli_bls_without_a_card_exits_one_naming_the_device():
    proc = subprocess.run(
        [sys.executable, "-m", "charon_tpu_torch.testutil.racecheck",
         "--scenario", "dispatch_stress", "--seed", "5",
         "--tbls-scheme", "bls"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "no CUDA device" in proc.stderr
    assert "fingerprint" not in proc.stdout


def test_tracer_concurrent_spans_regression():
    """The Tracer's _seq/spans/dropped sit under Tracer._lock: hammer
    start_span + _note_sink_error from threads and assert no span id was
    double-allocated and the drop accounting balances."""
    tracer = Tracer(registry=Registry(), max_spans=32)
    n_threads, n_spans = 4, 200
    ids = [[] for _ in range(n_threads)]

    def worker(idx):
        for _ in range(n_spans):
            with tracer.start_span(f"racecheck/t{idx}") as span:
                ids[idx].append(span.span_id)
            tracer._note_sink_error()

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    flat = [i for sub in ids for i in sub]
    assert len(flat) == len(set(flat)), "trace ids double-allocated"
    assert tracer.sink_errors == n_threads * n_spans
    # ring accounting: everything not retained was counted as dropped
    assert tracer.dropped + len(tracer.spans) == n_threads * n_spans
