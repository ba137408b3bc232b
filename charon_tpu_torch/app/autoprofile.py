"""SLO-triggered auto-profiling — capture the evidence WHILE the node
is slow, not after the operator notices.

The slot-budget watchdog (`core/slotbudget.py`, late-duty blame) and the
loop-lag p99 breach (`monitoring.loop_lag_probe`) tell an operator THAT
the hot path regressed; by the time someone runs `/debug/profile` by
hand the stall is usually over.  This module closes that gap: when an
SLO trips, a bounded, rate-limited `torch.profiler` device trace is
captured automatically into an on-disk ring of recent captures, each
stamped with the triggering duty's deterministic trace ID — so a page
links straight from "duty late, phase=sigagg" to the device timeline of
the offending slot.

A copy of the JAX package's app/autoprofile.py with the same knobs; the
capture is the port's `torch.profiler` trace (`monitoring.
run_profile_capture`, the one `/debug/profile` serves) where the JAX one
takes a `jax.profiler` trace.

Safety properties (pinned by tests/test_torch_autoprofile.py):

- the process-global profiler guard (`monitoring.profile_guard_*`) is
  respected: an in-flight manual `/debug/profile` (or another trigger)
  skips the capture — profiler state is process-wide;
- rate-limited: at most one capture per `min_interval` seconds (a
  breach storm pages once with a trace, not a disk full of tarballs);
- the on-disk ring keeps the newest `ring` captures and prunes the
  rest, so long-running nodes are bounded;
- capture failures are counted, never raised into the watchdog/probe;
- a capture runs on a worker thread (`monitoring.run_profile_capture`),
  and the App pays the profiler's set-up once at boot (`prewarm`), so a
  trigger on a late loop neither holds that loop nor waits seconds for
  its trace to start.

Env knobs (read by :func:`from_env`):

- ``CHARON_TPU_AUTOPROFILE``          ``1`` force-on, ``0`` force-off,
  ``auto`` (default) = on for the production App, off for test-harness
  simnet Nodes (which pass ``default_on=False`` so tier-1 stays
  deterministic).
- ``CHARON_TPU_AUTOPROFILE_DIR``      capture ring directory
  (``{node}`` expands to the node name; default under the system
  temp dir).
- ``CHARON_TPU_AUTOPROFILE_RING``     captures kept (default 4).
- ``CHARON_TPU_AUTOPROFILE_INTERVAL`` min seconds between captures
  (default 600).
- ``CHARON_TPU_AUTOPROFILE_SECONDS``  trace duration (default 1.0,
  capped at monitoring.PROFILE_MAX_SECONDS).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import shutil
import tempfile
import time

from . import monitoring

log = logging.getLogger(__name__)

#: Capture directory names: cap<seq>-<reason>; ring pruning sorts on
#: the zero-padded sequence number.
_CAP_PREFIX = "cap"


def _write_capture_meta(cap_dir: str, meta: dict) -> None:
    """Sync mkdir + meta.json write, run via asyncio.to_thread from
    `trigger` (file I/O must not ride the already-SLO-breached loop)."""
    os.makedirs(cap_dir, exist_ok=True)
    with open(os.path.join(cap_dir, "meta.json"), "w") as fh:
        json.dump(meta, fh)


def enabled(default_on: bool = True) -> bool:
    """CHARON_TPU_AUTOPROFILE: 1 force-on, 0 force-off, auto = caller's
    default (App: on; test simnet Node: off)."""
    val = os.environ.get("CHARON_TPU_AUTOPROFILE", "auto")
    if val == "1":
        return True
    if val == "0":
        return False
    return default_on


def from_env(registry=None, node_name: str = "node",
             default_on: bool = True) -> "AutoProfiler | None":
    """Build an AutoProfiler from the env knobs, or None when disabled."""
    if not enabled(default_on):
        return None
    out_dir = os.environ.get(
        "CHARON_TPU_AUTOPROFILE_DIR",
        os.path.join(tempfile.gettempdir(), "charon-tpu-autoprofile-{node}"))
    out_dir = out_dir.replace("{node}", node_name)

    def _num(key: str, default: float) -> float:
        try:
            return float(os.environ.get(key, default))
        except ValueError:
            return default

    return AutoProfiler(
        out_dir,
        registry=registry,
        ring=max(1, int(_num("CHARON_TPU_AUTOPROFILE_RING", 4))),
        min_interval=_num("CHARON_TPU_AUTOPROFILE_INTERVAL", 600.0),
        seconds=_num("CHARON_TPU_AUTOPROFILE_SECONDS", 1.0))


class AutoProfiler:
    """Bounded ring of SLO-triggered torch.profiler captures.

    `clock` (monotonic seconds) and `capture_fn` are injectable so the
    rate-limit and ring behaviour are testable against a fake clock
    without real profiler time; the default capture is the same
    torch.profiler trace `/debug/profile` serves, written to disk instead
    of streamed."""

    def __init__(self, out_dir: str, registry=None, ring: int = 4,
                 min_interval: float = 600.0, seconds: float = 1.0,
                 clock=time.monotonic, capture_fn=None):
        self.out_dir = out_dir
        self.ring = max(1, int(ring))
        self.min_interval = float(min_interval)
        self.seconds = min(max(float(seconds), 0.0),
                           monitoring.PROFILE_MAX_SECONDS)
        self._registry = registry
        self._clock = clock
        self._capture_fn = capture_fn
        self._last: float | None = None
        self._seq = 0
        # capture/skip outcome counters (also exported when a registry
        # is wired); reasons are bounded literals at the call sites
        self.captures = 0
        self.skipped_rate_limited = 0
        self.skipped_guard_busy = 0
        self.capture_errors = 0
        #: strong refs to in-flight trigger tasks: asyncio loops hold
        #: only weak refs, so a fire-and-forget capture task could be
        #: garbage-collected MID-CAPTURE without this
        self._tasks: set = set()

    # -- trigger -------------------------------------------------------------

    async def trigger(self, reason: str, trace_id: str = "",
                      detail: str = "") -> str | None:
        """One SLO breach: capture into the ring unless rate-limited or
        the process profiler is busy.  Returns the capture directory, or
        None when skipped.  Never raises."""
        now = self._clock()
        if self._last is not None and now - self._last < self.min_interval:
            self.skipped_rate_limited += 1
            if self._registry is not None:
                self._registry.inc("app_autoprofile_skipped_total",
                                   labels={"reason": "rate_limited"})
            return None
        if not monitoring.profile_guard_acquire():
            self.skipped_guard_busy += 1
            if self._registry is not None:
                self._registry.inc("app_autoprofile_skipped_total",
                                   labels={"reason": "guard_busy"})
            return None
        # stamp the limiter BEFORE the capture: concurrent triggers
        # during the capture window must rate-limit, not queue
        self._last = now
        self._seq += 1
        cap_dir = os.path.join(
            self.out_dir, f"{_CAP_PREFIX}{self._seq:04d}-{reason}")
        try:
            meta = {"reason": reason, "trace_id": trace_id,
                    "detail": detail, "seconds": self.seconds,
                    "unix_time": time.time()}
            # mkdir + meta write off-loop: the trigger fires exactly when
            # the loop is already missing its SLO, so even a one-syscall
            # stall on a slow/networked profile dir is the wrong place
            # to spend loop time
            await asyncio.to_thread(_write_capture_meta, cap_dir, meta)
            if self._capture_fn is not None:
                self._capture_fn(cap_dir)
            else:
                # the seconds the profiler's start, stop and export took
                # join the stamp
                timings = await self._profiler_capture(cap_dir)
                await asyncio.to_thread(_write_capture_meta, cap_dir,
                                        {**meta, "timings": timings})
        except Exception:  # noqa: BLE001 — a watchdog must never crash
            self.capture_errors += 1
            log.exception("auto-profile capture failed (%s)", reason)
            await asyncio.to_thread(shutil.rmtree, cap_dir,
                                    ignore_errors=True)
            return None
        finally:
            monitoring.profile_guard_release()
        self.captures += 1
        if self._registry is not None:
            self._registry.inc("app_autoprofile_captures_total",
                               labels={"reason": reason})
        log.warning("auto-profile captured %s (reason=%s trace=%s %s)",
                    cap_dir, reason, trace_id, detail)
        self._prune()
        return cap_dir

    def make_hook(self, reason: str, trace_id_fn=None):
        """A SYNC callback for watchdog/probe subscription points: wraps
        `trigger` in a fire-and-forget task on the running loop (the
        watchdog must not await a multi-second capture)."""

        def hook(*args) -> None:
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                return  # no loop (unit-test finalize): nothing to profile
            trace_id, detail = "", ""
            if trace_id_fn is not None and args:
                try:
                    trace_id = trace_id_fn(args[0])
                except Exception:  # noqa: BLE001
                    trace_id = ""
            if len(args) > 1:
                detail = str(args[1])
            task = loop.create_task(self.trigger(reason, trace_id=trace_id,
                                                 detail=detail))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)

        return hook

    async def prewarm(self) -> float | None:
        """One throwaway capture, off the loop, at boot: a process's
        first `torch.profiler` start pays the profiler's set-up (CUPTI's
        on a card: 13–19 s on an H100, the next start a few ms;
        `tools/profile_stall_probe.py`), which would
        otherwise hold the first SLO-triggered capture back until its
        slot is over.  → its seconds, or None when skipped (a stub
        capture, or another capture holds the guard) or failed; never
        raises."""
        if self._capture_fn is not None:
            return None
        if not monitoring.profile_guard_acquire():
            return None
        t0 = time.perf_counter()
        tmp = None
        try:
            tmp = await asyncio.to_thread(
                tempfile.mkdtemp, prefix="charon-tpu-profile-")
            await asyncio.to_thread(monitoring.profile_capture_sync, tmp,
                                    0.0)
        except Exception:  # noqa: BLE001 — a boot step must not crash
            self.capture_errors += 1
            log.exception("profiler prewarm failed")
            return None
        finally:
            monitoring.profile_guard_release()
            if tmp is not None:
                await asyncio.to_thread(shutil.rmtree, tmp,
                                        ignore_errors=True)
        return time.perf_counter() - t0

    # -- internals -----------------------------------------------------------

    async def _profiler_capture(self, cap_dir: str) -> dict:
        # the ONE shared capture protocol (/debug/profile uses the same
        # helper, so the two surfaces cannot drift)
        return await monitoring.run_profile_capture(cap_dir, self.seconds)

    def _prune(self) -> None:
        """Keep the newest `ring` captures (sequence-ordered names)."""
        try:
            caps = sorted(d for d in os.listdir(self.out_dir)
                          if d.startswith(_CAP_PREFIX))
        except OSError:
            return
        for stale in caps[:-self.ring]:
            shutil.rmtree(os.path.join(self.out_dir, stale),
                          ignore_errors=True)

    def stats(self) -> dict:
        return {"captures": self.captures,
                "skipped_rate_limited": self.skipped_rate_limited,
                "skipped_guard_busy": self.skipped_guard_busy,
                "capture_errors": self.capture_errors,
                "out_dir": self.out_dir, "ring": self.ring,
                "min_interval_s": self.min_interval}
