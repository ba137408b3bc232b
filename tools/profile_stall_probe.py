"""How long a `torch.profiler` capture holds a node's event loop, and
which part of the capture is slow.

Each variant runs in a fresh process (a process's first capture is the
one that pays the profiler's set-up) with a thread that keeps the card
busy, the way a node's dispatch pipeline does, and an event loop whose
probe wakes every 5 ms and records how late it woke:

- ``loop``   start and stop on the loop's own thread (the protocol the
  port had before `monitoring.run_profile_capture` moved off the loop);
- ``thread`` `monitoring.run_profile_capture` twice: the first and the
  second capture of the process;
- ``warm``   a throwaway capture of 0 s on a worker thread first (as
  the App does at boot, `AutoProfiler.prewarm`), then one
  `run_profile_capture`.

Needs a CUDA card:

    python3 tools/profile_stall_probe.py [--seconds 1.0]

Prints one line per variant, the card's name and power limit, and a JSON
line of every number.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VARIANTS = ("loop", "thread", "warm")


def _busy_card(stop: threading.Event, launches: list) -> None:
    """Matrix products on the card until `stop`: kernels launched from a
    thread that is not the capture's."""
    import torch

    a = torch.randn(2048, 2048, device="cuda")
    while not stop.is_set():
        for _ in range(8):
            a = (a @ a).tanh_()
        torch.cuda.synchronize()
        launches[0] += 16


def _kernel_events(path: str) -> int:
    with open(path) as fh:
        doc = json.load(fh)
    events = doc.get("traceEvents", doc) if isinstance(doc, dict) else doc
    return sum(1 for e in events if e.get("cat") == "kernel")


async def _capture_on_loop(out_dir: str, seconds: float) -> dict:
    """The earlier protocol: start and stop on the loop's thread."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from charon_tpu_torch.app import monitoring

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    t0 = time.perf_counter()
    prof.start()
    t1 = time.perf_counter()
    try:
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            await asyncio.sleep(min(0.1, max(deadline - time.monotonic(), 0)))
        token = torch.arange(128, dtype=torch.int32, device="cuda") + 1
        torch.cuda.synchronize(token.device)
    finally:
        t2 = time.perf_counter()
        prof.stop()
    t3 = time.perf_counter()
    n = await asyncio.to_thread(
        monitoring._export_trace, prof,
        os.path.join(out_dir, monitoring.PROFILE_TRACE_FILE))
    return {"start_s": t1 - t0, "stop_s": t3 - t2,
            "export_s": time.perf_counter() - t3, "events": n}


async def _child(variant: str, seconds: float) -> dict:
    import torch

    from charon_tpu_torch.app import monitoring

    torch.zeros(1, device="cuda")
    stop, launches = threading.Event(), [0]
    worker = threading.Thread(target=_busy_card, args=(stop, launches),
                              daemon=True)
    worker.start()
    loop = asyncio.get_running_loop()
    lags: list = []

    async def probe():
        while True:
            t0 = loop.time()
            await asyncio.sleep(0.005)
            lags.append((t0, max(0.0, loop.time() - t0 - 0.005)))

    probe_task = asyncio.create_task(probe())
    await asyncio.sleep(1.0)
    out: dict = {"variant": variant, "seconds": seconds, "captures": []}
    if variant == "warm":
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            timings = await asyncio.to_thread(
                monitoring.profile_capture_sync, d, 0.0)
            out["prewarm"] = {**timings, "wall_s": time.perf_counter() - t0}
        await asyncio.sleep(1.0)
    runs = 2 if variant == "thread" else 1
    for _ in range(runs):
        with tempfile.TemporaryDirectory() as d:
            t0, mark = time.perf_counter(), loop.time()
            if variant == "loop":
                timings = await _capture_on_loop(d, seconds)
            else:
                timings = await monitoring.run_profile_capture(d, seconds)
            wall = time.perf_counter() - t0
            during = [lag for at, lag in lags if at >= mark - 0.01]
            out["captures"].append({
                **timings, "wall_s": wall,
                "kernel_events": _kernel_events(
                    os.path.join(d, monitoring.PROFILE_TRACE_FILE)),
                "loop_max_lag_s": max(during, default=0.0),
                "loop_lags_over_0.1s": sum(1 for x in during if x > 0.1)})
        await asyncio.sleep(1.0)
    probe_task.cancel()
    stop.set()
    worker.join()
    out["busy_launches"] = launches[0]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--child", choices=VARIANTS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(asyncio.run(_child(args.child, args.seconds))))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("profile_stall_probe: needs a CUDA card", file=sys.stderr)
        return 1
    results = []
    for variant in VARIANTS:
        proc = subprocess.run(
            [sys.executable, __file__, "--child", variant,
             "--seconds", str(args.seconds)],
            capture_output=True, text=True, timeout=600, cwd=str(ROOT))
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append(res)
        print(f"{variant}: " + json.dumps(
            {k: v for k, v in res.items() if k != "variant"}))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card)
    print(json.dumps({"card": card, "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
