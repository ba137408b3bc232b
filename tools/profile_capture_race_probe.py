"""Whether a `torch.profiler` session on one thread breaks the verify
graphs that another thread captures or replays.

Each variant runs in a fresh process on the card.  A verify thread loops
over the resident route's buckets (1 … 64 entries), on every other pass
dropping each bucket's graph first so that the tile captures anew (what a
node does the first time a bucket is used, in its first slots) and on the
others replaying it, and checks every verdict:
all entries are valid but one, tampered, in each tile of 2 or more.
Beside it, in the ``profiled`` variant, a profiler thread runs
`monitoring.profile_capture_sync` (what `/debug/profile` and the
auto-profiler run) one short session after another; the ``none`` variant
has the verify thread alone.

Needs a CUDA card:

    python3 tools/profile_capture_race_probe.py [--seconds 30]

Prints one line per variant, the card's name and power limit, and a JSON
line of every number.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VARIANTS = ("none", "profiled")
BUCKETS = (1, 2, 4, 8, 16, 32, 64)
PROFILE_S = 0.25


def _entries(n_keys: int = 8):
    """n_keys (pubkey, message, signature) triples of the pure-Python
    signer, and one tampered signature."""
    from charon_tpu_torch.tbls import api

    out = []
    for k in range(n_keys):
        sk = api.generate_privkey()
        msg = b"capture-race-probe-%d" % k
        out.append((api.privkey_to_pubkey(sk), msg, api.sign(sk, msg)))
    bad = (out[0][0], out[0][1], out[1][2])
    return out, bad


def _child(variant: str, seconds: float) -> dict:
    import torch

    from charon_tpu_torch.app import monitoring
    from charon_tpu_torch.ops import build
    from charon_tpu_torch.tbls import backend_cuda

    t0 = time.perf_counter()
    build.library()
    be = backend_cuda.CUDABackend(device=torch.device("cuda"))
    good, bad = _entries()
    be.batch_verify_bytes(good[:1])          # the stores' first use
    out: dict = {"variant": variant, "seconds": seconds,
                 "setup_s": time.perf_counter() - t0,
                 "tiles": 0, "captured": 0, "wrong": 0,
                 "verify_errors": 0, "sessions": 0, "profile_errors": 0,
                 "first_errors": []}
    stop = threading.Event()
    lock = threading.Lock()

    def note(key: str, exc: BaseException) -> None:
        with lock:
            out[key] += 1
            if len(out["first_errors"]) < 4:
                out["first_errors"].append(
                    f"{key}: " + "".join(traceback.format_exception_only(
                        type(exc), exc)).strip()[:400])

    def verifier() -> None:
        k, fresh = 0, True
        while not stop.is_set():
            for v in BUCKETS:
                if fresh:
                    with backend_cuda._GRAPHS_LOCK:
                        backend_cuda._GRAPHS.pop((str(be.device), v), None)
                tile = [good[(k + i) % len(good)] for i in range(v)]
                want = [True] * v
                if v > 1:
                    tile[v // 2] = bad
                    want[v // 2] = False
                k += 1
                try:
                    got = be.batch_verify_bytes(tile)
                    with lock:
                        out["tiles"] += 1
                        out["captured"] += fresh
                        out["wrong"] += got != want
                except Exception as exc:   # noqa: BLE001 — counted
                    note("verify_errors", exc)
            fresh = not fresh

    def profiler() -> None:
        while not stop.is_set():
            with tempfile.TemporaryDirectory() as d:
                try:
                    monitoring.profile_capture_sync(d, PROFILE_S)
                    with lock:
                        out["sessions"] += 1
                except Exception as exc:   # noqa: BLE001 — counted
                    note("profile_errors", exc)

    threads = [threading.Thread(target=verifier, daemon=True)]
    if variant != "none":
        threads.append(threading.Thread(target=profiler, daemon=True))
    for t in threads:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in threads:
        t.join(timeout=120)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--child", choices=VARIANTS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(_child(args.child, args.seconds)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("profile_capture_race_probe: needs a CUDA card",
              file=sys.stderr)
        return 1
    results = []
    for variant in VARIANTS:
        proc = subprocess.run(
            [sys.executable, __file__, "--child", variant,
             "--seconds", str(args.seconds)],
            capture_output=True, text=True, timeout=900, cwd=str(ROOT))
        if proc.returncode != 0:
            res = {"variant": variant, "exit_code": proc.returncode,
                   "stderr": proc.stderr[-3000:]}
        else:
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
