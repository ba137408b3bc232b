"""Time the verify flushes of one checkout of the repository on the card,
for comparing two commits in one call on one card.

    python3 tools/verify_ab.py ROOT [REPS] [--route bytes|resident]

ROOT is a checkout (this one, or an unpacked `git archive` of another
commit); its `chip_smoke.py` and `charon_tpu_torch` are imported and its
kernels built into ROOT/build/.  The run builds the 10,000-entry verify
pool of `chip_smoke.verify_pool` (64 messages), times the G1 decompress
of its 10,000 keys alone on the idle card (a fresh backend's pubkey LRU,
REPS times: `pk_alone`), then REPS cold flushes (the pubkey LRU emptied
before each: the first flush after a node starts), REPS (default 5)
warm flushes and REPS slot-start flushes (the warm flush's keys over 64
messages new each rep, signed on the card, so its first tile hashes them
on the card as one batch, as `chip_smoke.verify_slot_start_phase`
does); then the 10,000-distinct-message flush of
`chip_smoke.verify_distinct_phase` (the message LRU cleared before each
of REPS reps).  Every verdict must be True.  `--route` (default bytes)
picks the backend's verify route: on ``resident`` the stores stand in for
the LRUs ("emptied" empties a store) and REPS more cold flushes each follow
a `prewarm` of the 10,000 keys with the pool's 64 messages in the store
(`cold_after_prewarm`); a checkout from before the resident route has the
bytes route only.  Prints the card's name and power limit, then one JSON
line: the commit's root and route, and per flush kind every rep's wall
seconds and summed stage seconds.  Run parent, change, change, parent in
one call:

    for r in build/parent . . build/parent; do
        python3 tools/verify_ab.py $r; done
"""

from __future__ import annotations

import asyncio
import json
import sys
import time
from pathlib import Path


def make_backend(route: str):
    """The route's backend, registered as the API's "cuda" one."""
    from charon_tpu_torch.tbls import api
    from charon_tpu_torch.tbls.backend_cuda import CUDABackend

    if route == "resident":
        backend = CUDABackend(resident=True)
    else:
        try:
            backend = CUDABackend(resident=False)
        except TypeError:           # a checkout from before the route
            backend = CUDABackend()
    api.register_backend("cuda", backend)
    return backend


def main() -> int:
    args = sys.argv[1:]
    route = "bytes"
    if "--route" in args:
        at = args.index("--route")
        route = args[at + 1]
        del args[at:at + 2]
    if route not in ("bytes", "resident"):
        print(f"verify_ab: unknown route {route!r}", file=sys.stderr)
        return 2
    root = Path(args[0]).resolve()
    reps = int(args[1]) if len(args) > 1 else 5
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from charon_tpu_torch.ops import build
    from charon_tpu_torch.tbls import dispatch

    if not torch.cuda.is_available():
        print("verify_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    build.library()
    backend = make_backend(route)
    resident = route == "resident"
    entries, _, bits = cs.verify_pool(dev, backend)
    out = {"root": str(root), "route": route, "pk_alone": [], "cold": [],
           "warm": [], "slot_start": [], "distinct": []}

    def clear(store: str) -> None:
        if resident:
            backend._dev_caches()[store == "hm"].clear()
        else:
            (backend._hm_cache if store == "hm" else
             backend._pk_cache).clear()

    def flush(batch, kind):
        backend.reset_verify_totals()
        t0 = time.perf_counter()
        oks, _, _ = asyncio.run(cs.verify_round(batch))
        wall = time.perf_counter() - t0
        if not all(oks):
            raise AssertionError(f"{kind}: {oks.count(False)} rejected")
        out[kind].append({"wall_s": wall, **backend.verify_totals})

    keys = [pk for pk, _, _ in entries]
    for _ in range(reps):
        stages = {}
        type(backend)()._pk_planes_cached(keys, stages, {})
        out["pk_alone"].append(stages["pk_decompress_s"])
    if resident:
        # the flush's 64 messages into the store, as the bytes route's
        # cold flush finds them in its LRU
        with backend._prep_context():
            backend._hm_rows_resident([m for _, m, _ in entries[:cs.MESSAGES]],
                                      {}, {})
    for _ in range(reps):
        clear("pk")
        flush(entries, "cold")
    if resident:
        out["cold_after_prewarm"], out["prewarm"] = [], []
        for _ in range(reps):
            clear("pk")
            out["prewarm"].append(backend.prewarm(keys, len(keys), 7))
            flush(entries, "cold_after_prewarm")
    for _ in range(reps):
        flush(entries, "warm")
    v, m = len(entries), cs.MESSAGES
    for rep in range(reps):
        news = [f"verify_ab: slot {200 + rep} committee {c}".encode()
                for c in range(m)]
        hms = backend._hash_points(news, {}, {})
        sigs = cs.sign_on_card(dev, bits, hms[..., [k % m for k in range(v)]])
        backend._hm_cache.clear()           # the signing's hashes
        flush([(entries[k][0], news[k % m], sigs[k]) for k in range(v)],
              "slot_start")
    msgs = cs.distinct_messages(len(entries))
    hms = backend._hash_points(msgs, {}, {})
    sigs = cs.sign_on_card(dev, bits, hms)
    distinct = [(entries[k][0], msgs[k], sigs[k])
                for k in range(len(entries))]
    for _ in range(reps):
        clear("hm")
        flush(distinct, "distinct")
    pipe = dispatch.current_pipeline()
    if pipe is not None:
        pipe.shutdown()
    print(cs.smi("name,power.limit"), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
