"""Time the verify flushes of one checkout of the repository on the card,
for comparing two commits in one call on one card.

    python3 tools/verify_ab.py ROOT [REPS]

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
of REPS reps).  Every verdict must be True.  Prints the card's name and
power limit, then one JSON line: the commit's root, and per flush kind
every rep's wall seconds and summed stage seconds.  Run parent, change,
change, parent in one call:

    for r in build/parent . . build/parent; do
        python3 tools/verify_ab.py $r; done
"""

from __future__ import annotations

import asyncio
import json
import sys
import time
from pathlib import Path


def main() -> int:
    root = Path(sys.argv[1]).resolve()
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from charon_tpu_torch.ops import build
    from charon_tpu_torch.tbls import api, dispatch

    if not torch.cuda.is_available():
        print("verify_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    build.library()
    backend = api._backend()
    entries, _, bits = cs.verify_pool(dev, backend)
    out = {"root": str(root), "pk_alone": [], "cold": [], "warm": [],
           "slot_start": [], "distinct": []}

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
    for _ in range(reps):
        backend._pk_cache.clear()
        flush(entries, "cold")
    for _ in range(reps):
        flush(entries, "warm")
    v, m = len(entries), cs.MESSAGES
    for rep in range(reps):
        news = [f"verify_ab: slot {200 + rep} committee {c}".encode()
                for c in range(m)]
        hms = backend._hash_points(news, {}, {})
        sigs = cs.sign_on_card(dev, bits, hms[..., [k % m for k in range(v)]])
        backend._hm_cache.clear()
        flush([(entries[k][0], news[k % m], sigs[k]) for k in range(v)],
              "slot_start")
    msgs = cs.distinct_messages(len(entries))
    hms = backend._hash_points(msgs, {}, {})
    sigs = cs.sign_on_card(dev, bits, hms)
    distinct = [(entries[k][0], msgs[k], sigs[k])
                for k in range(len(entries))]
    for _ in range(reps):
        backend._hm_cache.clear()
        flush(distinct, "distinct")
    pipe = dispatch.current_pipeline()
    if pipe is not None:
        pipe.shutdown()
    print(cs.smi("name,power.limit"), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
